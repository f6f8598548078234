"""Saved-world loading, the goal check and the straight-line waypoint
(copies of armour_tpu/worlds.py:19-63,172-217).

CSV scene format: row 1 start, row 2 goal, row 3 NaN separator, rows 4+
obstacle centre xyz + side lengths; generators = diag(side / 2).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class World:
    """goal_type: 'configuration' (default) checks the wrapped config-space
    norm against goal_radius; 'end_effector_location' checks the workspace
    distance of the end effector to goal_in_workspace (`goal` stays a
    configuration whose end effector realises it, for guidance)."""

    start: np.ndarray                # [F]
    goal: np.ndarray                 # [F]
    obstacle_centers: np.ndarray     # [n, 3]
    obstacle_generators: np.ndarray  # [n, 3, 3]
    goal_type: str = "configuration"
    goal_in_workspace: np.ndarray = None   # [3], end-effector mode only
    goal_radius: float = None              # defaults per goal_type

    @property
    def num_obstacles(self) -> int:
        return self.obstacle_centers.shape[0]


def load_world_csv(path: str) -> World:
    """Parse the saved-world CSV format."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append([float(x) if x.lower() != "nan" else np.nan
                             for x in line.split(",")])
    start = np.asarray(rows[0][:7])
    goal = np.asarray(rows[1][:7])
    centers, gens = [], []
    for r in rows[3:]:
        c = np.asarray(r[:3])
        side = np.asarray(r[3:6])
        if np.any(np.isnan(c)) or np.any(np.isnan(side)):
            continue
        centers.append(c)
        gens.append(np.diag(side / 2.0))
    return World(
        start=start,
        goal=goal,
        obstacle_centers=np.asarray(centers).reshape(-1, 3),
        obstacle_generators=np.asarray(gens).reshape(-1, 3, 3),
    )


def goal_check(q: np.ndarray, goal: np.ndarray, goal_radius: float = np.pi / 30) -> bool:
    """Configuration-space goal test (wrapped difference norm)."""
    d = np.mod(q - goal + np.pi, 2 * np.pi) - np.pi
    return bool(np.linalg.norm(d) <= goal_radius)


def world_goal_check(world: World, q: np.ndarray, robot=None) -> bool:
    """Dispatch on world.goal_type: 'configuration' -> wrapped config norm
    (default radius pi/30); 'end_effector_location' -> workspace distance of
    the end effector to world.goal_in_workspace (default radius 0.05 m)."""
    if world.goal_type == "configuration":
        r = world.goal_radius if world.goal_radius is not None else np.pi / 30
        return goal_check(q, world.goal, r)
    if world.goal_type == "end_effector_location":
        from .hlp import ee_position

        if robot is None:
            raise ValueError("the end-effector goal mode needs the robot model")
        target = (world.goal_in_workspace if world.goal_in_workspace is not None
                  else ee_position(robot, np.asarray(world.goal, float)))
        r = world.goal_radius if world.goal_radius is not None else 0.05
        d = np.linalg.norm(ee_position(robot, np.asarray(q, float)) - target)
        return bool(d <= r)
    raise ValueError(f"goal type {world.goal_type} is not supported")


def straight_line_waypoint(q: np.ndarray, goal: np.ndarray, lookahead: float = 0.3,
                           continuous=None) -> np.ndarray:
    """Straight-line HLP: step `lookahead` toward the goal.  Only continuous
    joints take the wrapped angular difference; continuous=None wraps every
    joint."""
    d = goal - q
    wrapped = np.mod(d + np.pi, 2 * np.pi) - np.pi
    if continuous is None:
        d = wrapped
    else:
        d = np.where(np.asarray(continuous, bool), wrapped, d)
    dist = np.linalg.norm(d)
    if dist <= lookahead:
        return q + d
    return q + d * (lookahead / dist)

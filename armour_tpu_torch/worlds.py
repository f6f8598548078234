"""Saved-world loading and the straight-line waypoint (copies of
armour_tpu/worlds.py:19-63,199-217).

CSV scene format: row 1 start, row 2 goal, row 3 NaN separator, rows 4+
obstacle centre xyz + side lengths; generators = diag(side / 2).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class World:
    start: np.ndarray                # [F]
    goal: np.ndarray                 # [F]
    obstacle_centers: np.ndarray     # [n, 3]
    obstacle_generators: np.ndarray  # [n, 3, 3]

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

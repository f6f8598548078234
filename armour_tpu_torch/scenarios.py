"""The seven hard benchmark scenarios (a numpy-only copy of
armour_tpu/scenarios.py, on this package's worlds.World).

Scene definitions from get_kinova_scenario_info.m (scenario data, converted
from fetch to kinova workspace coordinates exactly as the reference's
fetch_obstacles_to_kinova_obstacles: center -> [z-0.8, y, x+0.25], sides ->
[sz, sy, sx]), plus the make_shelf_obstacle.m shelf builder.  The closed
loop over them is experiments.py's "hard" mode.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from .worlds import World

PI = math.pi


def _fetch_to_kinova(center, sides) -> Tuple[np.ndarray, np.ndarray]:
    c = np.asarray(center, dtype=float)
    s = np.asarray(sides, dtype=float)
    return np.array([c[2] - 0.8, c[1], c[0] + 0.25]), np.array([s[2], s[1], s[0]])


def _shelf(center, height, width, depth, n_shelves, min_h, max_h, direction):
    """make_shelf_obstacle.m: two side walls + n evenly spaced shelves."""
    t = 0.01
    c = np.asarray(center, dtype=float)
    boxes = []
    if direction == 1:
        boxes.append((c + [0, -width / 2, 0], [depth, t, height]))
        boxes.append((c + [0, +width / 2, 0], [depth, t, height]))
        shelf_sides = [depth, width, t]
    else:
        boxes.append((c + [-width / 2, 0, 0], [t, depth, height]))
        boxes.append((c + [+width / 2, 0, 0], [t, depth, height]))
        shelf_sides = [width, depth, t]
    for h in np.linspace(min_h, max_h, n_shelves):
        boxes.append((np.array([c[0], c[1], h]), shelf_sides))
    return boxes


def _world(start, goal, boxes, goal_radius=0.05) -> World:
    centers, gens = [], []
    for c, s in boxes:
        ck, sk = _fetch_to_kinova(c, s)
        centers.append(ck)
        gens.append(np.diag(np.asarray(sk) / 2.0))
    w = World(
        start=np.asarray(start, dtype=float),
        goal=np.asarray(goal, dtype=float),
        obstacle_centers=np.asarray(centers),
        obstacle_generators=np.asarray(gens),
    )
    return w


def hard_scenario(i: int) -> World:
    """Scenario i in 1..7 (get_kinova_scenario_info.m cases 1-7)."""
    if i == 1:  # table
        return _world(
            [0, 0.5, 0, -0.5, 0, 0, 0], [0, -0.5, 0, 0.5, 0, 0, 0],
            [([1.1, 0, 0.8], [1, 4, 0.01])],
        )
    if i == 2:  # wall / doorway
        return _world(
            [PI / 2, 0.5, 0, 0, 0, 0, 0], [-PI / 2, 0.5, 0, 0.5, 0, 0, 0],
            [([1.1, 0, 0.8], [1, 0.01, 4])],
        )
    if i == 3:  # posts
        return _world(
            [PI / 2, PI / 4, 0, 0, 0, 0, 0],
            [0.15, -0.75, 0.2, 0.4, 0.3, 0.2, 0],
            [([0.8, -0.25, 2], [0.05, 0.05, 4]), ([0.4, 0.25, 2], [0.05, 0.05, 4])],
        )
    if i == 4:  # shelves
        boxes = _shelf([1.1, 0, 0.7], 1.4, 1.2, 0.8, 3, 0.3, 1.3, 1)
        boxes += _shelf([0, 1.1, 0.7], 1.4, 1.2, 0.8, 3, 0.3, 1.3, 2)
        return _world(
            [0, -0.5, 0, 0.5, 0, 0, 0], [-PI / 2, PI / 2, -PI / 2, 0.5, 0, 0, 0],
            boxes,
        )
    if i == 5:  # inside box
        L = np.array([0.4, 0.4, 0.66])
        c = np.array([0.45, 0, L[2] / 2])
        boxes = [
            (c + [0, L[1] / 2, 0], [L[0], 0.01, L[2]]),
            (c + [-L[0] / 2, 0, 0], [0.01, L[1], L[2]]),
            (c + [0, -L[1] / 2, 0], [L[0], 0.01, L[2]]),
            (c + [L[0] / 2, 0, 0], [0.01, L[1], L[2]]),
        ]
        return _world(
            [0, 0, 0, -PI / 2, 0, 0, 0], [0.15, 0.1, 0.2, 0.4, 0.3, 0.2, 0], boxes
        )
    if i == 6:  # sink to cupboard
        cc = np.array([0.6, 0, 0.6])
        cl, cw = 0.5, 2.0
        sw, sd = 0.5, 0.3
        cup = np.array([0.6, -0.55, 1.4])
        cul, cuw, cud = cl, 0.5, 0.5
        boxes = [
            (cc + [0, sw / 2 + cw / 2, 0], [cl, cw, 0.01]),
            (cc + [0, -sw / 2 - cw / 2, 0], [cl, cw, 0.01]),
            (cc + [0, sw / 2, -sd / 2], [sw, 0.01, sd]),
            (cc + [0, -sw / 2, -sd / 2], [sw, 0.01, sd]),
            (cc + [sw / 2, 0, -sd / 2], [0.01, sw, sd]),
            (cc + [-sw / 2, 0, -sd / 2], [0.01, sw, sd]),
            (cc + [0, 0, -sd], [sw, sw, 0.01]),
            (cup + [0, cuw / 2, 0], [cul, 0.01, cud]),
            (cup + [0, -cuw / 2, 0], [cul, 0.01, cud]),
            (cup + [0, 0, cud / 2], [cul, cuw, 0.01]),
            (cup + [0, 0, -cud / 2], [cul, cuw, 0.01]),
            (cup + [cul / 2, 0, 0], [0.01, cuw, cud]),
        ]
        return _world(
            [0, PI / 6, 0, -PI / 3 - 0.15, 0, -PI / 3, 0],
            [PI / 6, 5 * PI / 12, -PI / 2, -PI / 8, PI / 2, -PI / 2, 0],
            boxes,
        )
    if i == 7:  # reach through window
        wc = np.array([0.6, 0, 0.8])
        ws = 0.625
        oh, ow = 1.5, 1.5
        boxes = [
            (wc + [0, 0, -ws / 2 - oh / 2], [0.01, 4, oh]),
            (wc + [0, 0, +ws / 2 + oh / 2], [0.01, 4, oh]),
            (wc + [0, -ws / 2 - ow / 2, 0], [0.01, ow, 4]),
            (wc + [0, +ws / 2 + ow / 2, 0], [0.01, ow, 4]),
        ]
        return _world(
            [0, PI / 2, 0, -PI / 4, 0, 0, 0], [0, 0, 0, 0, PI / 3, PI / 3, 0], boxes
        )
    raise ValueError(f"scenario {i} not in 1..7")


def all_hard_scenarios() -> List[World]:
    return [hard_scenario(i) for i in range(1, 8)]

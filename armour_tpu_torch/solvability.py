"""Offline solvability oracle for benchmark worlds (counterpart of
armour_tpu/solvability.py).

The suite's 'stuck' bucket mixes worlds the planner failed on with worlds
no planner of this conservatism can solve.  classify_world issues one
verdict per world:

  * planner_failure   - a configuration-space path exists even at the
                        certified planner's effective padding
                        (buffer = PAD_CERTIFIED);
  * padding_blocked   - a path exists for the unpadded arm skeleton but not
                        at certified padding;
  * no_path_found     - even the unpadded skeleton cannot connect within the
                        sample budget;
  * static_blocked    - the start or goal configuration itself is in
                        collision for the unpadded skeleton;
  * frs_blocked_start / frs_blocked_goal - the exact test: the planner's
                        own certified reachable set at rest (k = 0 from zero
                        velocity) of the start (goal) already penetrates an
                        obstacle, so no sound planner of this conservatism
                        can leave (park at) it.

The search is the bidirectional-connect configuration-space RRT of
hlp.ConfigRRTStarHLP with the buffer pinned; the exact test is the rest FRS
(JRS -> FK (K9) -> RNEA (K10) -> full-set check (K4, forming each row from
the cells) on the card).  Unlike the JAX module, whose checker always uses the default
ArmourConfig(float32), the checker here takes the planner's config.

    python3 -m armour_tpu_torch.solvability <results.json> <world_dir>

attaches a verdict to every stuck trial of a suite results file (in place)
and prints {"stuck_solvability": histogram}, as scripts/classify_stuck.py
does for the JAX package.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from .hlp import ConfigRRTStarHLP
from .robot import RobotModel
from .worlds import World

# effective padding of the certified planner: link box half-widths are in
# the arm skeleton FK already; the FRS adds tracking error (~1.3 cm of joint
# error -> ~2-3 cm at the wrist) plus the sub-interval sweep
PAD_CERTIFIED = 0.03


def _connects(world: World, robot: RobotModel, buffer: float, seed: int,
              max_nodes: int, tries: int = 2) -> bool:
    """True iff a bidirectional connect finds a start->goal path at this
    buffer (no relaxation ladder: the oracle pins the buffer)."""
    for attempt in range(tries):
        h = ConfigRRTStarHLP(world, robot, buffer=buffer,
                             max_nodes=max_nodes * (attempt + 1),
                             seed=seed + 104729 * attempt)
        root = np.asarray(world.start, float)
        if not h._config_free(root):
            # start pocketed at this buffer: relax locally as the stall
            # fallback does (the arm is there, so it must be escapable)
            h._root = root
            for frac in (0.5, 0.0):
                if h._config_free(root):
                    break
                h._relax_halves = np.maximum(
                    h.obs_half - (1.0 - frac) * max(buffer, 1e-3), 0.0)
        path, _ = h._grow_once(root)
        if path is not None:
            return True
    return False


def rest_frs_margins(q: torch.Tensor, obs, robot: RobotModel, cfg, basis,
                     plain: bool = False) -> torch.Tensor:
    """Max collision violation [N] of the certified k = 0 plan from zero
    velocity at each configuration q [N, F] among obstacles obs [N, O, ...]
    (the rest FRS, armour_tpu/solvability.py:117-128).  plain=True takes
    the plain versions of every kernel on q's device."""
    from .collision import collision_constraints, collision_constraints_plain
    from .nlp import max_violations
    from .planner import plan_problem

    z = torch.zeros_like(q)
    prob = plan_problem(q, z, z, q, obs, robot, cfg, basis, plain=plain)
    col = collision_constraints_plain if plain else collision_constraints
    return max_violations(z[:, None], prob, cfg, basis, collision_fn=col)[1][:, 0]


_REST_CHECKERS: dict = {}


def make_rest_frs_checker(robot: RobotModel, *, cfg=None, device=None):
    """The exact rest-FRS collision margin: (q [F], world) -> float, > 0
    when the stationary arm's certified envelope already penetrates an
    obstacle.  cfg defaults to ArmourConfig(float32), the JAX default; the
    checker runs on the card unless device names another.  Cached per
    (robot, config, device)."""
    from .collision import ObstacleSet, pad_obstacles
    from .config import ArmourConfig
    from .planner import resolve_device
    from .pz.basis import make_basis

    cfg = ArmourConfig(dtype=torch.float32) if cfg is None else cfg
    dev = resolve_device(device)
    key = (id(robot), cfg, str(dev))
    if key in _REST_CHECKERS:
        return _REST_CHECKERS[key][1]
    basis = make_basis(robot.num_factors, cfg.max_poly_degree)

    def check(q, world: World) -> float:
        obs = pad_obstacles(world.obstacle_centers, world.obstacle_generators,
                            cfg.max_obstacles, cfg.dtype, device=dev)
        one = ObstacleSet(centers=obs.centers[None], generators=obs.generators[None],
                          mask=obs.mask[None])
        qt = torch.as_tensor(np.asarray(q, float), dtype=cfg.dtype).to(dev)[None]
        return float(rest_frs_margins(qt, one, robot, cfg, basis)[0])

    # the robot is kept with its checker so that its id stays unique
    _REST_CHECKERS[key] = (robot, check)
    return check


def classify_world(world: World, robot: RobotModel, seed: int = 0, max_nodes: int = 3000,
                   frs_check: bool = True, *, cfg=None, device=None) -> dict:
    """Solvability verdict for one world: a dict with `verdict` (one of the
    module docstring's classes) and the intermediate booleans.  frs_check
    runs the exact rest-FRS test first, with cfg (default
    ArmourConfig(float32)) on device (default the card)."""
    if frs_check:
        rest = make_rest_frs_checker(robot, cfg=cfg, device=device)
        vs = rest(world.start, world)
        if vs > 0.0:
            return {"verdict": "frs_blocked_start", "start_free": False,
                    "goal_free": True, "path_padded": False,
                    "path_unpadded": False, "rest_frs_start": vs}
        vg = rest(world.goal, world)
        if vg > 0.0:
            return {"verdict": "frs_blocked_goal", "start_free": True,
                    "goal_free": False, "path_padded": False,
                    "path_unpadded": False, "rest_frs_goal": vg}
    probe = ConfigRRTStarHLP(world, robot, buffer=0.0, seed=seed)
    start_free = probe._config_free(np.asarray(world.start, float))
    goal_free = probe._config_free(np.asarray(world.goal, float))
    if not (start_free and goal_free):
        return {"verdict": "static_blocked", "start_free": bool(start_free),
                "goal_free": bool(goal_free), "path_padded": False,
                "path_unpadded": False}
    if _connects(world, robot, PAD_CERTIFIED, seed, max_nodes):
        return {"verdict": "planner_failure", "start_free": True,
                "goal_free": True, "path_padded": True, "path_unpadded": True}
    if _connects(world, robot, 0.0, seed, max_nodes):
        return {"verdict": "padding_blocked", "start_free": True,
                "goal_free": True, "path_padded": False, "path_unpadded": True}
    return {"verdict": "no_path_found", "start_free": True, "goal_free": True,
            "path_padded": False, "path_unpadded": False}


def annotate_results(results_path: str, world_dir: str, robot: RobotModel, seed: int = 0,
                     max_nodes: int = 3000, verbose: bool = True, *, cfg=None,
                     device=None) -> dict:
    """Attach a solvability verdict to every stuck trial in a results JSON
    (in place) and add a verdict histogram to its summary.  Returns the
    histogram."""
    from .worlds import load_world_csv

    with open(results_path) as f:
        doc = json.load(f)
    hist: dict = {}
    for rec in doc["results"]:
        if rec.get("bucket") != "stuck":
            continue
        world = load_world_csv(os.path.join(world_dir, rec["world"]))
        v = classify_world(world, robot, seed=seed, max_nodes=max_nodes, cfg=cfg,
                           device=device)
        rec["solvability"] = v
        hist[v["verdict"]] = hist.get(v["verdict"], 0) + 1
        if verbose:
            print(f"{rec['world']}: {v['verdict']}", flush=True)
    doc["summary"]["stuck_solvability"] = hist
    with open(results_path, "w") as f:
        json.dump(doc, f, indent=1)
    return hist


def main(argv=None) -> None:
    from .models.kinova import kinova_gen3

    argv = sys.argv[1:] if argv is None else argv
    results = argv[0] if len(argv) > 0 else "results_worlds.json"
    world_dir = argv[1] if len(argv) > 1 else "saved_worlds/random"
    hist = annotate_results(results, world_dir, kinova_gen3())
    print(json.dumps({"stuck_solvability": hist}))


if __name__ == "__main__":
    main()

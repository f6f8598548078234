"""Benchmark of the port on the card: safe planning solves per second
(counterpart of the repository root's bench.py).

    python3 -m armour_tpu_torch.bench          # W = 64
    ARMOUR_BENCH_BATCH=256 python3 -m armour_tpu_torch.bench

Measures the full planning step (JRS -> PZ FK / RNEA -> obstacle
hyperplanes -> screen -> multi-start ALM solve) on the instances of the
root bench.py: the saved-world scenes (saved_worlds/random, 13-40
obstacles) at rest, with waypoints from the end-effector RRT* HLP
(lookahead 0.1, seed i), i.e. the problems the closed-loop suite solves.
The width W comes from ARMOUR_BENCH_BATCH (default 64), the only knob; the
worlds are not chunked, so a width that does not fit the card's memory
fails: the script then prints a line with "error": "out of memory" and
exits with 1.

Prints ONE JSON line with every key of the root bench.py's line:
  value / solves_per_s   batch-W throughput of the full planning step (the
                         best of 5 calls after a warm-up, utils.timing.bench:
                         the root's utils.timing.bench with a device sync)
  latency_batch1_ms      one-world step, best of 10
  latency_p50/p99_ms     one-world step over the first min(48, W) instances
  reachset_ms / solver_ms  the step's reach-set prefix (planner.plan_problem,
                         up to the screen) at W and the rest
  reachset_batch1_ms, solver_budget_ms, budget_ok  the real-time budget
                         (armour_main.cu:227-229): 0.5 duration - t_reachsets
                         at batch 1 - 0.05 s for the solver
plus peak_mem_gb (torch.cuda.max_memory_allocated after a reset, over the
whole run) and the card's name and power limit.  Needs the card; raises
without one (run(..., device="cpu") is the CPU rehearsal the tests use).
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import time

import numpy as np
import torch

from .collision import ObstacleSet
from .config import ArmourConfig
from .utils.timing import bench, sync


def _scene_instances(cfg, batch):
    """Planning instances from the saved benchmark scenes: start state at
    rest, waypoint from the EE RRT* HLP (kinova_run_100_worlds.m settings);
    CPU tensors, the obstacles padded to cfg.max_obstacles and stacked."""
    from .collision import pad_obstacles, stack_obstacles
    from .hlp import EndEffectorRRTStarHLP
    from .models.kinova import kinova_gen3
    from .worlds import load_world_csv

    robot = kinova_gen3()
    paths = sorted(glob.glob("saved_worlds/random/*.csv"))
    if not paths:
        raise FileNotFoundError("saved_worlds/random is missing")
    worlds = [load_world_csv(paths[i % len(paths)]) for i in range(batch)]
    q0 = np.stack([w.start for w in worlds]).astype(np.float32)
    wps = np.stack([
        EndEffectorRRTStarHLP(w, robot, lookahead=0.1, seed=i).get_waypoint(w.start)
        for i, w in enumerate(worlds)
    ]).astype(np.float32)
    obs = stack_obstacles([pad_obstacles(w.obstacle_centers, w.obstacle_generators,
                                         cfg.max_obstacles, cfg.dtype) for w in worlds])
    q0 = torch.as_tensor(q0)
    zeros = torch.zeros_like(q0)
    return robot, (q0, zeros, zeros, torch.as_tensor(wps), obs)


def _one(args, i):
    q0, qd0, qdd0, wp, obs = args
    return (q0[i], qd0[i], qdd0[i], wp[i],
            ObstacleSet(centers=obs.centers[i], generators=obs.generators[i],
                        mask=obs.mask[i]))


def run(batch: int, *, device=None) -> dict:
    """The benchmark at width `batch`, on the card unless device names
    another (a CPU run measures the CPU: its line names the device "cpu"
    and has no peak memory); returns the result line."""
    from . import planner as pl
    from .pz.basis import make_basis

    dev = pl.resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip().splitlines()[0]
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = ArmourConfig(dtype=torch.float32)
    robot, host = _scene_instances(cfg, batch)
    q0, qd0, qdd0, wps, obs = host
    args = (*(x.to(dev) for x in (q0, qd0, qdd0, wps)), pl._obs_to(obs, cfg.dtype, dev))

    # batch throughput
    step = pl.make_batch_planner(robot, cfg, device=dev)
    dt, out = bench(lambda: step(*args), iters=5)
    n_feasible = int(out.feasible.sum())

    # batch-1 latency (the real-time criterion) and its spread over instances
    step1 = pl.make_planner(robot, cfg, device=dev)
    dt1, _ = bench(lambda: step1(*_one(args, 0)), iters=10)
    instances = [_one(args, i) for i in range(min(48, batch))]
    step1(*instances[0])
    sync(dev)
    lats = []
    for a in instances:
        t0 = time.perf_counter()
        step1(*a)
        sync(dev)
        lats.append(time.perf_counter() - t0)
    lat_p99 = float(np.percentile(lats, 99))
    lat_p50 = float(np.percentile(lats, 50))
    lat_consistent = bool(lat_p99 >= dt1 * 0.99)

    # reach-set / solver split at W, and the reach sets at batch 1
    basis = make_basis(robot.num_factors, cfg.max_poly_degree)

    def reachsets_only(a):
        return pl.plan_problem(*a, robot, cfg, basis)

    dt_rs, _ = bench(lambda: reachsets_only(args), iters=5)
    first = (*(x[:1] for x in args[:4]),
             ObstacleSet(centers=args[4].centers[:1], generators=args[4].generators[:1],
                         mask=args[4].mask[:1]))
    dt_rs1, _ = bench(lambda: reachsets_only(first), iters=5)
    solver_budget_s = 0.5 * cfg.duration - dt_rs1 - 0.05
    solver1_s = max(dt1 - dt_rs1, 0.0)

    solves_per_s = batch / dt
    return {
        "metric": "planning_solves_per_s",
        "value": solves_per_s,
        "unit": "solves/s",
        "vs_baseline": solves_per_s / 2.0,
        "batch": batch,
        "feasible": n_feasible,
        "latency_ms_per_batch": dt * 1e3,
        "latency_batch1_ms": dt1 * 1e3,
        "latency_p50_ms": lat_p50 * 1e3,
        "latency_p99_ms": lat_p99 * 1e3,
        "latency_consistent": lat_consistent,
        "realtime_ok": bool(lat_p99 < 0.5),
        "reachset_ms": dt_rs * 1e3,
        "solver_ms": (dt - dt_rs) * 1e3,
        "reachset_batch1_ms": dt_rs1 * 1e3,
        "solver_budget_ms": solver_budget_s * 1e3,
        "budget_ok": bool(solver1_s <= solver_budget_s),
        "instances": "saved_worlds/random + EE-RRT* waypoints",
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None,
        "card": card if cuda else "cpu",
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
    }


def main() -> None:
    batch = int(os.environ.get("ARMOUR_BENCH_BATCH", "64"))
    try:
        result = run(batch)
    except torch.cuda.OutOfMemoryError as e:
        # the width does not fit the card: one line that says so, and a failure
        print(json.dumps({"metric": "planning_solves_per_s", "batch": batch,
                          "error": "out of memory", "detail": str(e).splitlines()[0],
                          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                          "device": torch.cuda.get_device_name(0)}))
        raise SystemExit(1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()

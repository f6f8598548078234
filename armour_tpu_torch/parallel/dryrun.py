"""Dry runs of the worlds-sharded planner (counterparts of
__graft_entry__.py:dryrun_multichip and scripts/multihost_dryrun.py).

    python3 -m armour_tpu_torch.parallel.dryrun multichip [N_CARDS] [--shards S] [--device cpu]
    python3 -m armour_tpu_torch.parallel.dryrun multihost [--device cpu|cuda]

multichip shards the full flagship planning step over a mesh of S shards on
N cards (shard i on card i mod N; S = N by default) and plans 2 S
saved-world scenes.  multihost runs the sharded planner in two processes
joined by torch.distributed (gloo on localhost), 4 shards each over W = 16
worlds at the reduced shapes of scripts/multihost_dryrun.py, and reduces the
summary across them.  Each prints its summary as one JSON line (neither
writes MULTIHOST.json, the JAX package's record); both run on the card
unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
N_PROC = 2        # processes of the multihost dry run
DEV_PER_PROC = 4  # shards a process
MULTIHOST_W = 16  # worlds, 8 a process, 2 a shard
WORKER_TIMEOUT_S = 900


def _mesh_devices(n_cards: int, shards: int, device) -> list:
    """Shard i on card i mod n_cards, or every shard on the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        return ["cpu"] * shards
    return [torch.device("cuda", i % n_cards) for i in range(shards)]


def scene_inputs(cfg, batch: int):
    """Real benchmark instances: saved-world scenes (13-40 obstacles, the
    (i * 7) % len(scenes)-th for world i) at rest with end-effector RRT* HLP
    waypoints (lookahead 0.1, seed i, 150 nodes), as host tensors."""
    from ..collision import pad_obstacles, stack_obstacles
    from ..hlp import EndEffectorRRTStarHLP
    from ..models.kinova import kinova_gen3
    from ..worlds import load_world_csv

    robot = kinova_gen3()
    paths = sorted((ROOT / "saved_worlds" / "random").glob("*.csv"))
    if not paths:
        raise FileNotFoundError(f"{ROOT / 'saved_worlds' / 'random'} holds no scene")
    worlds = [load_world_csv(str(paths[(i * 7) % len(paths)])) for i in range(batch)]
    q0 = np.stack([w.start for w in worlds]).astype(np.float32)
    wps = np.stack([
        EndEffectorRRTStarHLP(w, robot, lookahead=0.1, seed=i, max_nodes=150)
        .get_waypoint(w.start)
        for i, w in enumerate(worlds)]).astype(np.float32)
    obs = stack_obstacles([pad_obstacles(w.obstacle_centers, w.obstacle_generators,
                                         cfg.max_obstacles, cfg.dtype) for w in worlds])
    q0 = torch.as_tensor(q0)
    zeros = torch.zeros_like(q0)
    return q0, zeros, zeros, torch.as_tensor(wps), obs


def dryrun_multichip(n_devices: int, *, shards=None, device=None) -> dict:
    """Shard the FULL flagship planning step (128 time steps, 40-obstacle
    cap, production solver iterations) over a mesh of `shards` shards (n_devices
    by default) on n_devices cards, run one step on 2 x shards saved-world
    scenes and print the summary; device="cpu" puts every shard on the CPU."""
    from ..config import ArmourConfig
    from ..models.kinova import kinova_gen3
    from .batch import make_mesh, make_sharded_planner, make_sharded_summary

    shards = n_devices if shards is None else shards
    if n_devices < 1 or shards < 1:
        raise ValueError(f"a dry run needs a card and a shard, got {n_devices} and {shards}")
    robot = kinova_gen3()
    cfg = ArmourConfig(dtype=torch.float32)
    mesh = make_mesh(_mesh_devices(n_devices, shards, device))
    step = make_sharded_planner(robot, cfg, mesh)
    out = step(*scene_inputs(cfg, 2 * shards))
    summary = make_sharded_summary(mesh)(out.feasible, out.cost)
    if summary["n_total"] != 2 * shards:
        raise RuntimeError(f"the summary counts {summary['n_total']} worlds, not {2 * shards}")
    line = {"dryrun": "multichip", "cards": n_devices, "shards": shards,
            "devices": [str(d) for d in mesh.devices], "worlds": 2 * shards,
            "num_time_steps": cfg.num_time_steps, "max_obstacles": cfg.max_obstacles,
            "solver_iters": [cfg.solver_outer_iters, cfg.solver_inner_iters], **summary}
    print(json.dumps(line), flush=True)
    return line


def multihost_config():
    """The reduced configuration of scripts/multihost_dryrun.py: it checks
    sharding and the cross-process reduction, not throughput."""
    from ..config import ArmourConfig

    return ArmourConfig(dtype=torch.float32, num_time_steps=16, max_obstacles=4,
                        screen_k=256, solver_outer_iters=2, solver_inner_iters=2)


def multihost_inputs(cfg, num_factors: int = 7):
    """The W = 16 global inputs of scripts/multihost_dryrun.py (rng 0): starts
    uniform in +-0.5, waypoints 0.04 away, two boxes in every world."""
    from ..collision import pad_obstacles, stack_obstacles

    rng = np.random.default_rng(0)
    q0 = rng.uniform(-0.5, 0.5, (MULTIHOST_W, num_factors)).astype(np.float32)
    wp = (q0 + 0.04).astype(np.float32)
    zeros = np.zeros_like(q0)
    c = np.array([[0.6, 0.6, 0.6], [-0.6, -0.5, 0.8]])
    g = np.stack([np.diag([0.05] * 3)] * 2)
    obs = stack_obstacles([pad_obstacles(c, g, cfg.max_obstacles, cfg.dtype)] * MULTIHOST_W)
    return q0, zeros, zeros, wp, obs


def _worker(pid: int, port: int, device: str) -> None:
    """Process pid of the multihost dry run: its 8 worlds over its 4 shards,
    the summary reduced across both processes; process 0 prints it."""
    import torch.distributed as dist

    from ..collision import ObstacleSet
    from ..models.kinova import kinova_gen3
    from .batch import make_mesh, make_sharded_planner, make_sharded_summary

    if device == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=N_PROC, rank=pid)
    try:
        robot, cfg = kinova_gen3(), multihost_config()
        n_cards = torch.cuda.device_count() if device == "cuda" else 1
        devices = ["cpu"] * DEV_PER_PROC if device == "cpu" else [
            torch.device("cuda", (pid * DEV_PER_PROC + i) % n_cards)
            for i in range(DEV_PER_PROC)]
        mesh = make_mesh(devices)
        q0, qd0, qdd0, wp, obs = multihost_inputs(cfg, robot.num_factors)
        mine = slice(pid * (MULTIHOST_W // N_PROC), (pid + 1) * (MULTIHOST_W // N_PROC))
        local = ObstacleSet(centers=obs.centers[mine], generators=obs.generators[mine],
                            mask=obs.mask[mine])
        res = make_sharded_planner(robot, cfg, mesh)(q0[mine], qd0[mine], qdd0[mine], wp[mine],
                                                     local)
        summary = make_sharded_summary(mesh)(res.feasible, res.cost)
        if pid == 0:
            print(json.dumps({"dryrun": "multihost", "processes": dist.get_world_size(),
                              "shards": N_PROC * DEV_PER_PROC, "worlds": MULTIHOST_W,
                              "device": device, **summary}), flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multihost(*, device=None) -> dict:
    """Spawn the two worker processes (gloo on a free localhost port), wait
    for both, and return and print process 0's global summary.  On the card
    the kernels are built here first, so that the workers load them and do
    not compile the same sources twice."""
    device = "cuda" if device is None else torch.device(device).type
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                               "dry run on the CPU")
        from ..kernels.build import build_all

        build_all()
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen([sys.executable, "-m", "armour_tpu_torch.parallel.dryrun",
                               "worker", str(i), str(port), device],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, text=True)
             for i in range(N_PROC)]
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(f"multihost dry run: worker exit codes {codes}")
    line = json.loads(outs[0].strip().splitlines()[-1])
    if line["processes"] != N_PROC or line["n_total"] != MULTIHOST_W:
        raise RuntimeError(f"multihost dry run: unexpected summary {line}")
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    mc = sub.add_parser("multichip")
    mc.add_argument("n_cards", type=int, nargs="?", default=None)
    mc.add_argument("--shards", type=int, default=None)
    mc.add_argument("--device", choices=("cpu", "cuda"), default=None)
    mh = sub.add_parser("multihost")
    mh.add_argument("--device", choices=("cpu", "cuda"), default=None)
    wk = sub.add_parser("worker")
    wk.add_argument("pid", type=int)
    wk.add_argument("port", type=int)
    wk.add_argument("device", choices=("cpu", "cuda"))
    a = ap.parse_args(argv)
    if a.mode == "multichip":
        n = a.n_cards
        if n is None:
            n = torch.cuda.device_count() if a.device != "cpu" else 1
        dryrun_multichip(n, shards=a.shards, device=a.device)
    elif a.mode == "multihost":
        dryrun_multihost(device=a.device)
    else:
        _worker(a.pid, a.port, a.device)


if __name__ == "__main__":
    main()

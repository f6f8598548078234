"""Stuck-tail lab: the closed-loop variant sweep over a suite's stuck
worlds (counterpart of scripts/stuck_lab.py).

    python3 -m armour_tpu_torch.scripts.stuck_lab [results.json] [world_dir] [out.json]

Takes every world the results file marks stuck (a guidance path exists:
the planner should have made it) and re-runs just those worlds batched
under a grid of planner / guidance variants, reporting which worlds each
variant recovers and which raised a safety flag.  This is the measurement
behind the suite's second-pass retry: only variants that demonstrably
recover goals get promoted into it.  STUCK_LAB_VARIANTS (comma-separated
names) restricts the grid.  The closed loop runs on the card unless the
caller passes device="cpu".
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import torch

from ..batch_sim import run_trials_batched
from ..config import ArmourConfig
from ..planner import resolve_device, strong_config
from ..worlds import load_world_csv

# name -> run_trials_batched keywords; "cfg" may be a function of the
# lab's config (strong_primary: the rescue profile as the primary solver)
VARIANTS = {
    "baseline": {},
    "seed1000": {"seed": 1000},
    "strong_primary": {"cfg": strong_config},
    "lookahead_0.5": {"lookahead": 0.5},
    "fb_lookahead_0.2": {"fallback_kwargs": {"lookahead": 0.2}},
    "fb_nodes_3000": {"fallback_kwargs": {"max_nodes": 3000}},
    "stop_8": {"stop_threshold": 8},
    "iters_1000": {"max_iterations": 1000},
}


def _unsafe(s) -> bool:
    return bool(s.collision or s.torque_exceeded or s.ultimate_bound_exceeded
                or s.joint_limit_exceeded)


def _timing(st: dict) -> str:
    """A variant's wall split from the harness's per-iteration record: the
    set-up before the loop (auto guidance's roadmaps, the warm-up), and per
    iteration the plan (solve), the move (rollout and oracles) and the rest
    (waypoints, RRT* regrows, bookkeeping)."""
    its = st.get("iterations", [])
    n = max(len(its), 1)
    loop = sum(r["iteration_s"] for r in its)
    plan = sum(r["plan_s"] + (r["rescue_s"] or 0.0) for r in its)
    move = sum(r["rollout_s"] + r["oracles_s"] for r in its)
    return (f"{st['wall_s']:.1f} s: set-up {st['wall_s'] - loop:.1f} s, {len(its)} iterations "
            f"at {loop / n * 1e3:.1f} ms: plan {plan / n * 1e3:.1f}, move {move / n * 1e3:.1f}, "
            f"guidance and bookkeeping {(loop - plan - move) / n * 1e3:.1f} ms")


def run_stuck_lab(results, world_dir, robot, cfg, *, variants=None, device=None,
                  stats=None) -> dict:
    """{variant: {"recovered": [world, ...], "n": int, "unsafe": [world, ...]}}
    over the stuck worlds of the suite results file at path `results`
    (scenes under world_dir), each variant one run_trials_batched call (auto
    guidance, no rescue solver, the worlds' suite indices for their true
    parameters).  variants: name -> keywords, VARIANTS by default.  stats:
    filled with {variant: the harness's stats of its run and its "wall_s"},
    the numbers behind each variant's printed line."""
    dev = resolve_device(device)
    with open(results) as f:
        doc = json.load(f)
    all_names = [r["world"] for r in doc["results"]]
    names = [r["world"] for r in doc["results"] if r["bucket"] == "stuck"]
    # original suite index of each stuck world, for true-param parity
    idxs = [all_names.index(n) for n in names]
    worlds = [load_world_csv(os.path.join(world_dir, n)) for n in names]
    print(f"{len(worlds)} stuck worlds", flush=True)
    report = {}
    for vname, kw in (VARIANTS if variants is None else variants).items():
        kw = dict(kw)
        vcfg = kw.pop("cfg", cfg)
        if callable(vcfg):
            vcfg = vcfg(cfg)
        seed = kw.pop("seed", 0)
        st = {}
        t0 = time.perf_counter()
        summaries = run_trials_batched(
            worlds, robot, vcfg, seed=seed, guidance="auto",
            rescue_solver=False, verbose=False,
            tp_indices=idxs, tp_total=len(all_names), **kw, stats=st, device=dev)
        st["wall_s"] = time.perf_counter() - t0
        rec = [n for n, s in zip(names, summaries) if s.goal_reached]
        unsafe = [n for n, s in zip(names, summaries) if _unsafe(s)]
        report[vname] = {"recovered": rec, "n": len(rec), "unsafe": unsafe}
        if stats is not None:
            stats[vname] = st
        print(f"{vname}: {len(rec)}/{len(worlds)} recovered "
              f"{'UNSAFE:' + str(unsafe) + ' ' if unsafe else ''}({_timing(st)})", flush=True)
    return report


def main(argv=None) -> None:
    from ..models.kinova import kinova_gen3

    argv = sys.argv[1:] if argv is None else argv
    results = argv[0] if len(argv) > 0 else "results_worlds.json"
    world_dir = argv[1] if len(argv) > 1 else "saved_worlds/random"
    # the JAX script's default file, under the caller's temporary directory
    out = argv[2] if len(argv) > 2 else os.path.join(tempfile.gettempdir(), "stuck_lab.json")
    variants = VARIANTS
    only = os.environ.get("STUCK_LAB_VARIANTS")
    if only:
        variants = {k: v for k, v in variants.items() if k in only.split(",")}
    report = run_stuck_lab(results, world_dir, kinova_gen3(),
                           ArmourConfig(dtype=torch.float32), variants=variants)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()

"""Experiment harness: the batched world suite, the hard scenarios, their
buckets and results files (counterpart of
armour_tpu/experiments.py:48-66,135-240,312-385 and
scripts/run_hard_scenarios.py).

    python3 -m armour_tpu_torch.experiments [world_dir] [n_worlds] [results.json]
        [mode] [--seed S] [--device cpu|cuda] [--trace WORLD ...]

runs every world of world_dir (the first n_worlds when n_worlds > 0; the
positional arguments of scripts/run_worlds.py) in lockstep on the card:
float32, straight-line guidance with the rescue solver, worst-case true
parameters, at most 500 lockstep iterations, seed 0 unless --seed names
another.  It writes the results file and prints the buckets.

mode "budget" (as in scripts/run_worlds.py) first calibrates the solver's
outer iterations to the measured reach-set time at batch 1
(planner.make_realtime_planner) and runs the suite at that profile,
recording the calibration in the results' batch_stats.  --trace WORLD (a
world's file name, repeatable) records that world's every iteration in
batch_stats["trace"][WORLD] (batch_sim.run_trials_batched's trace).  The
serial mode of scripts/run_worlds.py is not ported.

mode "hard" runs the 7 hard scenarios (scenarios.all_hard_scenarios) as
scripts/run_hard_scenarios.py does: one world at a time through run_trial
with make_planner, the rescue planner, worst-case true parameters
(sample_true_params at scale 1.0 on one numpy generator seeded 0), EE-RRT*
guidance (lookahead 0.1, seed i), at most 500 iterations, the results file
saved after each world
(never the JAX package's results_hard.json):

    python3 -m armour_tpu_torch.experiments - 0 results_hard_torch.json hard

It ignores world_dir, n_worlds, --seed and --trace.

mode "armtd" runs the suite twice on the same worlds, once per trajectory
family (Bernstein, then ARMTD: cfg.traj_family), as
scripts/run_armtd_comparison.py does, and writes one file holding per
family the summary, the per-world buckets and the batch_stats (rescue rate
included), and each family's full results file beside it
(armtd_torch.bernstein.json, armtd_torch.armtd.json: the layout --compare
reads); --trace applies to both runs.  It never writes the JAX package's
results_armtd_comparison.json:

    python3 -m armour_tpu_torch.experiments saved_worlds/reference 0 armtd_torch.json armtd
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional, Sequence

import numpy as np

from .config import ArmourConfig
from .robot import RobotModel
from .simulator import TrialSummary
from .worlds import load_world_csv


@dataclasses.dataclass
class SuiteResult:
    world: str
    summary: TrialSummary

    def bucket(self) -> str:
        s = self.summary
        if s.collision:
            return "collision"
        if s.torque_exceeded:
            return "torque"
        if s.ultimate_bound_exceeded:
            return "ultimate_bound"
        if s.joint_limit_exceeded:
            return "joint_limit"
        if s.goal_reached:
            return "goal"
        return "stuck"


def run_world_suite_batched(world_paths: Sequence[str], robot: RobotModel,
                            cfg: ArmourConfig, max_iterations: int = 500,
                            true_param_scale: Optional[float] = 1.0,
                            seed: int = 0, verbose: bool = True,
                            results_path: Optional[str] = None,
                            extra_stats: Optional[dict] = None,
                            rescue_solver: bool = True,
                            guidance: str = "straight",
                            *, device=None, trace: Sequence[str] = (),
                            stats: Optional[dict] = None) -> List[SuiteResult]:
    """All worlds advanced in lockstep on one card
    (batch_sim.run_trials_batched); rescue_solver/guidance pass through and
    are recorded in the saved batch_stats, into which extra_stats (e.g. the
    real-time budget calibration) is merged.  trace: world file names whose
    every iteration goes to batch_stats["trace"][name].  stats, when given,
    receives the batch_stats."""
    from .batch_sim import run_trials_batched

    names = [os.path.basename(p) for p in world_paths]
    worlds = [load_world_csv(p) for p in world_paths]
    t0 = time.perf_counter()
    batch_stats: dict = dict(extra_stats or {})
    batch_stats.update(rescue_solver=rescue_solver, guidance=guidance)
    summaries = run_trials_batched(
        worlds, robot, cfg, max_iterations=max_iterations,
        true_param_scale=true_param_scale, seed=seed, verbose=verbose,
        stats=batch_stats, rescue_solver=rescue_solver, guidance=guidance,
        device=device, trace=[names.index(n) for n in trace])
    if "trace" in batch_stats:
        batch_stats["trace"] = {names[int(i)]: rec for i, rec in batch_stats["trace"].items()}
    batch_stats["suite_wall_s"] = time.perf_counter() - t0
    results = [SuiteResult(world=n, summary=s) for n, s in zip(names, summaries)]
    if stats is not None:
        stats.update(batch_stats)
    if verbose:
        print(f"batched suite: {len(worlds)} worlds in {batch_stats['suite_wall_s']:.1f}s  "
              f"rescue_rate={batch_stats.get('rescue_rate', 0.0):.3f} wall_share="
              f"{batch_stats.get('rescue_wall_share', 0.0):.3f}", flush=True)
    if results_path:
        save_results(results, results_path, batch_stats=batch_stats)
    return results


def run_hard_world(i: int, world, robot: RobotModel, cfg: ArmourConfig, step, rescue,
                   rng: np.random.Generator, max_iterations: int = 500, *,
                   device=None) -> SuiteResult:
    """Hard scenario i closed loop, as scripts/run_hard_scenarios.py runs
    each world: its obstacles padded to cfg.max_obstacles, worst-case true
    parameters (sample_true_params(robot, rng, scale=1.0)), EE-RRT*
    guidance (lookahead 0.1, seed i),
    the planners step and rescue (make_planner / make_rescue_planner), at
    most max_iterations iterations."""
    from .collision import pad_obstacles
    from .hlp import EndEffectorRRTStarHLP
    from .simulator import run_trial, sample_true_params

    obs = pad_obstacles(world.obstacle_centers, world.obstacle_generators, cfg.max_obstacles,
                        cfg.dtype)
    tp = sample_true_params(robot, rng, scale=1.0)
    hlp = EndEffectorRRTStarHLP(world, robot, lookahead=0.1, seed=i)
    summary = run_trial(world, robot, cfg, step, obs, tp, max_iterations=max_iterations,
                        hlp=hlp, rescue_step=rescue, device=device)
    return SuiteResult(world=f"hard_{i}", summary=summary)


def run_hard_scenarios(results_path: str = "results_hard_torch.json", *,
                       device=None) -> List[SuiteResult]:
    """The 7 hard scenarios, one world at a time (scripts/run_hard_scenarios.py):
    the Kinova Gen3 in float32, one generator np.random.default_rng(0) for
    every world's true parameters, 500 iterations at most; the results file
    is saved after each world."""
    import torch

    from .models.kinova import kinova_gen3
    from .planner import make_planner, make_rescue_planner
    from .scenarios import all_hard_scenarios

    if os.path.basename(results_path) == "results_hard.json":
        raise ValueError("results_hard.json is the JAX package's record; name another file")
    robot = kinova_gen3()
    cfg = ArmourConfig(dtype=torch.float32)
    step = make_planner(robot, cfg, device=device)
    rescue = make_rescue_planner(robot, cfg, device=device)
    rng = np.random.default_rng(0)
    results = []
    for i, world in enumerate(all_hard_scenarios(), start=1):
        res = run_hard_world(i, world, robot, cfg, step, rescue, rng, device=device)
        results.append(res)
        print(f"hard scenario {i}: {res.bucket()} iters={res.summary.iterations}", flush=True)
        save_results(results, results_path)
    return results


def run_armtd_comparison(world_paths: Sequence[str], robot: RobotModel, cfg: ArmourConfig,
                         results_path: str, max_iterations: int = 500, seed: int = 0, *,
                         device=None, trace: Sequence[str] = ()) -> dict:
    """Both trajectory families through run_world_suite_batched on the same
    worlds (scripts/run_armtd_comparison.py): {"world_dir", "n_worlds",
    "families": {family: {"summary", "buckets", "batch_stats"}},
    "provenance"}, written to results_path after each family.  Each
    family's full results file (save_results' layout, for --compare) goes
    beside it, the family's name before the extension."""
    if os.path.basename(results_path) == "results_armtd_comparison.json":
        raise ValueError("results_armtd_comparison.json is the JAX package's record; "
                         "name another file")
    doc = {"world_dir": os.path.dirname(world_paths[0]) if world_paths else "",
           "n_worlds": len(world_paths), "families": {}}
    stem, ext = os.path.splitext(results_path)
    for family in ("bernstein", "armtd"):
        batch_stats: dict = {}
        results = run_world_suite_batched(
            world_paths, robot, dataclasses.replace(cfg, traj_family=family),
            max_iterations=max_iterations, seed=seed, results_path=f"{stem}.{family}{ext}",
            device=device, trace=trace, stats=batch_stats)
        summ = summarize(results)
        doc["families"][family] = {"summary": summ,
                                   "buckets": {r.world: r.bucket() for r in results},
                                   "batch_stats": batch_stats}
        print(f"{family}: {json.dumps(summ)}", flush=True)
        doc["provenance"] = _provenance()
        with open(results_path, "w") as f:
            json.dump(doc, f, indent=1)
    return doc


def summarize(results: Sequence[SuiteResult]) -> dict:
    """Buckets (collision / torque / ultimate bound / joint limit / goal /
    stuck) and the stuck attribution."""
    buckets = {"goal": 0, "collision": 0, "torque": 0, "ultimate_bound": 0,
               "joint_limit": 0, "stuck": 0}
    plan_times = []
    for r in results:
        buckets[r.bucket()] += 1
        plan_times.extend(r.summary.planning_times)
    out = dict(buckets)
    out["n_trials"] = len(results)
    if plan_times:
        out["mean_planning_time_s"] = float(np.mean(plan_times))
        out["max_planning_time_s"] = float(np.max(plan_times))
    out["safe"] = (out["collision"] == 0 and out["torque"] == 0
                   and out["ultimate_bound"] == 0 and out["joint_limit"] == 0)
    blocked_total: dict = {}
    stuck_gd = []
    for r in results:
        if r.bucket() == "stuck":
            for g, c in (r.summary.blocked_counts or {}).items():
                blocked_total[g] = blocked_total.get(g, 0) + c
            if np.isfinite(r.summary.goal_distance_min):
                stuck_gd.append(r.summary.goal_distance_min)
    out["stuck_blocked_by"] = blocked_total
    if stuck_gd:
        out["stuck_goal_distance_min_mean"] = float(np.mean(stuck_gd))
    out["rescued_plans_total"] = int(sum(r.summary.rescued_plans for r in results))
    return out


def compare_results(path_a: str, path_b: str) -> dict:
    """World-for-world comparison of two results files (save_results'
    layout, e.g. this package's run against the JAX package's): buckets
    that differ, and per world the iterations and rescued plans of each
    where either differs, with the totals.  For a world that both files
    trace (--trace), "traces" gives per common iteration [it, max |dq0|,
    max |dk|, cost a, cost b, gd a, gd b, guidance a, guidance b], the
    first iteration whose k differs at all and the first whose k differs
    by more than FORK_DK."""
    docs = []
    for path in (path_a, path_b):
        with open(path) as f:
            docs.append(json.load(f))
    a, b = ({r["world"]: r for r in d["results"]} for d in docs)
    common = sorted(set(a) & set(b))
    worlds = []
    for w in common:
        ra, rb = a[w], b[w]
        if (ra["iterations"], ra["rescued_plans"]) != (rb["iterations"], rb["rescued_plans"]) \
                or ra["bucket"] != rb["bucket"]:
            worlds.append({"world": w, "bucket": [ra["bucket"], rb["bucket"]],
                           "iterations": [ra["iterations"], rb["iterations"]],
                           "rescued_plans": [ra["rescued_plans"], rb["rescued_plans"]]})
    worlds.sort(key=lambda d: -abs(d["iterations"][0] - d["iterations"][1]))
    return {"worlds_compared": len(common),
            "only_in_one": sorted(set(a) ^ set(b)),
            "buckets_differ": [d["world"] for d in worlds if d["bucket"][0] != d["bucket"][1]],
            "iterations": [sum(a[w]["iterations"] for w in common),
                           sum(b[w]["iterations"] for w in common)],
            "rescued_plans": [sum(a[w]["rescued_plans"] for w in common),
                              sum(b[w]["rescued_plans"] for w in common)],
            "differing_worlds": worlds,
            "traces": {w: compare_traces(ta, docs[1]["batch_stats"]["trace"][w])
                       for w, ta in docs[0].get("batch_stats", {}).get("trace", {}).items()
                       if w in docs[1].get("batch_stats", {}).get("trace", {})}}


FORK_DK = 1e-3   # a k difference this large is a different plan, not rounding


def compare_traces(ta: Sequence[dict], tb: Sequence[dict]) -> dict:
    """One world's two traces (run_trials_batched's trace records), iteration
    for iteration while both run."""
    rows = []
    for ra, rb in zip(ta, tb):
        dq = float(np.max(np.abs(np.subtract(ra["q0"], rb["q0"]))))
        dk = float(np.max(np.abs(np.subtract(ra["k"], rb["k"]))))
        rows.append([ra["it"], dq, dk, ra["cost"], rb["cost"], ra["gd"], rb["gd"],
                     ra["guidance"], rb["guidance"]])
    return {"iterations": [len(ta), len(tb)],
            "first_k_difference": next((r[0] for r in rows if r[2] > 0.0), None),
            "first_fork": next((r[0] for r in rows if r[2] > FORK_DK), None),
            "rows": rows}


def _provenance() -> dict:
    """Producing command, commit (when the checkout is a git repository),
    time and device, embedded in every results file."""
    import subprocess
    import sys

    import torch

    try:
        commit = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            timeout=10).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        commit = "unknown"
    return {"command": " ".join(sys.argv), "commit": commit,
            "generated_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "device": (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                       else "cpu")}


def save_results(results: Sequence[SuiteResult], path: str,
                 batch_stats: Optional[dict] = None) -> None:
    payload = []
    for r in results:
        d = dataclasses.asdict(r.summary)
        d["world"] = r.world
        d["bucket"] = r.bucket()
        d["planning_times"] = [float(x) for x in d["planning_times"]]
        payload.append(d)
    doc = {"results": payload, "summary": summarize(results), "provenance": _provenance()}
    if batch_stats:
        doc["batch_stats"] = batch_stats
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def main(argv=None) -> None:
    import argparse
    import glob

    import torch

    from .models.kinova import kinova_gen3

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("world_dir", nargs="?", default="saved_worlds/random")
    ap.add_argument("n_worlds", nargs="?", type=int, default=0)
    ap.add_argument("results", nargs="?", default="results_worlds_torch.json")
    ap.add_argument("mode", nargs="?", default="batched",
                    choices=("batched", "budget", "serial", "hard", "armtd"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--trace", action="append", default=[], metavar="WORLD",
                    help="record this world's every iteration (file name, e.g. scene_028_009.csv)")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="print the world-for-world comparison of two results files and exit")
    args = ap.parse_args(argv)
    if args.compare:
        out = compare_results(*args.compare)
        traces = out.pop("traces")
        print(json.dumps(out, indent=1))
        for w, t in traces.items():   # one line a row
            print(f"trace {w}: " + json.dumps({k: v for k, v in t.items() if k != "rows"}))
            for r in t["rows"]:
                print("  " + json.dumps(r))
        return
    if args.mode == "hard":
        results = run_hard_scenarios(args.results, device=args.device)
        print(json.dumps(summarize(results), indent=1))
        return
    if args.mode == "serial":
        raise SystemExit("mode 'serial' (the per-world loop of scripts/run_worlds.py) is not "
                         "ported; the batched suite gives the same outcomes")
    paths = sorted(glob.glob(os.path.join(args.world_dir, "*.csv")))
    if args.n_worlds:
        paths = paths[: args.n_worlds]
    if not paths:
        raise SystemExit(f"no *.csv worlds in {args.world_dir}")
    robot, cfg = kinova_gen3(), ArmourConfig(dtype=torch.float32)
    if args.mode == "armtd":
        doc = run_armtd_comparison(paths, robot, cfg, args.results, seed=args.seed,
                                   device=args.device, trace=args.trace)
        print(json.dumps({f: d["summary"] for f, d in doc["families"].items()}, indent=1))
        return
    extra = None
    if args.mode == "budget":
        from .planner import make_realtime_planner

        _, calib = make_realtime_planner(robot, cfg, verbose=True, device=args.device)
        cfg = dataclasses.replace(
            cfg, solver_outer_iters=calib["outer_iters"],
            solver_cull_after=min(cfg.solver_cull_after, max(calib["outer_iters"] - 1, 0)))
        extra = {"budget_calibration": calib, "budget_mode": True}
    results = run_world_suite_batched(paths, robot, cfg, max_iterations=500, seed=args.seed,
                                      results_path=args.results, extra_stats=extra,
                                      device=args.device, trace=args.trace)
    print(json.dumps(summarize(results), indent=1))


if __name__ == "__main__":
    main()

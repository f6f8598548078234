"""Experiment harness: world generation, the serial and batched world
suites, the controller sweep, the hard scenarios, their buckets and results
files (counterpart of armour_tpu/experiments.py and the scripts
run_worlds.py, run_controller_sweep.py, generate_worlds.py and
run_hard_scenarios.py).

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
batch_stats["trace"][WORLD] (batch_sim.run_trials_batched's trace).
--resume keeps the worlds already in the results file and runs the others.

mode "serial" runs the worlds one at a time at batch 1 (run_world_suite,
the serial mode of scripts/run_worlds.py), saving the results file after
each world; --resume skips the worlds already in it.

mode "sweep" runs the controller sweep (robust_controller_sweep: 7
uncertainty levels x 3 controllers x 32 samples, float32, on kernel K5)
and writes its JSON (the layout of results_controller_sweep.json, never
that file) to results; world_dir and n_worlds are ignored:

    python3 -m armour_tpu_torch.experiments - 0 controller_sweep_torch.json sweep

mode "generate" writes the 100-scene random suite (generate_world_suite,
default_rng(--seed)) into world_dir, the JAX package's files byte for byte:

    python3 -m armour_tpu_torch.experiments /tmp/worlds 0 - generate --seed 0

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
from .worlds import load_world_csv, random_world, save_world_csv

DEFAULT_COUNTS = (13, 16, 19, 22, 25, 28, 31, 34, 37, 40)


def generate_world_suite(out_dir: str, robot: RobotModel,
                         counts: Sequence[int] = DEFAULT_COUNTS,
                         per_count: int = 10, seed: int = 0) -> List[str]:
    """per_count random worlds (worlds.random_world) for each obstacle count,
    written as scene_NNN_III.csv; one generator default_rng(seed) for all,
    so the files are the JAX package's, byte for byte."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for n in counts:
        for i in range(per_count):
            w = random_world(rng, robot, n)
            path = os.path.join(out_dir, f"scene_{n:03d}_{i + 1:03d}.csv")
            save_world_csv(w, path)
            paths.append(path)
    return paths


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


def _load_done(results_path: Optional[str], names: Sequence[str]) -> dict:
    """The per-world records of results_path (save_results' layout) whose
    world file name is in names, as {name: SuiteResult}; resume keys worlds
    by file name, as the JAX package does."""
    done: dict = {}
    if results_path and os.path.exists(results_path):
        with open(results_path) as f:
            for d in json.load(f).get("results", []):
                name = d.pop("world")
                d.pop("bucket", None)
                d.pop("solvability", None)
                if name in names:
                    done[name] = SuiteResult(world=name, summary=TrialSummary(**d))
    return done


def run_world_suite(world_paths: Sequence[str], robot: RobotModel,
                    cfg: ArmourConfig, max_iterations: int = 500,
                    true_param_scale: Optional[float] = 1.0,
                    seed: int = 0, verbose: bool = True,
                    results_path: Optional[str] = None,
                    use_hlp: bool = False,
                    resume: bool = False, *, device=None,
                    stats: Optional[dict] = None) -> List[SuiteResult]:
    """The serial suite: one world at a time through simulator.run_trial at
    batch 1, with make_planner and the rescue planner, the results file
    saved after each world.  World i's true parameters come from
    default_rng((seed, i)), so resumed and fresh runs sample the same ones.
    use_hlp: EE-RRT* guidance (lookahead 0.1, seed seed + i) instead of the
    straight line.  resume=True: worlds already in results_path are
    reloaded, not run (keyed by file name).  stats, when given, receives
    per world run its run_trial stats (each iteration's plan / move /
    oracle seconds) and its wall seconds.  Runs on the card unless device
    names another device."""
    from .collision import pad_obstacles
    from .planner import make_planner, make_rescue_planner
    from .simulator import make_oracles, make_rollout, run_trial, sample_true_params

    names = [os.path.basename(p) for p in world_paths]
    done = _load_done(results_path, names) if resume else {}
    parts = None
    results = []
    for i, path in enumerate(world_paths):
        name = names[i]
        if name in done:
            results.append(done[name])
            continue
        if parts is None:
            parts = (make_planner(robot, cfg, device=device),
                     make_rescue_planner(robot, cfg, device=device),
                     make_rollout(robot, cfg, device=device),
                     make_oracles(robot, cfg, device=device))
        step, rescue, rollout, oracles = parts
        world = load_world_csv(path)
        obs = pad_obstacles(world.obstacle_centers, world.obstacle_generators,
                            cfg.max_obstacles, cfg.dtype)
        tp = sample_true_params(robot, np.random.default_rng((seed, i)),
                                scale=true_param_scale)
        hlp = None
        if use_hlp:
            from .hlp import EndEffectorRRTStarHLP

            hlp = EndEffectorRRTStarHLP(world, robot, lookahead=0.1, seed=seed + i)
        trial_stats: dict = {}
        t0 = time.perf_counter()
        summary = run_trial(world, robot, cfg, step, obs, tp,
                            max_iterations=max_iterations, rollout=rollout,
                            oracles=oracles, hlp=hlp, rescue_step=rescue, device=device,
                            stats=trial_stats)
        trial_stats["wall_s"] = time.perf_counter() - t0
        if stats is not None:
            stats[name] = trial_stats
        res = SuiteResult(world=name, summary=summary)
        results.append(res)
        if verbose:
            print(f"{res.world}: {res.bucket()} iters={summary.iterations} "
                  f"infeasible={summary.infeasible_plans} "
                  f"wall={trial_stats['wall_s']:.1f}s", flush=True)
        if results_path:
            save_results(results, results_path)
    return results


def run_world_suite_batched(world_paths: Sequence[str], robot: RobotModel,
                            cfg: ArmourConfig, max_iterations: int = 500,
                            true_param_scale: Optional[float] = 1.0,
                            seed: int = 0, verbose: bool = True,
                            results_path: Optional[str] = None,
                            extra_stats: Optional[dict] = None,
                            rescue_solver: bool = True,
                            guidance: str = "straight",
                            resume: bool = False,
                            second_pass: Optional[dict] = None,
                            *, device=None, trace: Sequence[str] = (),
                            stats: Optional[dict] = None) -> List[SuiteResult]:
    """All worlds advanced in lockstep on one card
    (batch_sim.run_trials_batched); rescue_solver/guidance pass through and
    are recorded in the saved batch_stats, into which extra_stats (e.g. the
    real-time budget calibration) is merged.  trace: world file names whose
    every iteration goes to batch_stats["trace"][name].  stats, when given,
    receives the batch_stats.

    resume=True: worlds already in results_path (keyed by file name) are
    reloaded and only the others run, as a sub-batch whose true parameters
    are drawn as in the fresh full run (run_trials_batched's tp_indices /
    tp_total); a call with every world done runs nothing.

    second_pass: a dict of run_trials_batched overrides (plus optional
    'cfg' and 'seed' keys) for a sub-batch of the worlds left stuck, with
    the main run's true parameters.  Only retries that reach the goal with
    no safety flag replace a record; batch_stats["second_pass"] records
    the attempt and the worlds swapped."""
    from .batch_sim import run_trials_batched

    names = [os.path.basename(p) for p in world_paths]
    done = _load_done(results_path, names) if resume else {}
    todo = [i for i, n in enumerate(names) if n not in done]
    if not todo:
        return [done[n] for n in names]
    worlds = [load_world_csv(world_paths[i]) for i in todo]
    t0 = time.perf_counter()
    batch_stats: dict = dict(extra_stats or {})
    batch_stats.update(rescue_solver=rescue_solver, guidance=guidance)
    if done:
        batch_stats["resumed_worlds"] = len(done)
    run_names = [names[i] for i in todo]
    summaries = run_trials_batched(
        worlds, robot, cfg, max_iterations=max_iterations,
        true_param_scale=true_param_scale, seed=seed, verbose=verbose,
        stats=batch_stats, rescue_solver=rescue_solver, guidance=guidance,
        tp_indices=(todo if done else None), tp_total=(len(names) if done else None),
        device=device, trace=[run_names.index(n) for n in trace if n not in done])
    if "trace" in batch_stats:
        batch_stats["trace"] = {run_names[int(i)]: rec
                                for i, rec in batch_stats["trace"].items()}
    fresh = dict(zip(run_names, summaries))
    results = [done[n] if n in done else SuiteResult(world=n, summary=fresh[n])
               for n in names]
    if second_pass is not None:
        _second_pass(results, world_paths, robot, cfg, second_pass, max_iterations,
                     true_param_scale, seed, verbose, batch_stats, device)
    batch_stats["suite_wall_s"] = time.perf_counter() - t0
    if stats is not None:
        stats.update(batch_stats)
    if verbose:
        print(f"batched suite: {len(worlds)} worlds in {batch_stats['suite_wall_s']:.1f}s  "
              f"rescue_rate={batch_stats.get('rescue_rate', 0.0):.3f} wall_share="
              f"{batch_stats.get('rescue_wall_share', 0.0):.3f}", flush=True)
    if results_path:
        save_results(results, results_path, batch_stats=batch_stats)
    return results


def _second_pass(results: List[SuiteResult], world_paths: Sequence[str], robot: RobotModel,
                 cfg: ArmourConfig, second_pass: dict, max_iterations: int,
                 true_param_scale: Optional[float], seed: int, verbose: bool,
                 batch_stats: dict, device) -> None:
    """Retry the stuck worlds of results in place (run_world_suite_batched's
    second_pass)."""
    from .batch_sim import run_trials_batched

    stuck_idx = [i for i, r in enumerate(results) if r.bucket() == "stuck"]
    if not stuck_idx:
        return
    sp = dict(second_pass)
    sp_cfg = sp.pop("cfg", cfg)
    sp_seed = sp.pop("seed", seed)
    retried = run_trials_batched(
        [load_world_csv(world_paths[i]) for i in stuck_idx], robot, sp_cfg,
        max_iterations=sp.pop("max_iterations", max_iterations),
        true_param_scale=true_param_scale, seed=sp_seed, verbose=verbose,
        tp_indices=stuck_idx, tp_total=len(results), device=device, **sp)
    swapped = []
    for i, s in zip(stuck_idx, retried):
        safe = not (s.collision or s.torque_exceeded or s.ultimate_bound_exceeded
                    or s.joint_limit_exceeded)
        if s.goal_reached and safe:
            results[i] = SuiteResult(world=results[i].world, summary=s)
            swapped.append(results[i].world)
    batch_stats["second_pass"] = {
        "attempted": len(stuck_idx), "recovered": swapped,
        "variant": {k: (repr(v)[:200] if k == "cfg" else v) for k, v in second_pass.items()}}
    if verbose:
        print(f"second pass: {len(swapped)}/{len(stuck_idx)} stuck worlds recovered",
              flush=True)


def robust_controller_sweep(robot: RobotModel, cfg: ArmourConfig,
                            uncertainties: Sequence[float] = (0.0, 0.05, 0.1, 0.15, 0.2,
                                                              0.25, 0.3),
                            controllers: Sequence[str] = ("robust", "althoff", "nominal"),
                            n_samples: int = 32, seed: int = 0,
                            results_path: Optional[str] = None, *,
                            device=None) -> dict:
    """Tracking error and input over model uncertainty: for each level,
    n_samples randomised references (sweep_draws) tracked by each
    controller under the worst-case true parameters (sweep_true_params);
    one batched rollout (make_rollout, kernel K5 on the card) per (level,
    controller) gives the max |q - q_des|, max |qd - qd_des| and mean |u|.
    The JSON layout is results_controller_sweep.json's."""
    from .planner import resolve_device
    from .simulator import make_rollout

    if results_path and os.path.basename(results_path) == "results_controller_sweep.json":
        raise ValueError("results_controller_sweep.json is the JAX package's record; "
                         "name another file")
    dev = resolve_device(device)
    out = {"uncertainties": list(uncertainties), "n_samples": n_samples,
           "controllers": {c: {"max_pos_err": [], "max_vel_err": [], "mean_abs_u": []}
                           for c in controllers}}
    q0, qd0, refs = sweep_draws(robot, cfg, n_samples, seed, dev)
    for u in uncertainties:
        robot_u = dataclasses.replace(robot, mass_uncertainty=u, inertia_uncertainty=u)
        tp = sweep_true_params(robot, cfg, u, n_samples, dev)
        for ctrl in controllers:
            roll = make_rollout(robot_u, cfg, controller=ctrl, device=dev)
            _, _, logs = roll(q0, qd0, refs, tp)
            rec = out["controllers"][ctrl]
            rec["max_pos_err"].append(float((logs["q"] - logs["q_des"]).abs().max()))
            rec["max_vel_err"].append(float((logs["qd"] - logs["qd_des"]).abs().max()))
            rec["mean_abs_u"].append(float(logs["u"].abs().mean()))
    if results_path:
        out["provenance"] = _provenance()
        with open(results_path, "w") as f:
            json.dump(out, f, indent=1)
    return out


def sweep_draws(robot: RobotModel, cfg: ArmourConfig, n_samples: int, seed: int, device):
    """The sweep's start states and references, drawn from default_rng(seed)
    in the JAX package's order: anchors in +-pi/2 rad and +-0.3 rad/s, start
    offsets of 0.025 pi in position and 0.05 pi in velocity, k in [-1, 1]
    (kinova_compare_robust_controller.m:80-86).  (q0, qd0, refs) on device."""
    import torch

    from .trajectory import advance_plan, initial_plan

    rng = np.random.default_rng(seed)
    F = robot.num_factors
    q_anchor = rng.uniform(-np.pi / 2, np.pi / 2, (n_samples, F))
    qd_anchor = rng.uniform(-0.3, 0.3, (n_samples, F))
    dq = rng.normal(size=(n_samples, F))
    dq = 0.025 * np.pi * dq / np.linalg.norm(dq, axis=1, keepdims=True)
    dqd = rng.normal(size=(n_samples, F))
    dqd = 0.05 * np.pi * dqd / np.linalg.norm(dqd, axis=1, keepdims=True)
    ks = rng.uniform(-1, 1, (n_samples, F))

    def t(x):
        return torch.as_tensor(x, dtype=cfg.dtype).to(device)

    qa, qda = t(q_anchor), t(qd_anchor)
    refs = advance_plan(initial_plan(qa, cfg.dtype, device=device), t(ks), qa, qda,
                        torch.zeros_like(qa), cfg)
    return t(q_anchor + dq), t(qd_anchor + dqd), refs


def sweep_true_params(robot: RobotModel, cfg: ArmourConfig, u: float, n_samples: int, device):
    """The worst-case true parameters at uncertainty level u: mass and
    inertia scaled by 1 + u, the nominal centres of mass."""
    import torch

    from .simulator import TrueParams

    def t(x):
        return torch.as_tensor(x, dtype=cfg.dtype).to(device)

    return TrueParams(mass=t(np.tile(robot.mass * (1.0 + u), (n_samples, 1))),
                      inertia=t(np.tile(robot.inertia * (1.0 + u), (n_samples, 1, 1, 1))),
                      com=t(np.tile(robot.com, (n_samples, 1, 1))))


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
                    choices=("batched", "budget", "serial", "hard", "armtd", "sweep",
                             "generate"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="batched / serial: keep the worlds already in the results file")
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
    if args.mode == "generate":
        paths = generate_world_suite(args.world_dir, kinova_gen3(), seed=args.seed)
        print(f"wrote {len(paths)} scenes to {args.world_dir}")
        return
    if args.mode == "sweep":
        out = robust_controller_sweep(kinova_gen3(), ArmourConfig(dtype=torch.float32),
                                      seed=args.seed, results_path=args.results,
                                      device=args.device)
        print(json.dumps(out, indent=1))
        return
    paths = sorted(glob.glob(os.path.join(args.world_dir, "*.csv")))
    if args.n_worlds:
        paths = paths[: args.n_worlds]
    if not paths:
        raise SystemExit(f"no *.csv worlds in {args.world_dir}")
    robot, cfg = kinova_gen3(), ArmourConfig(dtype=torch.float32)
    if args.mode == "serial":
        results = run_world_suite(paths, robot, cfg, seed=args.seed, results_path=args.results,
                                  resume=args.resume, device=args.device)
        print(json.dumps(summarize(results), indent=1))
        return
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
                                      resume=args.resume, device=args.device,
                                      trace=args.trace)
    print(json.dumps(summarize(results), indent=1))


if __name__ == "__main__":
    main()

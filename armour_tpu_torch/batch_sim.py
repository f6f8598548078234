"""Batched closed-loop simulation: many worlds stepped in lockstep on the
card (counterpart of armour_tpu/batch_sim.py:36-442).

The whole receding-horizon loop (plan, track, safety oracles, goal check)
runs over a leading worlds axis, so one card advances every trial one
iteration per step; the host only updates per-world bookkeeping (active
flags, stop counters, guidance).  Finished worlds keep being simulated
(static shapes) but their results are masked out, mirroring the serial
semantics.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .collision import pad_obstacles, stack_obstacles
from .config import ArmourConfig
from .planner import make_batch_planner, resolve_device, strong_config
from .robot import RobotModel
from .simulator import (ORACLE_FLAGS, VIOL_GROUPS, TrialSummary, TrueParams,
                        make_oracles, make_rollout, sample_true_params)
from .trajectory import PlanRef, advance_plan, desired_state, initial_plan
from .utils.timing import sync
from .worlds import World


def stack_worlds(worlds: Sequence[World], cfg: ArmourConfig, *, device="cpu"):
    """starts [W, F] tensor, goals [W, F] numpy, padded ObstacleSet [W, O, ...]."""
    starts = torch.as_tensor(np.stack([w.start for w in worlds]), dtype=cfg.dtype).to(device)
    goals = np.stack([w.goal for w in worlds])
    obs = stack_obstacles([pad_obstacles(w.obstacle_centers, w.obstacle_generators,
                                         cfg.max_obstacles, cfg.dtype, device=device)
                           for w in worlds])
    return starts, goals, obs


def _batched_true_params(robot: RobotModel, rng: np.random.Generator, W: int,
                         scale: Optional[float],
                         indices: Optional[Sequence[int]] = None,
                         total: Optional[int] = None) -> TrueParams:
    """W worlds' true parameters, drawn in world order from rng.  indices /
    total: draw the full `total`-world sequence and keep `indices`."""
    n = total if total is not None else W
    tps = [sample_true_params(robot, rng, scale=scale) for _ in range(n)]
    if indices is not None:
        tps = [tps[i] for i in indices]
    return TrueParams(mass=torch.stack([t.mass for t in tps]),
                      inertia=torch.stack([t.inertia for t in tps]),
                      com=torch.stack([t.com for t in tps]))


def run_trials_batched(
    worlds: Sequence[World],
    robot: RobotModel,
    cfg: ArmourConfig,
    max_iterations: int = 500,
    stop_threshold: int = 4,
    lookahead: float = 1.0,
    true_param_scale: Optional[float] = 1.0,
    seed: int = 0,
    goal_radius: float = np.pi / 30,
    verbose: bool = False,
    use_hlp: bool = False,
    hlp_lookahead: float = 0.1,
    stall_window: int = 25,
    stall_progress: float = 0.05,
    rescue_solver: bool = True,
    rescue_cooldown: int = 3,
    max_fallback_regrows: int = 50,
    guidance: str = "straight",
    stats: Optional[dict] = None,
    tp_indices: Optional[Sequence[int]] = None,
    tp_total: Optional[int] = None,
    fallback_kwargs: Optional[dict] = None,
    *,
    device=None,
    trace: Sequence[int] = (),
) -> List[TrialSummary]:
    """Run every world's closed-loop trial in lockstep (batched run_trial).

    guidance "straight": the straight-line configuration-space waypoint
    (lookahead 1 rad, wrapping only continuous joints); a world whose goal
    distance improves by less than stall_progress over stall_window
    iterations, or whose plan fails twice in a row, is handed to a per-world
    ConfigRRTStarHLP grown from its current configuration, regrown with a
    wider buffer (0.08 + 0.04 per regrow) when it stalls again.  "auto":
    worlds whose straight start->goal segment is blocked get a config-RRT*
    roadmap from iteration 0.  use_hlp: the end-effector RRT* waypoint
    generator instead of the straight line.

    rescue_solver: when the default solver declares a world's plan
    infeasible, re-solve the batch with the strong profile (strong_config)
    and take its plans for the infeasible rows; a world the rescue fails on
    cannot trigger it again for rescue_cooldown iterations.

    stats: filled in place with the batch economics (batch_iterations,
    rescue_iterations / rescue_rate, fast and rescue wall seconds,
    rescue_wall_share, rescued and recovered rows) and one record per
    iteration (host-clock seconds of plan, rescue, rollout, oracles and the
    whole iteration, each ending in a device synchronisation).

    trace: world indices whose every iteration is recorded in
    stats["trace"][i] (the guidance in force, the plan's start state,
    waypoint, chosen k, feasibility, cost and whether the rescue solver
    gave it, the state reached, the goal distance and the stall counters).

    Runs on the card unless device names another device."""
    dev = resolve_device(device)
    W = len(worlds)
    dt = cfg.dtype
    if not all(w.goal_type == "configuration" for w in worlds):
        raise ValueError("the batched suite supports configuration goals")
    starts, goals_np, obs = stack_worlds(worlds, cfg, device=dev)
    rng = np.random.default_rng(seed)
    tp = _batched_true_params(robot, rng, W, true_param_scale,
                              indices=tp_indices, total=tp_total).to(dt, dev)
    hlps = None
    if use_hlp:
        from .hlp import EndEffectorRRTStarHLP

        hlps = [EndEffectorRRTStarHLP(w, robot, lookahead=hlp_lookahead, seed=seed + i)
                for i, w in enumerate(worlds)]

    planner = make_batch_planner(robot, cfg, device=dev)
    rescue = make_batch_planner(robot, strong_config(cfg), device=dev) if rescue_solver else None
    rollout = make_rollout(robot, cfg, device=dev)
    oracles = make_oracles(robot, cfg, device=dev)

    goals = torch.as_tensor(goals_np, dtype=dt).to(dev)
    cont = torch.as_tensor(np.asarray(robot.continuous_joints, bool)).to(dev)

    def plan_inputs(ref: PlanRef):
        q0, qd0, qdd0 = desired_state(ref, cfg.t_plan, cfg)
        # wrap ONLY continuous joints; wrapping a limited joint steers into
        # its joint-limit wall
        d_plain = goals - q0
        d = torch.where(cont, torch.remainder(d_plain + np.pi, 2 * np.pi) - np.pi, d_plain)
        dist = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        step = torch.where(dist <= lookahead, d, d * (lookahead / torch.clamp_min(dist, 1e-12)))
        return q0, qd0, qdd0, q0 + step

    def accept(ref: PlanRef, k, q0, qd0, qdd0) -> PlanRef:
        return advance_plan(ref, k, q0, qd0, qdd0, cfg)

    def goal_reached(q):
        d = torch.remainder(q - goals + np.pi, 2 * np.pi) - np.pi
        return torch.linalg.vector_norm(d, dim=-1) <= goal_radius

    # per-world host bookkeeping
    active = np.ones(W, dtype=bool)
    flags = {name: np.zeros(W, dtype=bool) for name in ORACLE_FLAGS}
    goal = np.zeros(W, dtype=bool)
    infeasible = np.zeros(W, dtype=np.int64)
    stop_count = np.zeros(W, dtype=np.int64)
    iterations = np.zeros(W, dtype=np.int64)
    plan_times: List[float] = []
    fast_wall = 0.0
    rescue_wall = 0.0
    rescue_iters = 0
    rescued_rows = 0
    recovered_rows = 0
    rescued_plans = np.zeros(W, dtype=np.int64)
    rescue_block = np.zeros(W, dtype=np.int64)   # per-world cooldown
    blocked = np.zeros((W, len(VIOL_GROUPS)), dtype=np.int64)
    gd_final = np.full(W, np.nan)
    gd_min = np.full(W, np.inf)
    iter_log: List[dict] = []
    traces = {int(i): [] for i in trace}
    # stall-fallback guidance: per-world config-RRT*, engaged when the
    # straight-line waypoint stops making progress
    fallback: List = [None] * W
    if guidance == "auto":
        from .hlp import ConfigRRTStarHLP

        n_routed = 0
        for i, w in enumerate(worlds):
            h = ConfigRRTStarHLP(w, robot, seed=seed + 31 * i, **(fallback_kwargs or {}))
            s0 = np.asarray(w.start, float)
            g0 = np.asarray(w.goal, float)
            if not h._edge_free(s0, g0):
                h._grow(s0)
                fallback[i] = h
                n_routed += 1
        if verbose:
            print(f"guidance=auto: {n_routed}/{W} worlds routed by "
                  f"config-RRT* from iteration 0", flush=True)
        if stats is not None:
            stats["guidance_auto_routed"] = n_routed
    elif guidance != "straight":
        raise ValueError(guidance)
    fallback_regrows = np.zeros(W, dtype=np.int64)
    stall_ref_gd = np.full(W, np.inf)      # best gd at the last stall check
    stall_count = np.zeros(W, dtype=np.int64)
    # retreat target: the plan-start state of the last FEASIBLE plan
    retreat = np.array([np.asarray(w.start, np.float64) for w in worlds])

    q = starts
    qd = torch.zeros_like(q)
    ref = initial_plan(starts, dt, device=dev)

    # warm-up outside the timed loop: every kernel's build (in parallel),
    # the planners' first calls, the allocator
    if dev.type == "cuda":
        from .kernels.build import build_all

        build_all()
    q0w, qd0w, qdd0w, wpw = plan_inputs(ref)
    planner(q0w, qd0w, qdd0w, wpw, obs)
    if rescue is not None:
        rescue(q0w, qd0w, qdd0w, wpw, obs)
    sync(dev)

    wp_cache = np.asarray(goals_np, dtype=np.float64).copy()

    for it in range(max_iterations):
        t_iter = time.perf_counter()
        q0, qd0, qdd0, waypoints = plan_inputs(ref)
        if np.any(stop_count[active] > 0) or hlps is not None \
                or any(f is not None for f in fallback):
            # host-side waypoints, only for still-active worlds (inactive
            # worlds keep their last waypoint; results are masked); a
            # world's stall-fallback config-RRT* takes precedence
            q0h = q0.cpu().numpy().astype(np.float64)
            wp_np = waypoints.cpu().numpy().astype(np.float64)
            for i in range(W):
                if not active[i]:
                    wp_np[i] = wp_cache[i]
                    continue
                if stop_count[i] > 0:
                    # braking after an infeasible plan: retreat to the last
                    # feasible plan-start state
                    wp_np[i] = retreat[i]
                else:
                    gen = fallback[i] if fallback[i] is not None else (
                        hlps[i] if hlps is not None else None)
                    if gen is not None:
                        wp_np[i] = gen.get_waypoint(q0h[i])
                wp_cache[i] = wp_np[i]
            waypoints = torch.as_tensor(wp_np, dtype=dt).to(dev)
        guide = {i: ("retreat" if stop_count[i] > 0 else
                     f"rrt#{int(fallback_regrows[i])}" if fallback[i] is not None else
                     "ee_rrt" if hlps is not None else "straight") for i in traces}
        t0 = time.perf_counter()
        res = planner(q0, qd0, qdd0, waypoints, obs)
        k = res.k.cpu().numpy()
        viol = res.viol.cpu().numpy()
        feas = np.all(np.isfinite(k), axis=-1)
        t_fast = time.perf_counter() - t0
        # the trace's copies stay outside the timed windows
        cost = res.cost.cpu().numpy() if traces else None
        took_rescue = np.zeros(W, dtype=bool)
        plan_times.append(t_fast)
        fast_wall += t_fast
        t_rescue = None
        rescue_block = np.maximum(rescue_block - 1, 0)
        if rescue is not None and np.any(~feas & active & (rescue_block == 0)):
            # strong-profile retry: the whole batch is re-solved (static
            # shapes), only infeasible rows' results are taken
            t0r = time.perf_counter()
            feas_pre = feas.copy()
            res2 = rescue(q0, qd0, qdd0, waypoints, obs)
            k2 = res2.k.cpu().numpy()
            feas2 = np.all(np.isfinite(k2), axis=-1)
            take = (~feas) & feas2
            k[take] = k2[take]
            viol[~feas] = res2.viol.cpu().numpy()[~feas]
            rescued_rows += int(np.sum((~feas) & active))
            recovered_rows += int(np.sum(take & active))
            rescued_plans += (take & active).astype(np.int64)
            feas = feas | feas2
            rescue_block[(~feas_pre) & (~feas2) & active] = rescue_cooldown
            t_rescue = time.perf_counter() - t0r
            rescue_wall += t_rescue
            rescue_iters += 1
            if traces:
                cost[take] = res2.cost.cpu().numpy()[take]
                took_rescue = take
        infeasible += (~feas) & active
        grp = np.argmax(viol, axis=-1)
        rows = np.where((~feas) & active)[0]
        blocked[rows, grp[rows]] += 1
        q0_np = q0.cpu().numpy().astype(np.float64)
        retreat[feas & active] = q0_np[feas & active]
        # freeze bookkeeping for inactive worlds
        stop_count = np.where(active, np.where(feas, 0, stop_count + 1), stop_count)

        ref = accept(ref, torch.as_tensor(k, dtype=dt).to(dev), q0, qd0, qdd0)
        t0m = time.perf_counter()
        q, qd, logs = rollout(q, qd, ref, tp)
        sync(dev)
        t_roll = time.perf_counter() - t0m
        t0o = time.perf_counter()
        checks = {name: v.cpu().numpy() for name, v in oracles(logs, obs).items()}
        t_orc = time.perf_counter() - t0o
        reached = goal_reached(q).cpu().numpy()
        q_np = q.cpu().numpy().astype(np.float64)
        gd = np.linalg.norm(np.mod(q_np - goals_np + np.pi, 2 * np.pi) - np.pi, axis=-1)
        gd_final = np.where(active, gd, gd_final)
        gd_min = np.where(active, np.minimum(gd_min, gd), gd_min)

        # stall detection -> config-RRT* fallback guidance: no goal progress
        # for stall_window iterations, or two consecutive infeasible plans
        progressed = gd_min < stall_ref_gd - stall_progress
        stall_ref_gd = np.where(progressed, gd_min, stall_ref_gd)
        stall_count = np.where(progressed | ~active, 0, stall_count + 1)
        infeas_trigger = active & (stop_count == 2) & (fallback_regrows == 0)
        may_regrow = fallback_regrows < max_fallback_regrows
        for i in np.where(active & may_regrow
                          & ((stall_count >= stall_window) | infeas_trigger))[0]:
            from .hlp import ConfigRRTStarHLP

            # widen the guidance buffer on every regrow
            fallback[i] = ConfigRRTStarHLP(
                worlds[i], robot,
                seed=seed + 7919 * (int(fallback_regrows[i]) + 1) + i,
                **{"buffer": 0.08 + 0.04 * int(fallback_regrows[i]),
                   **(fallback_kwargs or {})})
            fallback_regrows[i] += 1
            stall_count[i] = 0
            if verbose:
                print(f"  world {i}: stalled at gd={gd[i]:.2f} -> "
                      f"config-RRT* fallback #{int(fallback_regrows[i])}", flush=True)

        for i, rec in traces.items():
            if active[i]:
                rec.append({
                    "it": it, "guidance": guide[i],
                    "q0": q0_np[i].tolist(), "qd0": qd0[i].tolist(),
                    "qdd0": qdd0[i].tolist(), "waypoint": waypoints[i].tolist(),
                    "k": k[i].tolist(), "feasible": bool(feas[i]), "cost": float(cost[i]),
                    "rescued": bool(took_rescue[i]), "q": q_np[i].tolist(),
                    "gd": float(gd[i]), "gd_min": float(gd_min[i]),
                    "stall_ref_gd": float(stall_ref_gd[i]), "stall_count": int(stall_count[i]),
                    "regrows": int(fallback_regrows[i])})
        iterations += active
        for name in flags:
            flags[name] |= checks[name] & active
        violated = np.zeros(W, dtype=bool)
        for name in flags:
            violated |= checks[name]
        goal |= reached & active & ~violated
        active &= ~violated & ~reached & (stop_count < stop_threshold)
        iter_log.append({"plan_s": t_fast, "rescue_s": t_rescue, "rollout_s": t_roll,
                         "oracles_s": t_orc, "iteration_s": time.perf_counter() - t_iter})
        if verbose:
            print(f"iter {it}: active={int(active.sum())}/{W} goal={int(goal.sum())} "
                  f"feasible={int(feas.sum())}", flush=True)
        if not active.any():
            break

    # amortized time: the batch wall time split evenly across the W worlds
    per_iter = [t / W for t in plan_times]
    if stats is not None:
        n_iter = max(len(plan_times), 1)
        total_wall = fast_wall + rescue_wall
        stats.update({
            "planning_time_semantics": "amortized_batch_share",
            "batch_iterations": len(plan_times),
            "rescue_iterations": rescue_iters,
            "rescue_rate": rescue_iters / n_iter,
            "fast_wall_s": fast_wall,
            "rescue_wall_s": rescue_wall,
            "rescue_wall_share": (rescue_wall / total_wall) if total_wall else 0.0,
            "rescued_rows": rescued_rows,
            "recovered_rows": recovered_rows,
            "iterations": iter_log,
        })
        if traces:
            stats["trace"] = {str(i): rec for i, rec in traces.items()}
    return [
        TrialSummary(
            goal_reached=bool(goal[i]),
            collision=bool(flags["collision"][i]),
            torque_exceeded=bool(flags["torque_exceeded"][i]),
            ultimate_bound_exceeded=bool(flags["ultimate_bound_exceeded"][i]),
            joint_limit_exceeded=bool(flags["joint_limit_exceeded"][i]),
            infeasible_plans=int(infeasible[i]),
            iterations=int(iterations[i]),
            planning_times=per_iter[: int(iterations[i])],
            stuck=bool(stop_count[i] >= stop_threshold),
            blocked_counts={g: int(blocked[i, j]) for j, g in enumerate(VIOL_GROUPS)
                            if blocked[i, j]},
            goal_distance_final=float(gd_final[i]),
            goal_distance_min=(float(gd_min[i]) if np.isfinite(gd_min[i]) else float("nan")),
            rescued_plans=int(rescued_plans[i]),
        )
        for i in range(W)
    ]

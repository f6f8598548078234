"""Closed-loop simulation: plant dynamics, tracking rollout, safety oracles
and the receding-horizon driver (counterpart of armour_tpu/simulator.py).

  * plant: qdd = M(q)^-1 (u - C(q, qd) qd - g(q)) with the TRUE (perturbed)
    inertial parameters + transmission inertia;
  * integrator: fixed-step RK4 with zero-order-hold control at 1 kHz, M^-1
    held across the RK4 stages of a control step.  On the card the whole
    move is kernel K5 (csrc/rollout.cu); rollout_plain is the same step loop
    in PyTorch, used for CPU tensors and as K5's reference;
  * oracles per move: exact OBB-vs-OBB link/obstacle separation, torque
    limits, ultimate bound, joint limits (all four must never fire).  On the
    card the check is kernel K6 (csrc/oracle_check.cu); oracle_check_plain
    is its reference;
  * receding-horizon loop (run_trial): plan -> move(t_plan) -> checks, with
    the braking fallback on infeasible plans and a stop counter.

Every function takes a leading worlds axis W.  Measurement noise is a
[W, n_ctrl, 2, F] tensor drawn up front from torch.Generator(noise_seed) and
handed to whichever version runs the move (the JAX package draws it with
jax.random inside its scan, a stream PyTorch cannot replay).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .collision import ObstacleSet
from .config import ArmourConfig
from .controller import (ALTHOFF_DEFAULT, AlthoffGains, althoff_control,
                         nominal_passivity_control, robust_control)
from .planner import resolve_device
from .rnea_numeric import coriolis_gravity, forward_kinematics, joint_rotations, mass_matrix
from .robot import RobotModel
from .trajectory import PlanRef, advance_plan, desired_state, initial_plan
from .worlds import World, straight_line_waypoint, world_goal_check

CONTROLLERS = ("robust", "nominal", "althoff")
ORACLE_FLAGS = ("collision", "torque_exceeded", "ultimate_bound_exceeded",
                "joint_limit_exceeded")


@dataclasses.dataclass
class TrueParams:
    """The plant's actual inertial parameters (within the modelled interval):
    mass [..., J], inertia [..., J, 3, 3], com [..., J, 3]."""

    mass: torch.Tensor
    inertia: torch.Tensor
    com: torch.Tensor

    def to(self, dtype, device) -> "TrueParams":
        return TrueParams(*(torch.as_tensor(x).to(device=device, dtype=dtype)
                            for x in (self.mass, self.inertia, self.com)))


def sample_true_params(robot: RobotModel, rng: np.random.Generator,
                       scale: Optional[float] = None) -> TrueParams:
    """Random (or worst-case if scale is given) true parameters within
    +-uncertainty; the same numpy draws, in the same order, as the JAX
    package.  float64 tensors on the CPU."""
    if scale is None:
        sm = rng.uniform(-1, 1, robot.num_joints)
        si = rng.uniform(-1, 1, robot.num_joints)
        sc = rng.uniform(-1, 1, robot.num_joints)
    else:
        sm = np.full(robot.num_joints, scale)
        si = np.full(robot.num_joints, scale)
        sc = np.full(robot.num_joints, scale)
    mass = robot.mass * (1.0 + robot.mass_uncertainty * sm)
    inertia = robot.inertia * (1.0 + robot.inertia_uncertainty * si)[:, None, None]
    com = robot.com * (1.0 + robot.com_uncertainty * sc)[:, None]
    return TrueParams(mass=torch.as_tensor(mass), inertia=torch.as_tensor(inertia),
                      com=torch.as_tensor(com))


# ---------------------------------------------------------------------------
# tracking rollout
# ---------------------------------------------------------------------------


def rollout_plain(robot: RobotModel, cfg: ArmourConfig, q, qd, q_des, qd_des, qdd_des,
                  tp: TrueParams, control_dt: float, substeps: int = 2,
                  controller: str = "robust", noise=None,
                  gains: AlthoffGains = ALTHOFF_DEFAULT):
    """One move in PyTorch, the reference of kernel K5: q, qd [W, F], the
    move's reference q_des/qd_des/qdd_des [W, n, F] (control time i * dt),
    optional noise [W, n, 2, F] added to the state the controller measures.
    Returns (q, qd, q_log, qd_log, u_log), logs [W, n, F] holding the state
    after each step and the input applied during it."""
    if controller not in CONTROLLERS:
        raise ValueError(controller)
    q_log = torch.empty_like(q_des)
    qd_log = torch.empty_like(q_des)
    u_log = torch.empty_like(q_des)
    n = q_des.shape[1]
    kw = dict(mass=tp.mass, inertia=tp.inertia, com=tp.com)
    e_acc = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)
    h = control_dt / substeps
    # no autograd bookkeeping in the step loop (host time on the CPU); the
    # logs are written in place, q and qd copied out after
    with torch.inference_mode():
        for i in range(n):
            qr, qdr, qddr = q_des[:, i], qd_des[:, i], qdd_des[:, i]
            q_m, qd_m = q, qd
            if noise is not None:
                q_m = q + noise[:, i, 0]
                qd_m = qd + noise[:, i, 1]
            # the joint rotations at q serve the mass matrix, the first RK4
            # stage and, without noise, the controller
            R_q = joint_rotations(robot, q)
            R_m = R_q if noise is None else None
            if controller == "robust":
                u, _, _ = robust_control(robot, cfg, q_m, qd_m, qr, qdr, qddr, rotations=R_m)
            elif controller == "nominal":
                u = nominal_passivity_control(robot, cfg, q_m, qd_m, qr, qdr, qddr,
                                              rotations=R_m)
            else:
                u, _, _, e_acc = althoff_control(robot, cfg, q_m, qd_m, qr, qdr, qddr,
                                                 e_acc, control_dt, gains, rotations=R_m)

            # M(q) varies slowly: once per control step, held across the stages
            # (inv_ex: no host synchronisation on the card)
            M_inv = torch.linalg.inv_ex(mass_matrix(robot, q, **kw, rotations=R_q)).inverse

            def ode(qq, qqd, R=None):
                rhs = u - coriolis_gravity(robot, qq, qqd, **kw, rotations=R)
                return qqd, (M_inv * rhs[..., None, :]).sum(-1)

            for sub in range(substeps):
                k1 = ode(q, qd, R_q if sub == 0 else None)
                k2 = ode(q + 0.5 * h * k1[0], qd + 0.5 * h * k1[1])
                k3 = ode(q + 0.5 * h * k2[0], qd + 0.5 * h * k2[1])
                k4 = ode(q + h * k3[0], qd + h * k3[1])
                q = q + (h / 6.0) * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
                qd = qd + (h / 6.0) * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
            q_log[:, i] = q
            qd_log[:, i] = qd
            u_log[:, i] = u
    return q.clone(), qd.clone(), q_log, qd_log, u_log


def rollout_move(robot: RobotModel, cfg: ArmourConfig, q, qd, q_des, qd_des, qdd_des,
                 tp: TrueParams, control_dt: float, substeps: int = 2,
                 controller: str = "robust", noise=None,
                 gains: AlthoffGains = ALTHOFF_DEFAULT):
    """One move: kernel K5 on CUDA tensors, rollout_plain on CPU tensors."""
    if not q.is_cuda:
        return rollout_plain(robot, cfg, q, qd, q_des, qd_des, qdd_des, tp, control_dt,
                             substeps, controller, noise, gains)
    from .kernels import sim as ksim

    return ksim.rollout(robot, cfg, q, qd, q_des, qd_des, qdd_des, tp, control_dt,
                        substeps, controller, noise, gains)


def make_rollout(robot: RobotModel, cfg: ArmourConfig, control_dt: float = 1e-3,
                 substeps: int = 2, controller: str = "robust",
                 measurement_noise: float = 0.0, noise_seed: int = 0,
                 move_mode: str = "integrate", *, device=None,
                 gains: AlthoffGains = ALTHOFF_DEFAULT):
    """The tracking rollout over t_plan: rollout(q, qd, ref, tp) ->
    (q, qd, logs) with q, qd [W, F], ref a PlanRef [W, F], tp TrueParams
    [W, ...], logs {"q", "qd", "u", "q_des", "qd_des"} [W, n_ctrl, F].

    controller: "robust" (CBF), "nominal" (passivity ablation) or "althoff"
    (PI-adaptive comparison).  measurement_noise: stddev of the white noise
    on the state the controller measures.  move_mode "direct" moves the
    agent along the reference with zero input (logs at (i + 1) * dt).
    Runs on the card unless device names another device."""
    if controller not in CONTROLLERS:
        raise ValueError(controller)
    if move_mode not in ("integrate", "direct"):
        raise ValueError(move_mode)
    dev = resolve_device(device)
    dt = cfg.dtype
    n_ctrl = int(round(cfg.t_plan / control_dt))

    def _to(ref: PlanRef) -> PlanRef:
        return PlanRef(*(torch.as_tensor(x).to(device=dev, dtype=dt)
                         for x in dataclasses.astuple(ref)))

    if move_mode == "direct":

        def rollout_direct(q, qd, ref: PlanRef, tp: TrueParams):
            ref = _to(ref)
            t = (torch.arange(n_ctrl, dtype=dt, device=dev) + 1) * control_dt
            q_des, qd_des, _ = desired_state(ref, t, cfg)
            qf, qdf, _ = desired_state(ref, cfg.t_plan, cfg)
            logs = {"q": q_des, "qd": qd_des, "u": torch.zeros_like(q_des),
                    "q_des": q_des, "qd_des": qd_des}
            return qf, qdf, logs

        return rollout_direct

    def rollout(q, qd, ref: PlanRef, tp: TrueParams):
        q = torch.as_tensor(q).to(device=dev, dtype=dt)
        qd = torch.as_tensor(qd).to(device=dev, dtype=dt)
        ref = _to(ref)
        t = torch.arange(n_ctrl, dtype=dt, device=dev) * control_dt
        q_des, qd_des, qdd_des = desired_state(ref, t, cfg)
        noise = None
        if measurement_noise:
            g = torch.Generator().manual_seed(noise_seed)
            noise = (measurement_noise * torch.randn(
                (q.shape[0], n_ctrl, 2, q.shape[-1]), generator=g,
                dtype=torch.float64)).to(device=dev, dtype=dt)
        q, qd, q_log, qd_log, u_log = rollout_move(
            robot, cfg, q, qd, q_des.contiguous(), qd_des.contiguous(),
            qdd_des.contiguous(), tp.to(dt, dev), control_dt, substeps, controller,
            noise, gains)
        logs = {"q": q_log, "qd": qd_log, "u": u_log, "q_des": q_des, "qd_des": qd_des}
        return q, qd, logs

    return rollout


# ---------------------------------------------------------------------------
# safety oracles
# ---------------------------------------------------------------------------


def _sat_axes(center_a, axes_a, half_a, center_b, axes_b, half_b):
    """(valid, |d . L|, r_a + r_b) for each of the 15 candidate axes: 3 of A,
    3 of B, 9 cross products (columns of axes_* are the unit box axes)."""
    d = center_b - center_a

    def proj(axes, half, L):
        # half-extent of the box along L: sum_i half_i |axis_i . L|
        return (half * (axes * L[..., :, None]).sum(-2).abs()).sum(-1)

    cand = [axes_a[..., :, i] for i in range(3)] + [axes_b[..., :, j] for j in range(3)]
    for i in range(3):
        for j in range(3):
            a, b = torch.broadcast_tensors(axes_a[..., :, i], axes_b[..., :, j])
            cand.append(torch.linalg.cross(a, b, dim=-1))
    for L in cand:
        norm = torch.linalg.vector_norm(L, dim=-1, keepdim=True)
        valid = norm > 1e-9
        Ln = torch.where(valid, L / torch.where(valid, norm, torch.ones_like(norm)),
                         torch.zeros_like(L))
        yield (valid[..., 0], (d * Ln).sum(-1).abs(),
               proj(axes_a, half_a, Ln) + proj(axes_b, half_b, Ln))


def obb_obb_separated(center_a, axes_a, half_a, center_b, axes_b, half_b):
    """Exact OBB vs OBB separating-axis test, batched.  center_* [..., 3],
    axes_* [..., 3, 3] (columns = unit box axes), half_* [..., 3].  True =
    disjoint."""
    sep = None
    for valid, dist, rad in _sat_axes(center_a, axes_a, half_a, center_b, axes_b, half_b):
        s = valid & (dist > rad)
        sep = s if sep is None else sep | s
    return sep


def sat_margin(center_a, axes_a, half_a, center_b, axes_b, half_b):
    """The deciding SAT margin: max over the valid axes of |d . L| - (r_a +
    r_b) (-inf when no axis is valid).  The boxes are disjoint exactly when
    it is > 0."""
    best = None
    for valid, dist, rad in _sat_axes(center_a, axes_a, half_a, center_b, axes_b, half_b):
        m = torch.where(valid, dist - rad, torch.full_like(dist, -float("inf")))
        best = m if best is None else torch.maximum(best, m)
    return best


def obstacle_axes_halves(generators):
    """Unit axes [..., O, 3, 3] (columns) + half extents [..., O, 3] of box
    zonotope obstacles from their generator matrix (columns = generators).
    A degenerate (zero) generator gets a default axis (projection radius 0)."""
    g = generators.transpose(-1, -2)                     # [..., O, 3(gen), 3(coord)]
    half = torch.linalg.vector_norm(g, dim=-1)           # [..., O, 3]
    eye = torch.eye(3, dtype=generators.dtype, device=generators.device).expand(g.shape)
    axes = torch.where(half[..., None] > 1e-12,
                       g / torch.clamp_min(half[..., None], 1e-12), eye)
    return axes.transpose(-1, -2), half


def _link_boxes(robot: RobotModel, q):
    """Link box frames of every logged state: rotation [..., J, 3, 3],
    centre [..., J, 3] and half extents [J, 3]."""
    R_w, _, centers = forward_kinematics(robot, q)
    return R_w, centers, torch.as_tensor(robot.link_generators, dtype=q.dtype).to(q.device)


def oracle_check_plain(robot: RobotModel, cfg: ArmourConfig, logs: dict, obs: ObstacleSet):
    """The four safety flags of one move per world, the reference of kernel
    K6: (flags [W, 4] bool in ORACLE_FLAGS order, overlaps [W] int64 = the
    number of overlapping (step, link, real obstacle) triples)."""
    q, qd, u = logs["q"], logs["qd"], logs["u"]              # [W, N, F]
    R_w, centers, link_h = _link_boxes(robot, q)
    obs_axes, obs_half = obstacle_axes_halves(obs.generators)
    sep = obb_obb_separated(centers[:, :, :, None, :], R_w[:, :, :, None],
                            link_h[:, None, :], obs.centers[:, None, None],
                            obs_axes[:, None, None], obs_half[:, None, None])
    hit = (~sep & obs.mask[:, None, None, :]).flatten(1)      # [W, N*J*O]

    def c(x):
        return torch.as_tensor(x, dtype=q.dtype).to(q.device)

    def anyw(x):
        return x.flatten(1).any(-1)

    ub = cfg.ub
    torque = anyw(u.abs() > c(robot.torque_limits))
    bound = anyw((q - logs["q_des"]).abs() > ub.qe) | anyw((qd - logs["qd_des"]).abs() > ub.qde)
    joint = (anyw(q < c(robot.position_limits_lb)) | anyw(q > c(robot.position_limits_ub))
             | anyw(qd.abs() > c(robot.speed_limits)))
    flags = torch.stack([hit.any(-1), torque, bound, joint], -1)
    return flags, hit.sum(-1)


def oracle_check(robot: RobotModel, cfg: ArmourConfig, logs: dict, obs: ObstacleSet):
    """(flags [W, 4], overlaps [W]): kernel K6 on CUDA tensors,
    oracle_check_plain on CPU tensors."""
    if not logs["q"].is_cuda:
        return oracle_check_plain(robot, cfg, logs, obs)
    from .kernels import sim as ksim

    return ksim.oracle_check(robot, cfg, logs["q"], logs["qd"], logs["u"], logs["q_des"],
                             logs["qd_des"], obs.centers, obs.generators, obs.mask)


def make_oracles(robot: RobotModel, cfg: ArmourConfig, *, device=None):
    """The per-move safety checks over logged trajectories: check(logs, obs)
    -> {flag: [W] bool} for the flags of ORACLE_FLAGS.  Runs on the card
    unless device names another device."""
    dev = resolve_device(device)

    def check(logs: dict, obs: ObstacleSet) -> dict:
        logs = {k: torch.as_tensor(v).to(device=dev, dtype=cfg.dtype).contiguous()
                for k, v in logs.items()}
        obs = ObstacleSet(centers=obs.centers.to(device=dev, dtype=cfg.dtype).contiguous(),
                          generators=obs.generators.to(device=dev,
                                                       dtype=cfg.dtype).contiguous(),
                          mask=obs.mask.to(device=dev, dtype=torch.bool).contiguous())
        flags, _ = oracle_check(robot, cfg, logs, obs)
        return {name: flags[:, j] for j, name in enumerate(ORACLE_FLAGS)}

    return check


# ---------------------------------------------------------------------------
# receding-horizon driver
# ---------------------------------------------------------------------------


VIOL_GROUPS = ("torque", "collision", "state", "grasp")


@dataclasses.dataclass
class TrialSummary:
    goal_reached: bool
    collision: bool
    torque_exceeded: bool
    ultimate_bound_exceeded: bool
    joint_limit_exceeded: bool
    infeasible_plans: int
    iterations: int
    planning_times: list
    stuck: bool
    # which constraint group had the max violation on each infeasible plan,
    # and goal-distance progress
    blocked_counts: dict = dataclasses.field(default_factory=dict)
    goal_distance_final: float = float("nan")
    goal_distance_min: float = float("nan")
    # plans this trial recovered via the strong-profile rescue solver
    rescued_plans: int = 0


def run_trial(world: World, robot: RobotModel, cfg: ArmourConfig, planner_step,
              obs: ObstacleSet, true_params: TrueParams, max_iterations: int = 100,
              stop_threshold: int = 4, lookahead: float = 1.0, verbose: bool = False,
              rollout=None, oracles=None, hlp=None, trace_path: Optional[str] = None,
              trace_stride: int = 10, stall_window: int = 25,
              stall_progress: float = 0.05, rescue_step=None,
              max_fallback_regrows: int = 50, *, device=None,
              stats: Optional[dict] = None) -> TrialSummary:
    """One closed-loop trial on one world.  planner_step = make_planner(robot,
    cfg) output (one world); rollout/oracles default to make_rollout /
    make_oracles on `device` (the card unless named).  hlp: optional
    waypoint generator with .get_waypoint(q); the default is the
    straight-line waypoint.

    trace_path: write a .npz replay trace in the JAX package's layout
    (scripts/replay_trial.py renders it): the moves' logged q, qd, u, q_des,
    qd_des every trace_stride control steps, each plan's k, waypoint and
    feasibility, the world, trace_dt, robot_name and the safety flags.

    stats, when given, receives per iteration the host-clock seconds of the
    plan, the move and the oracles (each ending in a device
    synchronisation): stats["iterations"] = [{"plan_s", "move_s",
    "oracles_s"}, ...]."""
    import time as _time

    dev = resolve_device(device)
    rollout = rollout if rollout is not None else make_rollout(robot, cfg, device=dev)
    oracles = oracles if oracles is not None else make_oracles(robot, cfg, device=dev)
    dt = cfg.dtype
    # warm-up outside the timed loop, on the card (the CPU has nothing to
    # warm)
    if dev.type == "cuda":
        _q0w = np.asarray(world.start, float)
        _zw = np.zeros_like(_q0w)
        planner_step(_q0w, _zw, _zw, _q0w, obs)
        if rescue_step is not None:
            rescue_step(_q0w, _zw, _zw, _q0w, obs)
    obs_b = ObstacleSet(centers=obs.centers[None], generators=obs.generators[None],
                        mask=obs.mask[None])
    tp = TrueParams(*(torch.as_tensor(x)[None] for x in
                      (true_params.mass, true_params.inertia, true_params.com)))

    trace = {name: [] for name in TRACE_LOGS + ("k", "waypoint", "feasible")} \
        if trace_path else None
    timings = stats.setdefault("iterations", []) if stats is not None else None

    q = torch.as_tensor(world.start, dtype=dt).to(dev)[None]
    qd = torch.zeros_like(q)
    ref = initial_plan(q, dt, device=dev)
    flags = {name: False for name in ORACLE_FLAGS}
    infeasible = 0
    stop_count = 0
    rescued = 0
    plan_times = []
    goal = False
    it = 0
    blocked_counts: dict = {}
    gd_min = float("inf")
    gd = float("nan")

    def _goal_distance(qq):
        d = np.mod(np.asarray(qq) - world.goal + np.pi, 2 * np.pi) - np.pi
        return float(np.linalg.norm(d))

    fallback_hlp = None
    fallback_count = 0
    stall_ref = float("inf")
    stall_iters = 0
    retreat = np.asarray(world.start, float)   # last feasible plan start

    for it in range(max_iterations):
        # plan from the REFERENCE state at the end of the last move
        q0, qd0, qdd0 = desired_state(ref, cfg.t_plan, cfg)
        q0h = q0[0].cpu().numpy()
        if stop_count > 0:
            waypoint = retreat
        elif fallback_hlp is not None:
            waypoint = fallback_hlp.get_waypoint(q0h)
        elif hlp is not None:
            waypoint = hlp.get_waypoint(q0h)
        else:
            waypoint = straight_line_waypoint(q0h, world.goal, lookahead,
                                              continuous=robot.continuous_joints)
        wp = torch.as_tensor(np.asarray(waypoint), dtype=dt)
        t0 = _time.perf_counter()
        res = planner_step(q0[0], qd0[0], qdd0[0], wp, obs)
        k = res.k.cpu().numpy()
        if rescue_step is not None and not np.all(np.isfinite(k)):
            res = rescue_step(q0[0], qd0[0], qdd0[0], wp, obs)
            k = res.k.cpu().numpy()
            if np.all(np.isfinite(k)):
                rescued += 1
        plan_times.append(_time.perf_counter() - t0)

        if np.all(np.isfinite(k)):
            stop_count = 0
            retreat = np.asarray(q0h, float)
        else:
            infeasible += 1
            stop_count += 1
            grp = VIOL_GROUPS[int(np.argmax(res.viol.cpu().numpy()))]
            blocked_counts[grp] = blocked_counts.get(grp, 0) + 1
        ref = advance_plan(ref, torch.as_tensor(k)[None], q0, qd0, qdd0, cfg)

        t1 = _time.perf_counter()
        q, qd, logs = rollout(q, qd, ref, tp)
        gd = _goal_distance(q[0].cpu().numpy())
        t2 = _time.perf_counter()
        gd_min = min(gd_min, gd)
        if gd_min < stall_ref - stall_progress:
            stall_ref = gd_min
            stall_iters = 0
        else:
            stall_iters += 1
        if fallback_count < max_fallback_regrows and (
                stall_iters >= stall_window
                or (stop_count == 2 and fallback_count == 0)):
            from .hlp import ConfigRRTStarHLP

            fallback_count += 1
            fallback_hlp = ConfigRRTStarHLP(
                world, robot, buffer=0.08 + 0.04 * (fallback_count - 1),
                seed=7919 * fallback_count)
            stall_iters = 0
            if verbose:
                print(f"iter {it}: stalled at gd={gd:.2f} -> "
                      f"config-RRT* fallback #{fallback_count}")
        t3 = _time.perf_counter()
        checks = {name: bool(v[0]) for name, v in oracles(logs, obs_b).items()}
        if timings is not None:
            timings.append({"plan_s": plan_times[-1], "move_s": t2 - t1,
                            "oracles_s": _time.perf_counter() - t3})
        if trace is not None:
            for name in TRACE_LOGS:
                trace[name].append(logs[name][0, ::trace_stride].cpu().numpy())
            trace["k"].append(k)
            trace["waypoint"].append(np.asarray(waypoint))
            trace["feasible"].append(bool(np.all(np.isfinite(k))))
        for name in flags:
            flags[name] = flags[name] or checks[name]
        if verbose:
            print(f"iter {it}: feasible={np.all(np.isfinite(k))} "
                  f"q={q[0].cpu().numpy().round(2)} checks={checks}")
        if any(flags.values()):
            break
        if world_goal_check(world, q[0].cpu().numpy(), robot):
            goal = True
            break
        if stop_count >= stop_threshold:
            break

    summary = TrialSummary(
        goal_reached=goal, infeasible_plans=infeasible, iterations=it + 1,
        planning_times=plan_times, stuck=(stop_count >= stop_threshold),
        blocked_counts=blocked_counts, goal_distance_final=gd,
        goal_distance_min=(gd_min if np.isfinite(gd_min) else float("nan")),
        rescued_plans=rescued, **flags)
    if trace is not None:
        _save_trace(trace_path, trace, world, robot, summary, trace_stride)
    return summary


TRACE_LOGS = ("q", "qd", "u", "q_des", "qd_des")


def _save_trace(path: str, trace: dict, world: World, robot: RobotModel,
               summary: TrialSummary, trace_stride: int) -> None:
    """The replay trace as armour_tpu/simulator.py:459-477 writes it: one row
    per iteration of each logged array, the world, trace_dt, robot_name and
    the flags (collision, torque, ultimate bound, joint limit, goal,
    stuck)."""
    np.savez_compressed(
        path,
        **{name: np.stack(trace[name]) for name in TRACE_LOGS + ("k", "waypoint")},
        feasible=np.asarray(trace["feasible"]),
        start=np.asarray(world.start), goal=np.asarray(world.goal),
        obstacle_centers=np.asarray(world.obstacle_centers),
        obstacle_generators=np.asarray(world.obstacle_generators),
        trace_dt=float(1e-3 * trace_stride),
        robot_name=robot.name,
        flags=np.asarray([summary.collision, summary.torque_exceeded,
                          summary.ultimate_bound_exceeded,
                          summary.joint_limit_exceeded,
                          summary.goal_reached, summary.stuck]))

"""Batched trajectory-optimisation NLP (counterpart of armour_tpu/nlp.py).

The problem: n = F variables k in [-1,1]^F;
  cost = cost_scale * sum_j wrap(q_plan_j(k) - q_des_j)^2
  subject to torque, grasp (when the plan has them), collision and
  state-limit rows c(k) <= 0.
Solved by a fixed-iteration multi-start augmented-Lagrangian method with
projected Gauss-Newton inner steps, then re-checked against the full
constraint set (infeasible -> NaN k, the caller brakes).

Layout: k is [W, Q, F] (worlds, query points); the multi-start seeds are
Q = S, the line search evaluates Q = S * A points in one pass.  The solve
loop makes no host synchronisation: control flow is torch.where on device
tensors.

The loop evaluates its rows only through two functions of plain tensors:
alm_newton (one inner step's Gauss-Newton system, its 7x7 Cholesky step,
merit, feasibility and cost; kernel K7 on the card, alm_newton_plain on the
CPU) and alm_values (merit, feasibility, cost and optionally the rows of
query points; kernel K8, alm_values_plain).  Between two row passes the
loop's bookkeeping (the best-feasible tracker, the line search's ladder
and accept test, the multiplier update, the cull, the pull-in bisection and
the final selection) is one phase of kernel K14 on the card, run by the
finish of the K7 / K8 call that feeds it (all but the cull and the final
selection, which launch K14 after their torch reductions), and the
alm_*_plain functions on the CPU.  On the card neither the constraint stack
nor its Jacobian is formed inside the loop; the full-set check in finalize
(max_violations: kernel K4 over every collision row, each formed from its
cell, K8's max mode for the torque and state rows) is what soundness rests on.

q_plan is linear in k (weight s^3 (6 s^2 - 15 s + 10) * k_range at
s = t_plan / duration; 0.5 t_plan^2 g_k for the ARMTD family), so the cost
gradient is written out and its Hessian is the constant diagonal
2 * cost_scale * weight^2 (the JAX package takes them from jax.grad /
jax.hessian).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import types

import torch

from . import bezier
from .collision import (BIG, Hyperplanes, ObstacleSet, ScreenedCollision,
                        collision_constraints, eval_link_poly_grads,
                        eval_link_polys, screened_rows)
from .config import ArmourConfig
from .dynamics import TorqueFRS
from .jrs import TrajectoryCoeffs
from .kinematics import LinkFRS
from .pz.basis import KBasis
from .robot import RobotModel
from .utils import div, to_device


def wrap_to_pi(x):
    return torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi


@dataclasses.dataclass
class RobotLimits:
    """Robot limits on the solver's device, each [F]."""

    torque: torch.Tensor
    pos_lb: torch.Tensor
    pos_ub: torch.Tensor
    speed: torch.Tensor
    continuous: torch.Tensor   # bool


def robot_limits(robot: RobotModel, dtype, device) -> RobotLimits:
    return RobotLimits(
        torque=to_device(robot.torque_limits, dtype, device),
        pos_lb=to_device(robot.position_limits_lb, dtype, device),
        pos_ub=to_device(robot.position_limits_ub, dtype, device),
        speed=to_device(robot.speed_limits, dtype, device),
        continuous=to_device(robot.continuous_joints, torch.bool, device),
    )


@dataclasses.dataclass
class PlanProblem:
    """Everything the solver needs, built once per plan."""

    traj: TrajectoryCoeffs
    q_des: torch.Tensor          # [W, F]
    torque: TorqueFRS
    frs: LinkFRS
    hyp: Hyperplanes
    obs: ObstacleSet
    screened: ScreenedCollision
    limits: RobotLimits
    # optional k-sliceable contact rows (grasp.GraspFRS); None leaves them
    # out of the stack
    grasp: object = None


# ---------------------------------------------------------------------------
# cost
# ---------------------------------------------------------------------------


def _traj(traj: TrajectoryCoeffs):
    """Trajectory scalars [W, F] -> [W, 1, F] against k [W, Q, F]."""
    return traj.q0[:, None], traj.Tqd0[:, None], traj.TTqdd0[:, None], traj.k_scale[:, None]


def _plan_diff(k, traj: TrajectoryCoeffs, q_des, continuous, cfg: ArmourConfig):
    q0, Tqd0, TTqdd0, k_scale = _traj(traj)
    if traj.family == "armtd":
        tp = cfg.t_plan
        q_plan = q0 + traj.qd0[:, None] * tp + 0.5 * (k * k_scale) * tp * tp
    else:
        q_plan = bezier.q_des(q0, Tqd0, TTqdd0, k * k_scale, cfg.t_plan / cfg.duration)
    diff = q_plan - q_des[:, None]
    return torch.where(continuous, wrap_to_pi(diff), diff)


def plan_cost(k, traj: TrajectoryCoeffs, q_des, continuous, cfg: ArmourConfig):
    """cost [W, Q] at k [W, Q, F].  The squares are summed over F in order,
    as kernels K7 / K8 sum them (csrc/alm_rows.cuh:alm_cost): torch.sum's
    order is its own and differs between devices."""
    diff = _plan_diff(k, traj, q_des, continuous, cfg)
    sq = diff * diff
    total = sq[..., 0]
    for f in range(1, sq.shape[-1]):
        total = total + sq[..., f]
    return cfg.cost_scale * total


def _cost_weight(traj: TrajectoryCoeffs, cfg: ArmourConfig):
    """d q_plan / d k [W, 1, F]."""
    if traj.family == "armtd":
        return 0.5 * cfg.t_plan * cfg.t_plan * traj.k_scale[:, None]
    return bezier.q_des_k_weight(cfg.t_plan / cfg.duration) * traj.k_scale[:, None]


def plan_cost_grad(k, traj: TrajectoryCoeffs, q_des, continuous, cfg: ArmourConfig):
    """d cost / d k [W, Q, F] (the wrap is piecewise a shift)."""
    diff = _plan_diff(k, traj, q_des, continuous, cfg)
    return cfg.cost_scale * (2.0 * diff) * _cost_weight(traj, cfg)


def plan_cost_hessian(traj: TrajectoryCoeffs, cfg: ArmourConfig):
    """Constant diagonal Hessian of the cost [W, 1, F, F]."""
    w = _cost_weight(traj, cfg)
    return torch.diag_embed(2.0 * cfg.cost_scale * w * w)


# ---------------------------------------------------------------------------
# state-limit extrema over the whole trajectory
# ---------------------------------------------------------------------------


def _select_extrema(cands, grads, inside):
    """min/max over candidate rows [4, ...] and the gradients there."""
    cands_lo = torch.where(inside, cands, torch.full_like(cands, BIG))
    cands_hi = torch.where(inside, cands, torch.full_like(cands, -BIG))
    i_lo = torch.argmin(cands_lo, dim=0, keepdim=True)
    i_hi = torch.argmax(cands_hi, dim=0, keepdim=True)
    return (torch.gather(cands_lo, 0, i_lo)[0], torch.gather(cands_hi, 0, i_hi)[0],
            torch.gather(grads, 0, i_lo)[0], torch.gather(grads, 0, i_hi)[0])


def _root_ok(valid, e, v):
    return valid & (0.0 <= e) & (e <= 1.0) & torch.isfinite(e) & torch.isfinite(v)


def joint_position_extrema(k, traj: TrajectoryCoeffs, cfg: ArmourConfig):
    """(q_min, q_max) [W, Q, F] over the trajectory and their dk gradients."""
    if traj.family == "armtd":
        from .armtd import armtd_position_extrema

        return armtd_position_extrema(k, traj, cfg)
    q0, Tqd0, TTqdd0, k_range = _traj(traj)
    k_act = k * k_range
    e2, e3, valid = bezier.q_extrema_in_k(Tqd0, TTqdd0, k_act)
    v0 = bezier.q_des(q0, Tqd0, TTqdd0, k_act, torch.zeros_like(k))
    v1 = bezier.q_des(q0, Tqd0, TTqdd0, k_act, torch.ones_like(k))
    v2 = bezier.q_des(q0, Tqd0, TTqdd0, k_act, e2)
    v3 = bezier.q_des(q0, Tqd0, TTqdd0, k_act, e3)

    def dq_dk(s):
        return s**3 * (6.0 * s**2 - 15.0 * s + 10.0)

    true = torch.ones_like(k, dtype=torch.bool)
    q_min, q_max, g_min, g_max = _select_extrema(
        torch.stack([v0, v1, v2, v3]),
        torch.stack([torch.zeros_like(k), torch.ones_like(k), dq_dk(e2), dq_dk(e3)]),
        torch.stack([true, true, _root_ok(valid, e2, v2), _root_ok(valid, e3, v3)]))
    return q_min, q_max, g_min * k_range, g_max * k_range


def joint_velocity_extrema(k, traj: TrajectoryCoeffs, cfg: ArmourConfig):
    """(qd_min, qd_max) [W, Q, F] in rad/s and their dk gradients."""
    if traj.family == "armtd":
        from .armtd import armtd_velocity_extrema

        return armtd_velocity_extrema(k, traj, cfg)
    q0, Tqd0, TTqdd0, k_range = _traj(traj)
    k_act = k * k_range
    dur = cfg.duration
    e2, e3, valid = bezier.qd_extrema_in_k(Tqd0, TTqdd0, k_act)
    v0 = bezier.qd_des(q0, Tqd0, TTqdd0, k_act, torch.zeros_like(k))
    v1 = bezier.qd_des(q0, Tqd0, TTqdd0, k_act, torch.ones_like(k))
    v2 = bezier.qd_des(q0, Tqd0, TTqdd0, k_act, e2)
    v3 = bezier.qd_des(q0, Tqd0, TTqdd0, k_act, e3)

    def dqd_dk(s):
        return 30.0 * s**2 * (s - 1.0) ** 2

    true = torch.ones_like(k, dtype=torch.bool)
    qd_min, qd_max, g_min, g_max = _select_extrema(
        torch.stack([v0, v1, v2, v3]),
        torch.stack([torch.zeros_like(k), torch.zeros_like(k), dqd_dk(e2), dqd_dk(e3)]),
        torch.stack([true, true, _root_ok(valid, e2, v2), _root_ok(valid, e3, v3)]))
    return (div(qd_min, dur), div(qd_max, dur), div(g_min * k_range, dur),
            div(g_max * k_range, dur))


# ---------------------------------------------------------------------------
# constraint assembly: one-sided c(k) <= 0 stack
# ---------------------------------------------------------------------------


def _torque(k_phi, prob: PlanProblem):
    """Nominal torque u [W, Q, T*F] at phi(k), and its limit [W, 1, T*F]."""
    Wn, T, F, B = prob.torque.u_coef.shape
    uc = prob.torque.u_coef.reshape(Wn, T * F, B)
    u = torch.matmul(k_phi, uc.transpose(1, 2))
    hi = (prob.limits.torque - prob.torque.torque_radius).reshape(Wn, 1, T * F)
    return u, hi, uc


def _grasp(k_phi, prob: PlanProblem):
    """The grasp rows g [W, Q, 3T] at phi(k) (row (t, sep / slip / tip)),
    and their coefficients [W, 3T, B]."""
    Wn, T, _, B = prob.grasp.g_coef.shape
    gc = prob.grasp.g_coef.reshape(Wn, 3 * T, B)
    return torch.matmul(k_phi, gc.transpose(1, 2)) + prob.grasp.g_rad.reshape(Wn, 1, 3 * T), gc


def constraint_stack(k, prob: PlanProblem, cfg: ArmourConfig, basis: KBasis,
                     with_grad: bool = True):
    """All inequality rows c [W, Q, M] and (optionally) the Jacobian
    [W, Q, M, F].  Ordering: [torque_hi; torque_lo; grasp (when the plan
    has them); collision; pos_min_lo; pos_min_hi; pos_max_lo; pos_max_hi;
    vel_min_lo; vel_min_hi; vel_max_lo; vel_max_hi]."""
    F = k.shape[-1]
    phi = basis.phi(k)
    dphi = basis.dphi(k) if with_grad else None
    ub = cfg.ub
    lim = prob.limits
    cs, Js = [], []

    if not cfg.turn_off_input_constraints:
        u, hi, uc = _torque(phi, prob)
        cs += [u - hi, -u - hi]
        if with_grad:
            du = torch.matmul(uc[:, None], dphi)                # [W, Q, T*F, F]
            Js += [du, -du]

    if prob.grasp is not None:
        g, gc = _grasp(phi, prob)
        cs.append(g)
        if with_grad:
            Js.append(torch.matmul(gc[:, None], dphi))

    p_all = eval_link_polys(prob.frs, phi)
    dp_all = eval_link_poly_grads(prob.frs, dphi) if with_grad else None
    tau = cfg.smooth_tau if cfg.smooth_obstacle_constraints else 0.0
    g_col, dg_col = screened_rows(prob.screened, p_all, dp_all, smooth_tau=tau)
    # plan with extra clearance; the certification (max_violations) stays exact
    cs.append(g_col + cfg.collision_search_margin)
    if with_grad:
        Js.append(dg_col)

    q_min, q_max, gq_min, gq_max = joint_position_extrema(k, prob.traj, cfg)
    qd_min, qd_max, gd_min, gd_max = joint_velocity_extrema(k, prob.traj, cfg)
    m = cfg.state_limit_margin
    pos_lb = lim.pos_lb + ub.qe + m
    pos_ub = lim.pos_ub - ub.qe - m
    vel_ub = lim.speed - ub.qde - m
    eye = torch.eye(F, dtype=k.dtype, device=k.device)
    for val, grad in ((q_min, gq_min), (q_max, gq_max)):
        cs += [pos_lb - val, val - pos_ub]
        if with_grad:
            Js += [-grad[..., None] * eye, grad[..., None] * eye]
    for val, grad in ((qd_min, gd_min), (qd_max, gd_max)):
        cs += [-vel_ub - val, val - vel_ub]
        if with_grad:
            Js += [-grad[..., None] * eye, grad[..., None] * eye]

    c = torch.cat(cs, dim=-1)
    if with_grad:
        return c, torch.cat(Js, dim=-2)
    return c, None


def maxima_plain(k, prob: PlanProblem, cfg: ArmourConfig, basis: KBasis, phi=None):
    """Plain version of kernel K8's max mode: the torque, state and grasp
    groups of max_violations, (v_torque, v_state, v_grasp) [W, Q] at k
    [W, Q, F]: max |u| - hi over the torque rows (-BIG without them), the
    max of the 8 F state rows against the untightened limits, and the max
    of the grasp rows (-BIG without them)."""
    ub = cfg.ub
    lim = prob.limits
    phi = basis.phi(k) if phi is None else phi
    none = torch.full(k.shape[:-1], -BIG, dtype=k.dtype, device=k.device)
    if cfg.turn_off_input_constraints:
        v_torque = none
    else:
        u, hi, _ = _torque(phi, prob)
        v_torque = torch.amax(torch.abs(u) - hi, dim=-1)
    v_grasp = none if prob.grasp is None else torch.amax(_grasp(phi, prob)[0], dim=-1)
    q_min, q_max, _, _ = joint_position_extrema(k, prob.traj, cfg)
    qd_min, qd_max, _, _ = joint_velocity_extrema(k, prob.traj, cfg)
    pos_lb = lim.pos_lb + ub.qe
    pos_ub = lim.pos_ub - ub.qe
    vel_ub = lim.speed - ub.qde
    v_state = torch.amax(torch.stack([
        torch.amax(pos_lb - q_min, dim=-1), torch.amax(q_min - pos_ub, dim=-1),
        torch.amax(pos_lb - q_max, dim=-1), torch.amax(q_max - pos_ub, dim=-1),
        torch.amax(-vel_ub - qd_min, dim=-1), torch.amax(qd_min - vel_ub, dim=-1),
        torch.amax(-vel_ub - qd_max, dim=-1), torch.amax(qd_max - vel_ub, dim=-1),
    ]), dim=0)
    return v_torque, v_state, v_grasp


def max_violations(k, prob: PlanProblem, cfg: ArmourConfig, basis: KBasis,
                   *, collision_fn=collision_constraints, rows=None):
    """Per-group max violations (torque, collision, state, grasp), each
    [W, Q], over the FULL constraint set.  collision_fn evaluates every
    collision row; the default routes through kernel K4 on the card.  With
    rows (kernels.solver.alm_rows of this plan, CUDA tensors) the torque,
    state and grasp maxima come from kernel K8's max mode, else from
    maxima_plain."""
    phi = basis.phi(k)
    g_col = collision_fn(prob.hyp, prob.obs, eval_link_polys(prob.frs, phi))
    v_col = torch.amax(g_col.reshape(*k.shape[:-1], -1), dim=-1)
    if rows is not None:
        from .kernels import solver as ksolver

        v_torque, v_state, v_grasp = ksolver.alm_maxima(rows, k)
    else:
        v_torque, v_state, v_grasp = maxima_plain(k, prob, cfg, basis, phi)
    return v_torque, v_col, v_state, v_grasp


def viol_thresholds(cfg: ArmourConfig) -> tuple:
    """The finalize check's thresholds (torque, collision, state, grasp)."""
    return (cfg.torque_violation_threshold, cfg.collision_violation_threshold, 1e-6,
            cfg.grasp_violation_threshold)


def _viol_ok(v, thresholds):
    t_torque, t_col, t_state, t_grasp = thresholds
    return ((v[..., 0] <= t_torque) & (v[..., 1] <= t_col) & (v[..., 2] <= t_state)
            & (v[..., 3] <= t_grasp))


def viol_feasible(v, cfg: ArmourConfig):
    """Feasibility of stacked violations v [..., 4] against the thresholds
    of the finalize check."""
    return _viol_ok(v, viol_thresholds(cfg))


# ---------------------------------------------------------------------------
# augmented-Lagrangian solver with projected Gauss-Newton inner steps
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SolveResult:
    """k [W, F] (NaN when infeasible), feasible [W], cost [W] and the
    per-group violations [W, 4] (torque, collision, state, grasp)."""

    k: torch.Tensor
    feasible: torch.Tensor
    cost: torch.Tensor
    viol: torch.Tensor


def _stack_thresholds(prob: PlanProblem, cfg: ArmourConfig) -> torch.Tensor:
    """Per-row violation thresholds in constraint_stack's order [M]."""
    dt, dev = prob.q_des.dtype, prob.q_des.device
    F = prob.q_des.shape[-1]
    parts = []
    if not cfg.turn_off_input_constraints:
        T = prob.torque.u_coef.shape[1]
        parts.append(torch.full((2 * T * F,), cfg.torque_violation_threshold, dtype=dt, device=dev))
    if prob.grasp is not None:
        Tg = prob.grasp.g_coef.shape[1]
        parts.append(torch.full((3 * Tg,), cfg.grasp_violation_threshold, dtype=dt, device=dev))
    K = prob.screened.row.shape[-1]
    parts.append(torch.full((K,), cfg.collision_violation_threshold, dtype=dt, device=dev))
    # state rows are margin-tightened: accepting margin/2 against them
    # leaves margin/2 slack against the true limits
    parts.append(torch.full((8 * F,), 0.5 * cfg.state_limit_margin, dtype=dt, device=dev))
    return torch.cat(parts)


def _take(x, idx):
    """x [W, S, ...] at seed indices idx [W, S']."""
    return torch.gather(x, 1, idx.reshape(*idx.shape, *([1] * (x.dim() - 2)))
                        .expand(*idx.shape, *x.shape[2:]))


def is_feasible(k, prob: PlanProblem, cfg: ArmourConfig, basis: KBasis):
    """Full-set feasibility of k [W, Q, F]: [W, Q] bool
    (armour_tpu/nlp.py:305-313)."""
    return viol_feasible(torch.stack(max_violations(k, prob, cfg, basis), dim=-1), cfg)


# ---------------------------------------------------------------------------
# the solver's row evaluation: plain versions and the K7 / K8 dispatch
# ---------------------------------------------------------------------------


def _clip_big(c):
    # padded/degenerate rows sit at -BIG; keep them inert
    return torch.clamp(c, min=-1e6)


def _penalty(c, lam, rho):
    z = lam + rho[..., None] * c
    return torch.sum(torch.where(z > 0, z * z, torch.zeros_like(z)), dim=-1) / (2 * rho)


def alm_newton_system(k, lam, rho, prob: PlanProblem, cfg: ArmourConfig, basis: KBasis):
    """The Gauss-Newton system of one inner step (armour_tpu/nlp.py:475-489):
    (g [W,S,F], H [W,S,F,F], clipped c [W,S,M]) at the seeds k [W,S,F] with
    multipliers lam [W,S,M] and penalties rho [W,S]."""
    F = k.shape[-1]
    c, Jc = constraint_stack(k, prob, cfg, basis, with_grad=True)
    c = _clip_big(c)
    z = lam + rho[..., None] * c
    act = z > 0.0                                           # active set
    w = torch.where(act, rho[..., None], torch.zeros_like(c))
    lam_eff = torch.where(act, z, torch.zeros_like(c))
    JcT = Jc.transpose(-1, -2)
    g = (plan_cost_grad(k, prob.traj, prob.q_des, prob.limits.continuous, cfg)
         + torch.matmul(JcT, lam_eff[..., None])[..., 0])
    H = (torch.matmul(JcT * w[..., None, :], Jc) + plan_cost_hessian(prob.traj, cfg)
         + 1e-3 * torch.eye(F, dtype=k.dtype, device=k.device))
    return g, H, c


def newton_step(H, g):
    """H^-1 g [..., F] by Cholesky, NaN in every entry where the
    factorisation fails (a pivot <= 0 or NaN: H is SPD in exact arithmetic,
    but a float32 H whose rows carry rho up to 1e6 can lose the 1e-3
    regulariser), as jax.scipy.linalg.cho_factor / cho_solve give it; the
    line search then meets NaN merits and keeps its iterate.  LAPACK's
    partial factor would give a finite step from the failed pivot on."""
    L, info = torch.linalg.cholesky_ex(H)
    step = torch.cholesky_solve(g[..., None], L)[..., 0]
    return torch.where((info == 0)[..., None], step, torch.full_like(step, math.nan))


def alm_newton_plain(k, lam, rho, prob: PlanProblem, cfg: ArmourConfig, basis: KBasis):
    """Plain version of kernel K7: (step [W,S,F], m0 [W,S], feas [W,S],
    cost [W,S]).  step = H^-1 g by Cholesky (H is SPD), m0 = cost + penalty,
    feas = every clipped row within its threshold, cost = plan_cost at k."""
    g, H, c = alm_newton_system(k, lam, rho, prob, cfg, basis)
    step = newton_step(H, g)
    cost = plan_cost(k, prob.traj, prob.q_des, prob.limits.continuous, cfg)
    m0 = cost + _penalty(c, lam, rho)
    feas = torch.all(c <= _stack_thresholds(prob, cfg), dim=-1)
    return step, m0, feas, cost


def alm_values_plain(kq, lam, rho, seed_of_q, prob: PlanProblem, cfg: ArmourConfig,
                     basis: KBasis, want_c: bool = False):
    """Plain version of kernel K8: (merit [W,Q], feas [W,Q], cost [W,Q],
    clipped c [W,Q,M] or None) at the query points kq [W,Q,F]; query q takes
    the lam [W,S,M] and rho [W,S] of seed seed_of_q[q]."""
    c = _clip_big(constraint_stack(kq, prob, cfg, basis, with_grad=False)[0])
    idx = seed_of_q.to(device=kq.device, dtype=torch.int64)
    cost = plan_cost(kq, prob.traj, prob.q_des, prob.limits.continuous, cfg)
    merit = cost + _penalty(c, lam[:, idx], rho[:, idx])
    feas = torch.all(c <= _stack_thresholds(prob, cfg), dim=-1)
    return merit, feas, cost, (c if want_c else None)


def alm_newton(k, lam, rho, prob: PlanProblem, cfg: ArmourConfig, basis: KBasis, rows=None,
               epi=None):
    """One inner step's (step, m0, feas, cost): kernel K7 on CUDA tensors
    (rows: kernels.solver.alm_rows of this plan, built when not given; epi:
    the loop's ladder for K7's finish, a kernels.solver.Epilogue, or None),
    alm_newton_plain on CPU tensors."""
    if not k.is_cuda:
        _no_epilogue(epi)
        return alm_newton_plain(k, lam, rho, prob, cfg, basis)
    from .kernels import solver as ksolver

    return ksolver.alm_newton(rows or ksolver.alm_rows(prob, cfg, basis), k, lam, rho, epi=epi)


def alm_values(kq, lam, rho, seed_of_q, prob: PlanProblem, cfg: ArmourConfig, basis: KBasis,
               want_c: bool = False, rows=None, epi=None):
    """(merit, feas, cost, c or None) of query points: kernel K8 on CUDA
    tensors (epi: a phase of the loop for K8's finish, a
    kernels.solver.Epilogue, or None), alm_values_plain on CPU tensors."""
    if not kq.is_cuda:
        _no_epilogue(epi)
        return alm_values_plain(kq, lam, rho, seed_of_q, prob, cfg, basis, want_c)
    from .kernels import solver as ksolver

    return ksolver.alm_values(rows or ksolver.alm_rows(prob, cfg, basis), kq, lam, rho,
                              seed_of_q, want_c, epi=epi)


def _no_epilogue(epi) -> None:
    if epi is not None:
        raise ValueError("only the kernels K7 / K8 run a phase of the loop in their finish")


# ---------------------------------------------------------------------------
# the solve loop's bookkeeping: plain versions of kernel K14 (alm_loop)
# ---------------------------------------------------------------------------
#
# Each phase is a function of plain tensors between two row evaluations
# (armour_tpu/nlp.py:427-600): a best-feasible tracker (best_k [W,S,F],
# best_cost [W,S]) folds in every evaluated point with the feasibility and
# cost its row pass gave.  Outputs are new tensors; inputs are not changed.


def _track(kk, feas, cost, best_k, best_cost):
    better = feas & (cost < best_cost)
    return (torch.where(better[..., None], kk, best_k), torch.where(better, cost, best_cost))


def alm_init_plain(k, feas, cost):
    """The tracker at the starts k [W,S,F] (armour_tpu/nlp.py:455-467): a
    feasible start seeds it.  Returns (best_k, best_cost)."""
    return k, torch.where(feas, cost, torch.full_like(cost, math.inf))


def alm_ladder_plain(k, step, feas, cost, best_k, best_cost, alphas):
    """After K7 (armour_tpu/nlp.py:491-509): fold the iterate k [W,S,F]
    into the tracker with its feas and cost, then the line search's query
    block clamp(k - alpha step, -1, 1) [W, S*A, F], alpha by alpha within a
    seed.  alphas: cfg.solver_alphas.  Returns (kq, best_k, best_cost)."""
    best_k, best_cost = _track(k, feas, cost, best_k, best_cost)
    Wn, S, F = k.shape
    al = _table(alphas, k.dtype, k.device)
    kq = torch.clamp(k[:, :, None] - al[:, None] * step[:, :, None], -1.0, 1.0)
    return kq.reshape(Wn, S * len(alphas), F), best_k, best_cost


def alm_accept_plain(k, m0, kq, merit, feas, cost, best_k, best_cost):
    """After K8 on the ladder (armour_tpu/nlp.py:510-516): fold the A
    candidates of each seed into the tracker in alpha order, then take the
    first candidate of least merit (NaN first, as torch.argmin) when it is
    below m0.  kq, merit, feas, cost: [W, S*A, ...].  Returns (k, best_k,
    best_cost)."""
    Wn, S, F = k.shape
    A = kq.shape[1] // S
    kks = kq.reshape(Wn, S, A, F)
    merits, feas, cost = (x.reshape(Wn, S, A) for x in (merit, feas, cost))
    for a in range(A):
        best_k, best_cost = _track(kks[:, :, a], feas[:, :, a], cost[:, :, a], best_k, best_cost)
    best = torch.argmin(merits, dim=-1, keepdim=True)          # [W, S, 1]
    m_best = torch.gather(merits, -1, best)[..., 0]
    k_best = torch.gather(kks, 2, best[..., None].expand(Wn, S, 1, F))[:, :, 0]
    return torch.where((m_best < m0)[..., None], k_best, k), best_k, best_cost


def alm_outer_plain(k, feas, cost, c, lam, rho, best_k, best_cost):
    """After K8 at the outer iterate (armour_tpu/nlp.py:518-532): fold k
    into the tracker, lam = max(lam + rho c, 0), rho = min(2 rho, 1e6).
    Returns (lam, rho, best_k, best_cost)."""
    best_k, best_cost = _track(k, feas, cost, best_k, best_cost)
    return (torch.clamp(lam + rho[..., None] * c, min=0.0), torch.clamp(rho * 2.0, max=1e6),
            best_k, best_cost)


def alm_cull_plain(k, lam, rho, best_k, best_cost, v, cost, keep: int):
    """The cull (armour_tpu/nlp.py:405-412,536-543): feasible seeds rank by
    their best cost, the others behind them by 1e6 + v + cost (v: the
    summed row violations [W,S], cost at k); the `keep` first in a stable
    ascending order (NaN last) carry on.  Returns the kept (k, lam, rho,
    best_k, best_cost)."""
    score = torch.where(torch.isfinite(best_cost), best_cost, 1e6 + v + cost)
    idx = torch.argsort(score, dim=-1, stable=True)[:, :keep]
    return tuple(_take(x, idx) for x in (k, lam, rho, best_k, best_cost))


def alm_pull_start_plain(k, best_k, best_cost):
    """The pull-in's bracket (armour_tpu/nlp.py:562-575): lo = best_k where
    the tracker holds a point, else k; hi = k.  Returns (lo, hi, mid)."""
    lo = torch.where(torch.isfinite(best_cost)[..., None], best_k, k)
    return lo, k, 0.5 * (lo + k)


def alm_pull_step_plain(lo, hi, mid, ok):
    """One bisection step on K8's feasibility ok [W,S] of mid.  Returns
    (lo, hi, mid)."""
    lo, hi = torch.where(ok[..., None], mid, lo), torch.where(ok[..., None], hi, mid)
    return lo, hi, 0.5 * (lo + hi)


def alm_pull_end_plain(k, lo, mid, ok, end_feas, best_cost):
    """The last bisection step, then k_pull: the bracket's feasible end
    where k ended infeasible (end_feas) and the tracker holds a point, else
    k."""
    lo = torch.where(ok[..., None], mid, lo)
    return torch.where((~end_feas & torch.isfinite(best_cost))[..., None], lo, k)


def alm_finish_plain(k, k_pull, feas, cost, best_k, best_cost):
    """Fold k_pull into the tracker; returns ([k, best_k] [W,2S,F] for the
    full-set check, best_cost)."""
    best_k, best_cost = _track(k_pull, feas, cost, best_k, best_cost)
    return torch.cat([k, best_k], dim=1), best_cost


def alm_select_plain(kb, v, best_cost, cost_final, thresholds):
    """The result (armour_tpu/nlp.py:586-600 and the best start, :403-416):
    per seed the final or the best iterate by the full-set violations v
    [W,2S,4] of kb = [k, best_k] ([W,2S,F]), NaN k when neither is
    feasible; then per world the feasible seed of least cost, else the seed
    of least cost (torch.argmin: NaN first, then the lower index).
    thresholds: (torque, collision, state, grasp).  Returns (k [W,F],
    feasible [W], cost [W], viol [W,4])."""
    S = kb.shape[1] // 2
    k, best_k, v_final, v_best = kb[:, :S], kb[:, S:], v[:, :S], v[:, S:]
    feas_final = _viol_ok(v_final, thresholds)
    feas_best = _viol_ok(v_best, thresholds) & torch.isfinite(best_cost)
    use_best = feas_best & ((~feas_final) | (best_cost < cost_final))
    feasible = feas_final | feas_best
    k_sel = torch.where(use_best[..., None], best_k, k)
    k_sel = torch.where(feasible[..., None], k_sel, torch.full_like(k_sel, math.nan))
    cost = torch.where(use_best, best_cost, cost_final)
    viol = torch.where(use_best[..., None], v_best, v_final)
    cost_rank = torch.where(feasible, cost, torch.full_like(cost, math.inf))
    i = torch.where(torch.any(feasible, dim=-1), torch.argmin(cost_rank, dim=-1),
                    torch.argmin(cost, dim=-1))[:, None]       # [W, 1]
    return (_take(k_sel, i)[:, 0], _take(feasible, i)[:, 0], _take(cost, i)[:, 0],
            _take(viol, i)[:, 0])


PLAIN_LOOP = types.SimpleNamespace(
    init=alm_init_plain, ladder=alm_ladder_plain, accept=alm_accept_plain,
    outer=alm_outer_plain, cull=alm_cull_plain, pull_start=alm_pull_start_plain,
    pull_step=alm_pull_step_plain, pull_end=alm_pull_end_plain, finish=alm_finish_plain,
    select=alm_select_plain)

_TABLES = {}


def _table(values, dtype, device) -> torch.Tensor:
    """A constant table (the alphas, a seed index) on `device`, formed once
    per values, dtype and device: the solve loop copies nothing to the card
    after its first solve."""
    key = (tuple(values), dtype, torch.device(device))
    t = _TABLES.get(key)
    if t is None:
        t = torch.tensor(list(values), dtype=dtype).to(device, non_blocking=True)
        _TABLES[key] = t
    return t


def _seed_index(S: int, per_seed: int, device) -> torch.Tensor:
    """seed_of_q for S seeds with per_seed consecutive queries each."""
    return _table([s for s in range(S) for _ in range(per_seed)], torch.int32, device)


def solve(prob: PlanProblem, cfg: ArmourConfig, basis: KBasis, k0=None,
          *, plain: bool = False, eager: bool = False) -> SolveResult:
    """Multi-start ALM solve for every world.  Seeds: k=0, the
    waypoint-directed k and +-0.5 of it; the best feasible result wins.
    On the card the rows are kernels K7 / K8 and the bookkeeping between
    them kernel K14, most of its phases run by K7's / K8's finish.
    plain=True takes the plain versions of all three on any device (the
    reference the kernels are held against); eager=True keeps K7 / K8 and
    takes the plain bookkeeping after each of their calls."""
    dt, dev = prob.q_des.dtype, prob.q_des.device
    Wn, F = prob.q_des.shape

    if k0 is None:
        diff = prob.q_des - prob.traj.q0
        diff = torch.where(prob.limits.continuous, wrap_to_pi(diff), diff)
        k_wp = torch.clamp(diff / prob.traj.k_scale, -1.0, 1.0)
        seeds = [torch.zeros_like(k_wp), k_wp, 0.5 * k_wp, -0.5 * k_wp]
        n_seeds = max(1, cfg.solver_seeds)
        if n_seeds > len(seeds):
            extra = [(0.25 + 0.75 * j / max(1, n_seeds - len(seeds)))
                     * (-1.0 if j % 2 else 1.0) * k_wp
                     for j in range(n_seeds - len(seeds))]
            seeds = seeds + extra
        seeds = torch.stack(seeds[:n_seeds], dim=1)             # [W, S, F]
    else:
        seeds = torch.as_tensor(k0, dtype=dt, device=dev).reshape(Wn, 1, F)

    n_seeds = seeds.shape[1]
    cull_after = int(cfg.solver_cull_after)
    keep = int(cfg.solver_keep_seeds)
    init, run_outer, finalize, cull = _alm_phases(prob, cfg, basis, plain=plain, eager=eager)

    carry = init(seeds)
    if 0 < cull_after < cfg.solver_outer_iters and 0 < keep < n_seeds:
        # phase A on all seeds, keep the most promising, phase B on those
        carry = run_outer(carry, cull_after)
        carry = cull(carry, keep)
        carry = run_outer(carry, cfg.solver_outer_iters - cull_after)
    else:
        carry = run_outer(carry, cfg.solver_outer_iters)
    k, feasible, cost, viol = finalize(carry)
    return SolveResult(k=k, feasible=feasible, cost=cost, viol=viol)


def loop_pairs(newton, values, book, alphas, epilogue=None):
    """The solve loop's steps, each one row pass (newton: K7 or its plain
    version; values: K8 or its plain version; both take epi=) and the phase
    of the loop it feeds.  Without `epilogue` the book's phase runs after
    the pass.  With it (kernels/solver.py:epilogue bound to a plan and its
    alphas), the pass's finish runs the phase (kernel K14's phases in K7 /
    K8) and the book is not called; both give the same bits.  Each step
    takes the row pass's query points and multipliers first."""
    A = len(alphas)

    def ident(k):
        return _seed_index(k.shape[1], 1, k.device)

    def fuse(phase, *args, **vals):
        return None if epilogue is None else epilogue(phase, *args, **vals)

    def init(k, lam, rho):
        epi = fuse("init", k, lam, rho)
        _, feas, cost, _ = values(k, lam, rho, ident(k), epi=epi)
        # a feasible start (k=0 is the rest plan) seeds the best tracker
        return epi.out if epi else book.init(k, feas, cost)

    def ladder(k, lam, rho, best_k, best_cost):
        epi = fuse("ladder", k, lam, rho, best_k=best_k, best_cost=best_cost)
        step, m0, feas, cost = newton(k, lam, rho, epi=epi)
        # geometric backtracking ladder, all alphas in one values pass;
        # every line-search candidate is also a best-feasible candidate
        return (m0,) + tuple(epi.out if epi else
                             book.ladder(k, step, feas, cost, best_k, best_cost, alphas))

    def accept(kq, lam, rho, k, m0, best_k, best_cost):
        epi = fuse("accept", kq, lam, rho, k=k, m0=m0, best_k=best_k, best_cost=best_cost)
        merit, feas, cost, _ = values(kq, lam, rho, _seed_index(k.shape[1], A, k.device), epi=epi)
        return epi.out if epi else book.accept(k, m0, kq, merit, feas, cost, best_k, best_cost)

    def outer(k, lam, rho, best_k, best_cost):
        # proxy feasibility on the screened stack; the winner is re-checked
        # against the full set in finalize.  In K8 the multipliers are
        # updated where each row is formed: no c is written
        epi = fuse("outer", k, lam, rho, best_k=best_k, best_cost=best_cost)
        _, feas, cost, c = values(k, lam, rho, ident(k), want_c=not epi, epi=epi)
        return epi.out if epi else book.outer(k, feas, cost, c, lam, rho, best_k, best_cost)

    def pull_start(k, lam, rho, best_k, best_cost):
        epi = fuse("pull_start", k, lam, rho, best_k=best_k, best_cost=best_cost)
        _, end_feas, cost_final, _ = values(k, lam, rho, ident(k), epi=epi)
        return (end_feas, cost_final) + tuple(epi.out if epi else
                                              book.pull_start(k, best_k, best_cost))

    def pull_step(mid, lam, rho, lo, hi):
        epi = fuse("pull_step", mid, lam, rho, lo=lo, hi=hi)
        ok = values(mid, lam, rho, ident(mid), epi=epi)[1]
        return epi.out if epi else book.pull_step(lo, hi, mid, ok)

    def pull_end(mid, lam, rho, k, lo, end_feas, best_cost):
        epi = fuse("pull_end", mid, lam, rho, k=k, lo=lo, end_feas=end_feas, best_cost=best_cost)
        ok = values(mid, lam, rho, ident(mid), epi=epi)[1]
        return epi.out[0] if epi else book.pull_end(k, lo, mid, ok, end_feas, best_cost)

    def finish(k_pull, lam, rho, k, best_k, best_cost):
        epi = fuse("finish", k_pull, lam, rho, k=k, best_k=best_k, best_cost=best_cost)
        _, feas, cost, _ = values(k_pull, lam, rho, ident(k_pull), epi=epi)
        return epi.out if epi else book.finish(k, k_pull, feas, cost, best_k, best_cost)

    return types.SimpleNamespace(init=init, ladder=ladder, accept=accept, outer=outer,
                                 pull_start=pull_start, pull_step=pull_step, pull_end=pull_end,
                                 finish=finish)


def _alm_phases(prob: PlanProblem, cfg: ArmourConfig, basis: KBasis, plain: bool = False,
                eager: bool = False):
    """The ALM descent as (init, run_outer, finalize, cull) over a carry
    (k, lam, rho, best_k, best_cost) of [W, S, ...] tensors.  Every row
    evaluation is one newton (K7) or values (K8) pass, every step between
    two of them one phase of the loop's book (loop_pairs).  On the card
    (kernel K14) the phase runs in the finish of the K7 / K8 call that
    feeds it (loop_pairs with kernels/solver.py:epilogue), but the cull and the final
    selection, which launch K14 after their torch reductions; on the CPU,
    or when asked, the plain versions above run after each row pass.  On
    the card no constraint stack or Jacobian is formed and, between the
    first row pass and the full-set check, no torch op runs but the cull's
    violation sum."""
    dt, dev = prob.q_des.dtype, prob.q_des.device
    thr = _stack_thresholds(prob, cfg)
    M = thr.shape[0]
    alphas = tuple(cfg.solver_alphas)
    kernel_rows = dev.type == "cuda" and not plain
    rows = None
    if kernel_rows:
        from .kernels import solver as ksolver

        rows = ksolver.alm_rows(prob, cfg, basis)

    def newton(k, lam, rho, epi=None):
        if plain:
            return alm_newton_plain(k, lam, rho, prob, cfg, basis)
        return alm_newton(k, lam, rho, prob, cfg, basis, rows, epi)

    def values(kq, lam, rho, seed_of_q, want_c=False, epi=None):
        if plain:
            return alm_values_plain(kq, lam, rho, seed_of_q, prob, cfg, basis, want_c)
        return alm_values(kq, lam, rho, seed_of_q, prob, cfg, basis, want_c, rows, epi)

    if kernel_rows and not eager:
        book = ksolver.LOOP
        steps = loop_pairs(newton, values, book, alphas,
                           functools.partial(ksolver.epilogue, rows, alphas))
    else:
        book = PLAIN_LOOP
        steps = loop_pairs(newton, values, book, alphas)

    def init(k):
        Wn, S = k.shape[:2]
        lam = torch.zeros(Wn, S, M, dtype=dt, device=dev)
        rho = torch.full((Wn, S), 10.0, dtype=dt, device=dev)
        best_k, best_cost = steps.init(k, lam, rho)
        return (k, lam, rho, best_k, best_cost)

    def run_outer(carry, n: int):
        k, lam, rho, best_k, best_cost = carry
        for _ in range(n):
            for _ in range(cfg.solver_inner_iters):
                m0, kq, best_k, best_cost = steps.ladder(k, lam, rho, best_k, best_cost)
                k, best_k, best_cost = steps.accept(kq, lam, rho, k, m0, best_k, best_cost)
            lam, rho, best_k, best_cost = steps.outer(k, lam, rho, best_k, best_cost)
        return (k, lam, rho, best_k, best_cost)

    def cull(carry, keep: int):
        """Feasible seeds rank by best cost, infeasible ones behind them by
        total violation; the sum over the rows stays a torch reduction."""
        k, lam, rho, best_k, best_cost = carry
        _, _, cost, c = values(k, lam, rho, _seed_index(k.shape[1], 1, dev), want_c=True)
        v = torch.sum(torch.clamp(c - thr, min=0.0), dim=-1)
        return book.cull(k, lam, rho, best_k, best_cost, v, cost, keep)

    def finalize(carry):
        k, lam, rho, best_k, best_cost = carry
        # feasibility pull-in: bisect along [best_k, k] for the deepest
        # feasible point when the ALM ends epsilon outside the feasible set
        end_feas, cost_final, lo, hi, mid = steps.pull_start(k, lam, rho, best_k, best_cost)
        for _ in range(5):
            lo, hi, mid = steps.pull_step(mid, lam, rho, lo, hi)
        k_pull = steps.pull_end(mid, lam, rho, k, lo, end_feas, best_cost)
        kb, best_cost = steps.finish(k_pull, lam, rho, k, best_k, best_cost)

        # one full-set check for the final and the best iterate of every seed
        v = torch.stack(max_violations(kb, prob, cfg, basis, rows=rows), dim=-1)  # [W, 2S, 4]
        return book.select(kb, v, best_cost, cost_final, viol_thresholds(cfg))

    return init, run_outer, finalize, cull

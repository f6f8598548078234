"""ARMTD comparison planner: the constant-acceleration trajectory family
(counterpart of armour_tpu/armtd.py).

The trajectory accelerates at k for t in [0, t_plan], then brakes to rest
at t_stop = duration:

    phase 1 (t <= tp):  q = q0 + qd0 t + 1/2 k t^2
    phase 2 (t > tp):   q = q_pk + qd_pk tau - 1/2 (qd_pk / (ts - tp)) tau^2,
                        tau = t - tp,  qd_pk = qd0 + k tp

k ranges over +- g_k, g_k = min(max(pi/24, |qd0|/3), pi/3).  q(t; k) and its
derivatives are affine in k with piecewise-quadratic time coefficients, so
the sets of every sub-interval are bounded from its endpoints.  Everything
downstream (PZ FK / RNEA, collision, the solver) is the Bernstein family's.

Every tensor carries the world axis W in front: q0, qd0 [W, F] -> JRS
fields [W, T, ...].  build_jrs_armtd is kernel K11 (csrc/jrs_armtd.cu) on
CUDA tensors and build_jrs_armtd_plain on CPU tensors.
"""

from __future__ import annotations

import math

import torch

from .config import ArmourConfig
from .jrs import JRS, TrajectoryCoeffs, assemble_rotations, make_velocity_pz, trig_taylor_pz
from .nlp import _select_extrema
from .pz.basis import KBasis
from .robot import RobotModel
from .utils import div

PI = math.pi


def g_k_adaptive(qd0):
    """Velocity-adaptive parameter range min(max(pi/24, |qd0|/3), pi/3)."""
    return torch.clamp(div(torch.abs(qd0), 3.0), min=PI / 24, max=PI / 3.0)


def _phase_coeffs(t, qd0, tp, ts):
    """(a, b) with q(t; k) = q0 + a(t) + b(t) k.  t [T, 1], qd0 [W, 1, F]."""
    tau = t - tp
    brk = 1.0 / (ts - tp)
    a1 = qd0 * t
    b1 = 0.5 * t * t
    a2 = qd0 * tp + qd0 * tau - 0.5 * qd0 * brk * tau * tau
    b2 = 0.5 * tp * tp + tp * tau - 0.5 * tp * brk * tau * tau
    ph2 = t > tp
    return torch.where(ph2, a2, a1), torch.where(ph2, b2, b1)


def _phase_vel(t, qd0, tp, ts):
    """(a', b'): qd = a'(t) + b'(t) k."""
    tau = t - tp
    brk = 1.0 / (ts - tp)
    a1 = qd0 + 0.0 * t
    b1 = t
    a2 = qd0 * (1.0 - brk * tau)
    b2 = tp * (1.0 - brk * tau)
    ph2 = t > tp
    return torch.where(ph2, a2, a1), torch.where(ph2, b2, b1)


def _phase_acc(t, qd0, tp, ts):
    tau0 = torch.zeros_like(t)
    brk = 1.0 / (ts - tp)
    ph2 = t > tp
    a = torch.where(ph2, -qd0 * brk, tau0)
    b = torch.where(ph2, -tp * brk + tau0, 1.0 + tau0)
    return a, b


def _bounds(fn, t1, t2, qd0, tp, ts):
    """Per-sub-interval (lo, hi) of fn's a and b from the endpoints: both are
    monotone within a phase and sub-intervals never straddle t_plan."""
    a_lo, b_lo = fn(t1, qd0, tp, ts)
    a_hi, b_hi = fn(t2, qd0, tp, ts)
    return (torch.minimum(a_lo, a_hi), torch.maximum(a_lo, a_hi),
            torch.minimum(b_lo, b_hi), torch.maximum(b_lo, b_hi))


def build_jrs_armtd_plain(q0, qd0, robot: RobotModel, cfg: ArmourConfig,
                          basis: KBasis) -> JRS:
    """Plain version of kernel K11: the online JRS of the constant-
    acceleration family for q0 / qd0 [W, F].  The time grid spans [0,
    duration]; T is even, so the phase boundary at t_plan lies on the grid."""
    dt, dev = q0.dtype, q0.device
    T = cfg.num_time_steps
    ub = cfg.ub
    tp, ts = cfg.t_plan, cfg.duration
    gk = g_k_adaptive(qd0)                                   # [W, F]
    q0b, qd0b, gkb = q0[:, None], qd0[:, None], gk[:, None]  # [W, 1, F]

    step = ts / T
    t1 = (torch.arange(T, dtype=dt, device=dev) * step)[:, None]   # [T, 1]
    t2 = t1 + step

    a1, a2, b1, b2 = _bounds(_phase_coeffs, t1, t2, qd0b, tp, ts)
    qc = q0b + (a1 + a2) * 0.5
    Rq = (a2 - a1) * 0.5 + (b2 - b1) * 0.5 * gkb + ub.qe
    kd_scaled = (b1 + b2) * 0.5 * gkb
    cos_c, cos_k, cos_e, sin_c, sin_k, sin_e = trig_taylor_pz(qc, Rq, kd_scaled)

    va1, va2, vb1, vb2 = _bounds(_phase_vel, t1, t2, qd0b, tp, ts)
    qd_center = (va1 + va2) * 0.5
    vd_center = (vb1 + vb2) * 0.5 * gkb
    v_rad = (va2 - va1) * 0.5 + (vb2 - vb1) * 0.5 * gkb

    # open at the phase boundary; in float32 t_plan + 1e-9 == t_plan, so the
    # sub-interval that starts there takes in both phases' accelerations
    aa1, aa2, ab1, ab2 = _bounds(_phase_acc, t1 + 1e-9, t2, qd0b, tp, ts)
    qdd_center = (aa1 + aa2) * 0.5
    ad_center = (ab1 + ab2) * 0.5 * gkb
    a_rad = (aa2 - aa1) * 0.5 + (ab2 - ab1) * 0.5 * gkb

    qd_pz = make_velocity_pz(qd_center, vd_center, v_rad + ub.qde, "qde", basis)
    qda_pz = make_velocity_pz(qd_center, vd_center, v_rad + ub.qdae, "qdae", basis)
    qdda_pz = make_velocity_pz(qdd_center, ad_center, a_rad + ub.qddae, "qddae", basis)
    R, Rt = assemble_rotations(robot, cos_c, cos_k, cos_e, sin_c, sin_k, sin_e, basis)
    zeros = torch.zeros_like(q0)
    traj = TrajectoryCoeffs(q0=q0, qd0=qd0, qdd0=zeros, Tqd0=qd0 * ts, TTqdd0=zeros,
                            k_scale=gk, family="armtd")
    return JRS(R=R, Rt=Rt, qd=qd_pz, qda=qda_pz, qdda=qdda_pz, traj=traj)


def build_jrs_armtd(q0, qd0, robot: RobotModel, cfg: ArmourConfig, basis: KBasis) -> JRS:
    """The constant-acceleration JRS for q0 / qd0 [W, F]: kernel K11 on CUDA
    tensors, build_jrs_armtd_plain on CPU tensors."""
    if not q0.is_cuda:
        return build_jrs_armtd_plain(q0, qd0, robot, cfg, basis)
    from .kernels import jrs as kjrs

    return kjrs.jrs_armtd(q0, qd0, robot, cfg, basis)


# --- state-limit extrema of the constant-acceleration family ----------------


def armtd_position_extrema(k, traj: TrajectoryCoeffs, cfg: ArmourConfig):
    """(q_min, q_max) [W, Q, F] over the trajectory at k [W, Q, F] and their
    dk gradients: the values at 0, t_plan and t_stop, and at the interior
    vertex t* = -qd0 / k of phase 1 where it lies in (0, t_plan)."""
    tp, ts = cfg.t_plan, cfg.duration
    k_scale = traj.k_scale[:, None]
    k_act = k * k_scale
    q0, qd0 = traj.q0[:, None], traj.qd0[:, None]
    qd_pk = qd0 + k_act * tp

    v0 = q0.expand_as(k)
    v_tp = q0 + qd0 * tp + 0.5 * k_act * tp * tp
    v_ts = v_tp + 0.5 * qd_pk * (ts - tp)
    nonzero = torch.abs(k_act) > 1e-12
    tstar = torch.where(nonzero, -qd0 / torch.where(nonzero, k_act, torch.ones_like(k_act)),
                        torch.full_like(k_act, -1.0))
    v_star = q0 + qd0 * tstar + 0.5 * k_act * tstar * tstar
    inside = (0.0 < tstar) & (tstar < tp)

    z = torch.zeros_like(k)
    true = torch.ones_like(k, dtype=torch.bool)
    # d(value) / d(k_act): b(t) at each candidate (the envelope theorem at t*)
    q_min, q_max, g_min, g_max = _select_extrema(
        torch.stack([v0, v_tp, v_ts, v_star]),
        torch.stack([z, 0.5 * tp * tp + z, 0.5 * tp * tp + 0.5 * tp * (ts - tp) + z,
                     0.5 * tstar * tstar]),
        torch.stack([true, true, true, inside]))
    return q_min, q_max, g_min * k_scale, g_max * k_scale


def armtd_velocity_extrema(k, traj: TrajectoryCoeffs, cfg: ArmourConfig):
    """(qd_min, qd_max) [W, Q, F] in rad/s over the trajectory (qd0, the
    peak qd0 + k t_plan and the rest at t_stop) and their dk gradients."""
    tp = cfg.t_plan
    k_scale = traj.k_scale[:, None]
    k_act = k * k_scale
    qd0 = traj.qd0[:, None]
    qd_pk = qd0 + k_act * tp
    z = torch.zeros_like(k)
    true = torch.ones_like(k, dtype=torch.bool)
    qd_min, qd_max, g_min, g_max = _select_extrema(
        torch.stack([qd0.expand_as(k), qd_pk, z]), torch.stack([z, tp + z, z]),
        torch.stack([true, true, true]))
    return qd_min, qd_max, g_min * k_scale, g_max * k_scale


def plan_step_armtd(q0, qd0, q_des, obs, robot: RobotModel, cfg: ArmourConfig,
                    basis: KBasis, k0=None):
    """One ARMTD planning iteration for a batch of worlds: the constant-
    acceleration JRS, then the Bernstein family's FK / RNEA / collision /
    solver stages (K9, K10, K3, K4, K7, K8 on the card)."""
    from .nlp import solve
    from .planner import problem_from_jrs

    jrs = build_jrs_armtd(q0, qd0, robot, cfg, basis)
    prob = problem_from_jrs(jrs, q_des, obs, robot, cfg, basis)
    return solve(prob, cfg, basis, k0=k0)

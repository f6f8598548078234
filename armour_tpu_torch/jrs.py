"""Online joint reachable sets for the Bezier trajectory family (counterpart
of armour_tpu/jrs.py, Bernstein family).

For every time sub-interval: bound the k-independent part of q/qd/qdd by
closed-form extrema, bound the k coefficient, take a first-order Taylor
expansion of cos/sin with an interval Lagrange remainder, and inject the
controller tracking-error generators.  The JAX code builds one world and
vmaps; here every tensor carries the world axis W in front: q0 [W, F] ->
JRS fields [W, T, ...].  build_jrs is kernel K12 (csrc/jrs_bernstein.cu)
on CUDA tensors and build_jrs_plain on CPU tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import bezier
from .config import ArmourConfig
from .pz import interval as iv
from .pz.basis import KBasis, error_layout
from .pz.bpz import BPZ
from .robot import RobotModel
from .utils import div, to_device

SQRT3_6 = float(np.sqrt(3.0) / 6.0)
QDD_K_DEP_MAXIMA = 0.5 - SQRT3_6
QDD_K_DEP_MINIMA = 0.5 + SQRT3_6


@dataclasses.dataclass
class TrajectoryCoeffs:
    """Initial-state scalars shared by JRS, cost and extrema, each [W, F].

    family: 'bernstein' (degree-5 Bezier, the ARMOUR trajectory) or 'armtd'
    (constant acceleration, then braking: armtd.py).  k_scale: the actual
    parameter range per joint; cfg.k_range for bernstein, the
    velocity-adaptive g_k for armtd."""

    q0: torch.Tensor
    qd0: torch.Tensor
    qdd0: torch.Tensor
    Tqd0: torch.Tensor
    TTqdd0: torch.Tensor
    k_scale: torch.Tensor
    family: str = "bernstein"


@dataclasses.dataclass
class JRS:
    R: BPZ        # [W, T, J+1, 3, 3] joint rotations (last = identity)
    Rt: BPZ       # [W, T, J, 3, 3] transposes
    qd: BPZ       # [W, T, F]
    qda: BPZ      # [W, T, F]
    qdda: BPZ     # [W, T, F]
    traj: TrajectoryCoeffs


def _bound_k_indep(fn, extrema_fn, Tqd0, TTqdd0, q0, s_lb, s_ub, duration=None):
    """Bound fn(s) over [s_lb, s_ub] from endpoint values and interior
    critical points.  s [T, 1], params [W, 1, F] -> [W, T, F]."""
    kwargs = {} if duration is None else {"duration": duration}
    v_lb = fn(q0, Tqd0, TTqdd0, s_lb, **kwargs)
    v_ub = fn(q0, Tqd0, TTqdd0, s_ub, **kwargs)
    lo = torch.minimum(v_lb, v_ub)
    hi = torch.maximum(v_lb, v_ub)
    for e in extrema_fn(Tqd0, TTqdd0):
        ve = fn(q0, Tqd0, TTqdd0, e, **kwargs)
        inside = (s_lb < e) & (e < s_ub) & torch.isfinite(e) & torch.isfinite(ve)
        lo = torch.where(inside, torch.minimum(lo, ve), lo)
        hi = torch.where(inside, torch.maximum(hi, ve), hi)
    return lo, hi


def _rot_pattern(axis: int, c, s):
    """Axis rotation matrix from (cos, sin) entries in generator form:
    [...] -> [..., 3, 3], zeros elsewhere."""
    z = torch.zeros_like(c)
    if axis == 1:
        rows = [[z, z, z], [z, c, -s], [z, s, c]]
    elif axis == 2:
        rows = [[c, z, s], [z, z, z], [-s, z, c]]
    elif axis == 3:
        rows = [[c, -s, z], [s, c, z], [z, z, z]]
    else:
        raise ValueError(axis)
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def trig_taylor_pz(qc, Rq, kd_scaled):
    """First-order Taylor of cos/sin about qc with an interval Lagrange
    remainder.  Returns (cos_c, cos_k, cos_e, sin_c, sin_k, sin_e)."""
    W = Rq + torch.abs(kd_scaled)
    q_rad = iv.sym(Rq)
    J_int = (qc - W, qc + W)
    pow_term = (torch.zeros_like(W), W * W)

    cosJ = iv.cos(J_int)
    rem_cos = iv.add(iv.scale(q_rad, -torch.sin(qc)),
                     iv.scale(iv.mul(cosJ, pow_term), torch.full_like(W, -0.5)))
    cos_c = torch.cos(qc) + iv.center(rem_cos)
    cos_k = -kd_scaled * torch.sin(qc)
    cos_e = iv.radius(rem_cos)

    sinJ = iv.sin(J_int)
    rem_sin = iv.add(iv.scale(q_rad, torch.cos(qc)),
                     iv.scale(iv.mul(sinJ, pow_term), torch.full_like(W, -0.5)))
    sin_c = torch.sin(qc) + iv.center(rem_sin)
    sin_k = kd_scaled * torch.cos(qc)
    sin_e = iv.radius(rem_sin)
    return cos_c, cos_k, cos_e, sin_c, sin_k, sin_e


def assemble_rotations(robot, cos_c, cos_k, cos_e, sin_c, sin_k, sin_e,
                       basis: KBasis):
    """Rotation PZs R [W, T, J+1, 3, 3] and their transposes from per-joint
    cos/sin data [W, T, F]."""
    dt, dev = cos_c.dtype, cos_c.device
    Wn, T = cos_c.shape[:2]
    J = robot.num_joints
    F = robot.num_factors
    B = basis.size
    lay = error_layout(basis.nf)
    E = lay["size"]
    lin = basis.lin_idx
    rotm = to_device(robot.rot_mats, dt, dev)
    coef = torch.zeros((Wn, T, J + 1, 3, 3, B), dtype=dt, device=dev)
    egen = torch.zeros((Wn, T, J + 1, 3, 3, E), dtype=dt, device=dev)
    zeros = torch.zeros_like(cos_c[..., 0])
    for i in range(J):
        axis = int(robot.axes[i])
        if axis == 0 or i >= F:
            coef[:, :, i, :, :, 0] = rotm[i]
            continue
        sign = 1.0 if axis > 0 else -1.0  # reversed joints rotate by -q
        axis = abs(axis)
        rot_c = _rot_pattern(axis, cos_c[..., i], sign * sin_c[..., i])
        eye_axis = torch.zeros((3, 3), dtype=dt, device=dev)
        eye_axis[axis - 1, axis - 1] = 1.0
        coef[:, :, i, :, :, 0] = torch.einsum("ab,wtbc->wtac", rotm[i], rot_c + eye_axis)
        coef[:, :, i, :, :, int(lin[i])] = torch.einsum(
            "ab,wtbc->wtac", rotm[i],
            _rot_pattern(axis, cos_k[..., i], sign * sin_k[..., i]))
        egen[:, :, i, :, :, lay["cosqe"].start + i] = torch.einsum(
            "ab,wtbc->wtac", rotm[i], _rot_pattern(axis, cos_e[..., i], zeros))
        egen[:, :, i, :, :, lay["sinqe"].start + i] = torch.einsum(
            "ab,wtbc->wtac", rotm[i], _rot_pattern(axis, zeros, sin_e[..., i]))
    coef[:, :, J, :, :, 0] = torch.eye(3, dtype=dt, device=dev)

    R = BPZ(coef=coef, egen=egen,
            rad=torch.zeros((Wn, T, J + 1, 3, 3), dtype=dt, device=dev))
    Rt = BPZ(coef=R.coef[:, :, :J].transpose(3, 4),
             egen=R.egen[:, :, :J].transpose(3, 4),
             rad=R.rad[:, :, :J].transpose(3, 4))
    return R, Rt


def make_velocity_pz(center, kcoef, ecoef, egroup_name: str, basis: KBasis):
    """[W, T, F] velocity/acceleration PZ: center + k_i + dedicated error
    variable."""
    Wn, T, F = center.shape
    lay = error_layout(basis.nf)
    lin = basis.lin_idx
    coef = torch.zeros((Wn, T, F, basis.size), dtype=center.dtype, device=center.device)
    coef[..., 0] = center
    coef[..., torch.arange(F), torch.as_tensor(lin[:F])] = kcoef
    eg = torch.zeros((Wn, T, F, lay["size"]), dtype=center.dtype, device=center.device)
    eg[..., torch.arange(F), torch.arange(F) + lay[egroup_name].start] = ecoef
    return BPZ(coef=coef, egen=eg, rad=torch.zeros_like(center))


def build_jrs_plain(q0, qd0, qdd0, robot: RobotModel, cfg: ArmourConfig,
                    basis: KBasis) -> JRS:
    """Plain version of kernel K12: the online JRS for a batch of initial
    states q0/qd0/qdd0 [W, F]."""
    dt, dev = q0.dtype, q0.device
    T = cfg.num_time_steps
    F = robot.num_factors
    dur = cfg.duration
    ub = cfg.ub
    if len(cfg.k_range) != F:
        raise ValueError(
            f"cfg.k_range has {len(cfg.k_range)} entries but the robot has "
            f"{F} actuated joints; use ArmourConfig.for_robot(robot, ...)")

    Tqd0 = qd0 * dur
    TTqdd0 = qdd0 * dur * dur
    k_range = to_device(cfg.k_range, dt, dev)               # [F]
    traj = TrajectoryCoeffs(q0=q0, qd0=qd0, qdd0=qdd0, Tqd0=Tqd0, TTqdd0=TTqdd0,
                            k_scale=k_range.expand_as(q0))
    # per-world parameters broadcast against the time grid [T, 1]
    q0b, Tqd0b, TTqdd0b = q0[:, None], Tqd0[:, None], TTqdd0[:, None]

    ds = 1.0 / T
    s_lb = (torch.arange(T, dtype=dt, device=dev) * ds)[:, None]   # [T, 1]
    s_ub = s_lb + ds

    # ---- Part 1: q_des -> cos/sin PZs ----
    kd_lb = s_lb**3 * (6.0 * s_lb**2 - 15.0 * s_lb + 10.0)
    kd_ub = s_ub**3 * (6.0 * s_ub**2 - 15.0 * s_ub + 10.0)
    kd_center = (kd_ub + kd_lb) * 0.5                       # [T, 1]
    kd_radius = (kd_ub - kd_lb) * 0.5 * k_range             # [T, F]

    ki_lo, ki_hi = _bound_k_indep(bezier.q_des_k_indep, bezier.q_des_k_indep_extrema,
                                  Tqd0b, TTqdd0b, q0b, s_lb, s_ub)
    ki_radius = (ki_hi - ki_lo) * 0.5
    qc = (ki_hi + ki_lo) * 0.5                              # [W, T, F]

    Rq = kd_radius + ki_radius + ub.qe
    cos_c, cos_k, cos_e, sin_c, sin_k, sin_e = trig_taylor_pz(
        qc, Rq, (kd_center * k_range).expand_as(qc))

    # ---- Part 2: qd_des / qda_des ----
    v_lb = div(30.0 * s_lb**2 * (s_lb - 1.0) ** 2, dur)
    v_ub = div(30.0 * s_ub**2 * (s_ub - 1.0) ** 2, dur)
    v_lo = torch.minimum(v_lb, v_ub)
    v_hi = torch.maximum(v_lb, v_ub)
    vd_center = (v_hi + v_lo) * 0.5 * k_range
    vd_radius = (v_hi - v_lo) * 0.5 * k_range

    vi_lo, vi_hi = _bound_k_indep(bezier.qd_des_k_indep, bezier.qd_des_k_indep_extrema,
                                  Tqd0b, TTqdd0b, q0b, s_lb, s_ub, duration=dur)
    vi_radius = (vi_hi - vi_lo) * 0.5
    qd_center = (vi_hi + vi_lo) * 0.5

    qd_e = vd_radius + vi_radius + ub.qde
    qda_e = vd_radius + vi_radius + ub.qdae

    # ---- Part 3: qdda_des ----
    def acc(s):
        return div(60.0 * s * (2.0 * s**2 - 3.0 * s + 1.0), dur * dur)

    t_lb = acc(s_lb)
    t_ub = acc(s_ub)
    aA = acc(torch.full_like(s_lb, QDD_K_DEP_MAXIMA))
    aB = acc(torch.full_like(s_lb, QDD_K_DEP_MINIMA))
    in_reg1 = s_ub <= QDD_K_DEP_MAXIMA
    in_reg2 = (~in_reg1) & (s_lb <= QDD_K_DEP_MAXIMA)
    in_reg3 = (~in_reg1) & (~in_reg2) & (s_ub <= QDD_K_DEP_MINIMA)
    in_reg4 = (~in_reg1) & (~in_reg2) & (~in_reg3) & (s_lb <= QDD_K_DEP_MINIMA)
    a_lo = torch.where(
        in_reg1, t_lb,
        torch.where(in_reg2, torch.minimum(t_lb, t_ub),
                    torch.where(in_reg3, t_ub, torch.where(in_reg4, aB, t_lb))))
    a_hi = torch.where(
        in_reg1, t_ub,
        torch.where(in_reg2, aA,
                    torch.where(in_reg3, t_lb,
                                torch.where(in_reg4, torch.maximum(t_lb, t_ub), t_ub))))
    ad_center = (a_hi + a_lo) * 0.5 * k_range
    ad_radius = (a_hi - a_lo) * 0.5 * k_range

    ai_lo, ai_hi = _bound_k_indep(bezier.qdd_des_k_indep, bezier.qdd_des_k_indep_extrema,
                                  Tqd0b, TTqdd0b, q0b, s_lb, s_ub, duration=dur)
    ai_radius = (ai_hi - ai_lo) * 0.5
    qdd_center = (ai_hi + ai_lo) * 0.5
    qdda_e = ad_radius + ai_radius + ub.qddae

    def full(x):
        return x.expand_as(qc)

    qd_pz = make_velocity_pz(qd_center, full(vd_center), qd_e, "qde", basis)
    qda_pz = make_velocity_pz(qd_center, full(vd_center), qda_e, "qdae", basis)
    qdda_pz = make_velocity_pz(qdd_center, full(ad_center), qdda_e, "qddae", basis)
    R, Rt = assemble_rotations(robot, cos_c, cos_k, cos_e, sin_c, sin_k, sin_e, basis)
    return JRS(R=R, Rt=Rt, qd=qd_pz, qda=qda_pz, qdda=qdda_pz, traj=traj)


def build_jrs(q0, qd0, qdd0, robot: RobotModel, cfg: ArmourConfig, basis: KBasis) -> JRS:
    """Online JRS for a batch of initial states q0/qd0/qdd0 [W, F]: kernel
    K12 (csrc/jrs_bernstein.cu) on CUDA tensors, build_jrs_plain on CPU
    tensors."""
    if not q0.is_cuda:
        return build_jrs_plain(q0, qd0, qdd0, robot, cfg, basis)
    from .kernels import jrs as kjrs

    return kjrs.jrs_bernstein(q0, qd0, qdd0, robot, cfg, basis)

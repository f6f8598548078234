"""PZ recursive Newton-Euler (passivity form) and the robust torque bound
(counterpart of armour_tpu/dynamics.py).

The forward recursion carries w, w_aux, wdot and the linear acceleration
through the chain; the backward recursion accumulates wrenches and reads the
joint torque along the motion axis.  P parameter sets (nominal, interval)
share one kinematic forward pass.  Layout: kinematic quantities are
[W, 1, T, ...] and parameter-dependent ones [W, P, T, ...], so the P axis
broadcasts where the JAX code broadcasts a leading [P] against [T].

rnea_pz_sets_plain runs both recursions as Python loops over the joints of
the plain PyTorch ops, on any device.  Joints past num_factors are fixed
(the dumbbell's payload bodies); with wrench_at the backward recursion's
wrench after that joint comes out of the same pass (the grasp rows' contact
wrench).  On CUDA tensors rnea_pz_sets runs the
whole chain as kernel K10 (kernels/reach.py, csrc/rnea_chain.cu); a robot
with an uncertain centre of mass (robot.com_uncertainty > 0, off for the
Kinova) is routed, by that field, to the same loops over the op-level
kernels K1 (bpz.matmul_linear: the rotations) and K2 (bpz.cross).

After the RNEA, the robust torque radius (torque_frs) and the split of the
FK chain's links (kinematics.reduce_links) are kernel K15
(csrc/reach_assembly.cu), one launch for both (reach_assembly); its plain
version is reach_assembly_plain.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import ArmourConfig
from .jrs import JRS
from .kinematics import LinkFRS, forward_occupancy, reduce_links_plain
from .pz import bpz
from .pz.basis import KBasis
from .pz.bpz import BPZ
from .robot import RobotModel
from .utils import abs_sum_in_order, to_device


def _embed(a: BPZ, axis: int, sign: float) -> BPZ:
    """Scalar PZ [...] times the signed one-hot axis vector -> [..., 3]."""
    e = torch.zeros(3, dtype=a.coef.dtype, device=a.coef.device)
    e[axis] = sign
    return BPZ(coef=e[:, None] * a.coef[..., None, :],
               egen=e[:, None] * a.egen[..., None, :],
               rad=torch.abs(e) * a.rad[..., None])


def _col_stack(ps) -> BPZ:
    """Stack vector PZs [..., 3] as columns of a matrix PZ [..., 3, n]."""
    return bpz.stack(ps, dim=-1)


def _col(p: BPZ, j: int) -> BPZ:
    return BPZ(coef=p.coef[..., j, :], egen=p.egen[..., j, :], rad=p.rad[..., j])


def _joint(p: BPZ, i: int) -> BPZ:
    """Joint i of a [W, T, J, ...] PZ as [W, 1, T, ...]."""
    return BPZ(coef=p.coef[:, None, :, i], egen=p.egen[:, None, :, i],
               rad=p.rad[:, None, :, i])


def _inertial_pzs(robot: RobotModel, basis: KBasis, dtype, device, sets):
    """Mass, inertia and COM PZs over parameter sets, [J, P, ...]."""
    mass = to_device(robot.mass, dtype, device)
    inertia = to_device(robot.inertia, dtype, device)
    com = to_device(robot.com, dtype, device)
    mrads = torch.stack([
        robot.mass_uncertainty * torch.abs(mass) if s == "int" else torch.zeros_like(mass)
        for s in sets], dim=1)
    irads = torch.stack([
        robot.inertia_uncertainty * torch.abs(inertia) if s == "int"
        else torch.zeros_like(inertia) for s in sets], dim=1)
    crads = torch.stack([
        robot.com_uncertainty * torch.abs(com) if (s == "int" and robot.com_uncertainty)
        else torch.zeros_like(com) for s in sets], dim=1)
    P = len(sets)
    J = mass.shape[0]
    mass_pz = bpz.from_interval(mass[:, None].expand(J, P), mrads, basis)
    inertia_pz = bpz.from_interval(inertia[:, None].expand(J, P, 3, 3), irads, basis)
    com_pz = bpz.from_interval(com[:, None].expand(J, P, 3), crads, basis)
    return mass_pz, inertia_pz, com_pz


def _row(p: BPZ, i: int) -> BPZ:
    """Entry i of a [J, ...] PZ."""
    return BPZ(coef=p.coef[i], egen=p.egen[i], rad=p.rad[i])


def _factor(p: BPZ, i: int) -> BPZ:
    """Factor i of a [W, T, F] PZ as [W, 1, T]; zeros past F (the trailing
    fixed joints, as armour_tpu/dynamics.py:142-151 pads them)."""
    if i < p.rad.shape[-1]:
        return BPZ(coef=p.coef[:, None, :, i], egen=p.egen[:, None, :, i],
                   rad=p.rad[:, None, :, i])
    return BPZ(coef=torch.zeros_like(p.coef[:, None, :, 0]),
               egen=torch.zeros_like(p.egen[:, None, :, 0]),
               rad=torch.zeros_like(p.rad[:, None, :, 0]))


def _rnea_loops(jrs: JRS, robot: RobotModel, cfg: ArmourConfig, basis: KBasis, sets,
                matmul_linear, cross, wrench_at=None):
    """The PZ RNEA as loops over the joints (armour_tpu/dynamics.py:116-283)
    with the given rotation product and PZ x PZ cross product.  Joints past
    num_factors are fixed (no motion axis, zero velocities).  Returns u, or
    (u, f, n) with the wrench [W, P, T, 3] after joint wrench_at."""
    dt, dev = jrs.qd.coef.dtype, jrs.qd.coef.device
    Wn, T = jrs.qd.coef.shape[:2]
    J = robot.num_joints
    F = robot.num_factors
    P = len(sets)
    slop = cfg.float_slop
    trans = to_device(robot.trans, dt, dev)         # [J+1, 3]
    com = to_device(robot.com, dt, dev)             # [J, 3]
    mass_pz, inertia_pz, com_pz = _inertial_pzs(robot, basis, dt, dev, sets)
    com_uncertain = bool(robot.com_uncertainty and any(s == "int" for s in sets))

    w = bpz.zeros((Wn, 1, T, 3), basis, dt, device=dev)
    w_aux = bpz.zeros((Wn, 1, T, 3), basis, dt, device=dev)
    wdot = bpz.zeros((Wn, 1, T, 3), basis, dt, device=dev)
    lin_acc = bpz.zeros((Wn, 1, T, 3), basis, dt, device=dev)
    lin_acc.coef[..., 2, 0] = robot.gravity

    F_all, N_all = [], []
    for i in range(J):
        rev = robot.axes[i] != 0 and i < F
        ax = abs(int(robot.axes[i])) - 1 if rev else 0
        sgn = (1.0 if robot.axes[i] > 0 else -1.0) if rev else 0.0
        rt = _joint(jrs.Rt, i)
        qd_i, qda_i, qdda_i = (_factor(p, i) for p in (jrs.qd, jrs.qda, jrs.qdda))

        acc_arg = bpz.add(
            lin_acc,
            bpz.add(bpz.cross_pz_const(wdot, trans[i]),
                    cross(w, bpz.cross_pz_const(w_aux, trans[i]), basis, slop)))
        # fused rotation of (w | w_aux | wdot | acc): one 3x4 product
        rotated = matmul_linear(rt, _col_stack([w, w_aux, wdot, acc_arg]), basis, slop)
        w, w_aux, wdot, lin_acc = (_col(rotated, j) for j in range(4))

        rv = 1.0 if rev else 0.0
        qd_vec = _embed(bpz.scale(qd_i, rv), ax, sgn)
        w = bpz.add(w, qd_vec)
        wdot = bpz.add(wdot, cross(w_aux, qd_vec, basis, slop))
        wdot = bpz.add(wdot, _embed(bpz.scale(qdda_i, rv), ax, sgn))
        w_aux = bpz.add(w_aux, _embed(bpz.scale(qda_i, rv), ax, sgn))

        # link force / moment; parameter PZs [P, ...] -> [P, 1, ...] so they
        # broadcast against the kinematics [W, 1, T, ...]
        if com_uncertain:
            com_b = _row(com_pz, i)
            com_b = BPZ(coef=com_b.coef[:, None], egen=com_b.egen[:, None],
                        rad=com_b.rad[:, None])              # [P, 1, 3]
            f_arg = bpz.add(lin_acc, bpz.add(
                cross(wdot, com_b, basis, slop),
                cross(w, cross(w_aux, com_b, basis, slop), basis, slop)))
        else:
            f_arg = bpz.add(lin_acc, bpz.add(
                bpz.cross_pz_const(wdot, com[i]),
                cross(w, bpz.cross_pz_const(w_aux, com[i]), basis, slop)))
        m_c, m_r = bpz.interval_operand(_row(mass_pz, i))        # [P]
        F_i = bpz.mul_interval(m_c[:, None, None], m_r[:, None, None], f_arg, slop)
        I_c, I_r = bpz.interval_operand(_row(inertia_pz, i))     # [P, 3, 3]
        Iw = bpz.matmul_interval(I_c[:, None], I_r[:, None], _col_stack([wdot, w]), slop)
        N_i = bpz.add(_col(Iw, 0), cross(w_aux, _col(Iw, 1), basis, slop))
        F_all.append(F_i)
        N_all.append(N_i)

    # backward recursion over the chain, last joint first
    f = bpz.zeros((Wn, P, T, 3), basis, dt, device=dev)
    n = bpz.zeros((Wn, P, T, 3), basis, dt, device=dev)
    armature = robot.armature
    damping = robot.damping
    u_all = [None] * J
    wrench = None
    for i in reversed(range(J)):
        rev = robot.axes[i] != 0 and i < F
        ax = abs(int(robot.axes[i])) - 1 if rev else 0
        sgn = (1.0 if robot.axes[i] > 0 else -1.0) if rev else 0.0
        rv = 1.0 if rev else 0.0
        r_ip1 = _joint(jrs.R, i + 1)
        rot = matmul_linear(r_ip1, _col_stack([f, n]), basis, slop)
        rf, rn = _col(rot, 0), _col(rot, 1)
        if com_uncertain:
            com_b = _row(com_pz, i)
            com_b = BPZ(coef=com_b.coef[:, None], egen=com_b.egen[:, None],
                        rad=com_b.rad[:, None])
            com_cross_F = cross(com_b, F_all[i], basis, slop)
        else:
            com_cross_F = bpz.cross_const(com[i], F_all[i])
        n = bpz.add(bpz.add(N_all[i], rn),
                    bpz.add(com_cross_F, bpz.cross_const(trans[i + 1], rf)))
        f = bpz.add(rf, F_all[i])
        if i == wrench_at:
            wrench = (f, n)
        u_axis = BPZ(coef=sgn * n.coef[..., ax, :], egen=sgn * n.egen[..., ax, :],
                     rad=abs(sgn) * n.rad[..., ax])
        qdda_i, qd_i = _factor(jrs.qdda, i), _factor(jrs.qd, i)
        u_i = bpz.add(u_axis, bpz.scale(qdda_i, float(armature[i]) * rv))
        u_all[i] = bpz.add(u_i, bpz.scale(qd_i, float(damping[i]) * rv))
    u = bpz.stack(u_all[:F], dim=-1)                     # [W, P, T, F]
    if wrench_at is None:
        return u
    return u, wrench[0], wrench[1]


def rnea_pz_sets_plain(jrs: JRS, robot: RobotModel, cfg: ArmourConfig, basis: KBasis,
                       sets=("nom", "int"), *, wrench_at=None):
    """Plain version of kernel K10: PZ RNEA torque u [W, P, T, F] for the
    parameter sets (nominal "nom", interval "int") sharing one kinematic
    forward pass, on the plain PyTorch ops (pure PyTorch on any device).
    With wrench_at, (u, f, n): the wrench [W, P, T, 3] after that joint."""
    return _rnea_loops(jrs, robot, cfg, basis, sets, bpz.matmul_linear_plain,
                       bpz.cross_plain, wrench_at)


def rnea_pz_sets(jrs: JRS, robot: RobotModel, cfg: ArmourConfig, basis: KBasis,
                 sets=("nom", "int"), *, wrench_at=None):
    """PZ RNEA torque u [W, P, T, F] (armour_tpu/dynamics.py:116-283), and
    with wrench_at the joint wrench (f, n) [W, P, T, 3] after that chain
    index too, (u, f, n) from the same pass.  CPU tensors take
    rnea_pz_sets_plain; on CUDA tensors kernel K10, or, for a robot with an
    uncertain centre of mass, the loops over kernels K1 and K2."""
    if not jrs.qd.coef.is_cuda:
        return rnea_pz_sets_plain(jrs, robot, cfg, basis, sets, wrench_at=wrench_at)
    if robot.com_uncertainty and "int" in sets:
        return _rnea_loops(jrs, robot, cfg, basis, sets, bpz.matmul_linear, bpz.cross,
                           wrench_at)
    from .kernels import reach

    return reach.rnea_chain(jrs, robot, cfg, basis, sets, wrench_at=wrench_at)


def rnea_pz(jrs: JRS, robot: RobotModel, cfg: ArmourConfig, basis: KBasis,
            uncertain: bool) -> BPZ:
    """PZ RNEA torque u [W, T, F] of one parameter set: interval when
    uncertain, else nominal (armour_tpu/dynamics.py:98-105, with gravity)."""
    u = rnea_pz_sets(jrs, robot, cfg, basis, sets=("int" if uncertain else "nom",))
    return BPZ(coef=u.coef[:, 0], egen=u.egen[:, 0], rad=u.rad[:, 0])


@dataclasses.dataclass
class TorqueFRS:
    """Reduced nominal torque + total control-input radius for the NLP."""

    u_coef: torch.Tensor         # [W, T, F, B]
    torque_radius: torch.Tensor  # [W, T, F]


def torque_assembly_plain(u_both: BPZ, robot: RobotModel, cfg: ArmourConfig) -> TorqueFRS:
    """The torque part of kernel K15's plain version: the robust input
    radius from the RNEA torque u_both [W, 2, T, F] (nominal, interval) as
    armour_tpu/dynamics.py:296-319 forms it; every sum (the interval hull's
    radii, rho over F, the reduced nominal radius) left to right, as K15
    sums.  u_coef is a view of u_both's nominal coefficients."""
    u_nom = BPZ(coef=u_both.coef[:, 0], egen=u_both.egen[:, 0], rad=u_both.rad[:, 0])
    u_int = BPZ(coef=u_both.coef[:, 1], egen=u_both.egen[:, 1], rad=u_both.rad[:, 1])
    disturbance = bpz.sub(u_int, u_nom)

    # the disturbance's interval hull (bpz.to_interval in a fixed order)
    d_c = disturbance.coef[..., 0]
    d_r = abs_sum_in_order(disturbance.coef[..., 1:]) + abs_sum_in_order(disturbance.egen) \
        + disturbance.rad
    d_lo, d_hi = d_c - d_r, d_c + d_r
    d_max = torch.maximum(torch.abs(d_lo), torch.abs(d_hi))
    ub = cfg.ub
    sq = torch.maximum(d_lo * d_lo, d_hi * d_hi)                           # [W, T, F]
    rho_sq = sq[..., 0]
    for f in range(1, sq.shape[-1]):
        rho_sq = rho_sq + sq[..., f]
    rho_max = torch.sqrt(rho_sq)
    nom_rad = u_nom.rad + abs_sum_in_order(u_nom.egen)                     # bpz.reduce_
    friction = to_device(robot.friction[: robot.num_factors], u_nom.coef.dtype,
                         u_nom.coef.device)
    torque_radius = (
        ub.alpha * (ub.m_max - ub.m_min) * ub.eps
        + 0.5 * d_max
        + 0.5 * rho_max[..., None]
        + nom_rad
        + friction
    )
    return TorqueFRS(u_coef=u_nom.coef, torque_radius=torque_radius)


def reach_assembly_plain(links: BPZ, u_both: BPZ, robot: RobotModel, cfg: ArmourConfig,
                         basis: KBasis) -> tuple[LinkFRS, TorqueFRS]:
    """Plain version of kernel K15: the link split (kinematics.
    reduce_links_plain) of the FK chain's links [W, T, J, 3] and the robust
    torque radius (torque_assembly_plain) of the RNEA's u_both [W, 2, T, F],
    on any device."""
    return reduce_links_plain(links, basis), torque_assembly_plain(u_both, robot, cfg)


def reach_assembly(links: BPZ, u_both: BPZ, robot: RobotModel, cfg: ArmourConfig,
                   basis: KBasis) -> tuple[LinkFRS, TorqueFRS]:
    """The reach sets' assembly after K9 and K10, (LinkFRS, TorqueFRS):
    kernel K15 in one launch on CUDA tensors, reach_assembly_plain on CPU
    tensors."""
    if not links.rad.is_cuda:
        return reach_assembly_plain(links, u_both, robot, cfg, basis)
    from .kernels import reach

    return reach.reach_assembly(links, u_both, robot, cfg, basis)


def torque_frs(jrs: JRS, robot: RobotModel, cfg: ArmourConfig, basis: KBasis) -> TorqueFRS:
    """Nominal torque PZ + robust input radius (armour_tpu/dynamics.py:293-319):
    the RNEA for the nominal and interval sets, then the assembly.  On CUDA
    tensors the assembly is kernel K15, which takes the FK chain's links
    too (a planning step launches it once for both: reach_assembly); on CPU
    tensors torque_assembly_plain."""
    u_both = rnea_pz_sets(jrs, robot, cfg, basis)
    if not u_both.rad.is_cuda:
        return torque_assembly_plain(u_both, robot, cfg)
    return reach_assembly(forward_occupancy(jrs, robot, cfg, basis), u_both, robot, cfg,
                          basis)[1]

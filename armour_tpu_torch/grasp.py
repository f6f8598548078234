"""Grasp / contact extension (counterpart of armour_tpu/grasp.py): the
contact wrench PZs at the payload body and the waiter's-tray contact rows

  separation:  -f_n <= 0
  slipping:    ||f_t||^2 - mu^2 f_n^2 <= 0
  tipping:     ||n_t||^2 - r^2  f_n^2 <= 0

with f decomposed along the contact normal in the payload frame, formed in
PZ arithmetic from the interval wrench so that containment carries through
the quadratic polynomials, then sliced at k by the solver like the torque
rows.

The wrench is the PZ RNEA's backward-recursion wrench after the contact
joint (dynamics.rnea_pz_sets(wrench_at=)); on the card it comes from the
same kernel K10 launch that gives the torque.  The rows (the five squares
mul(p, p), their sums and the reduction) are kernel K16
(csrc/grasp_rows.cu) on CUDA tensors and grasp_rows_plain on CPU tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import ArmourConfig
from .dynamics import rnea_pz_sets
from .jrs import JRS
from .pz import bpz
from .pz.basis import KBasis
from .pz.bpz import BPZ
from .robot import RobotModel
from .utils import warp_sum_in_order


@dataclasses.dataclass
class ContactWrenchFRS:
    """Contact wrench PZs at the grasp joint, nominal and interval
    parameters, each [W, T, 3]."""

    f_nom: BPZ
    n_nom: BPZ
    f_int: BPZ
    n_int: BPZ


def _set(p: BPZ, i: int) -> BPZ:
    return BPZ(coef=p.coef[:, i], egen=p.egen[:, i], rad=p.rad[:, i])


def contact_joint_of(robot: RobotModel, contact_joint: int | None) -> int:
    """The chain index of the payload body (the last link by default)."""
    return robot.num_joints - 1 if contact_joint is None else contact_joint


def contact_wrench_frs(jrs: JRS, robot: RobotModel, cfg: ArmourConfig, basis: KBasis,
                       contact_joint: int | None = None) -> ContactWrenchFRS:
    """Wrench transmitted to the payload body (default: the last chain
    link) for nominal and interval inertial parameters
    (armour_tpu/grasp.py:50-63)."""
    j = contact_joint_of(robot, contact_joint)
    _, f_c, n_c = rnea_pz_sets(jrs, robot, cfg, basis, ("nom", "int"), wrench_at=j)
    return ContactWrenchFRS(f_nom=_set(f_c, 0), n_nom=_set(n_c, 0),
                            f_int=_set(f_c, 1), n_int=_set(n_c, 1))


@dataclasses.dataclass(frozen=True)
class GraspParams:
    """Contact model: friction coefficient and support-disc radius
    (waiter's-tray conditions)."""

    mu: float = 0.5
    support_radius: float = 0.05
    normal_axis: int = 2  # contact normal in the payload frame


def _comp(p: BPZ, i: int) -> BPZ:
    return BPZ(coef=p.coef[..., i, :], egen=p.egen[..., i, :], rad=p.rad[..., i])


def _contact_constraint_pzs(w: ContactWrenchFRS, params: GraspParams, basis: KBasis,
                            cfg: ArmourConfig):
    """The three contact-condition PZs (sep, slip, tip) from the interval
    wrench (armour_tpu/grasp.py:74-101), each square the pair-table
    product in kernel K16's order (bpz._mul), on any device.  The constants
    mu^2 and r^2 are Python doubles, rounded once where they scale a
    tensor."""
    a = params.normal_axis
    t_axes = [i for i in range(3) if i != a]
    slop = cfg.float_slop
    f_n = _comp(w.f_int, a)
    f_t = [_comp(w.f_int, i) for i in t_axes]
    n_t = [_comp(w.n_int, i) for i in t_axes]

    def sq(p):
        return bpz._mul(p, p, basis, slop)

    sep = bpz.neg(f_n)
    slip = bpz.add(sq(f_t[0]), sq(f_t[1]))
    slip = bpz.add(slip, bpz.scale(sq(f_n), -params.mu ** 2))
    tip = bpz.add(sq(n_t[0]), sq(n_t[1]))
    tip = bpz.add(tip, bpz.scale(sq(f_n), -params.support_radius ** 2))
    return sep, slip, tip


def grasp_constraint_intervals(w: ContactWrenchFRS, params: GraspParams, basis: KBasis,
                               cfg: ArmourConfig):
    """Sound per-time upper bounds of the three contact constraints over the
    whole (k, error) set, each [W, T] (armour_tpu/grasp.py:104-115).  For
    tests and offline checks."""
    sep, slip, tip = _contact_constraint_pzs(w, params, basis, cfg)

    def upper(p):
        c, r = bpz.to_interval(p)
        return c + r

    return upper(sep), upper(slip), upper(tip)


@dataclasses.dataclass
class GraspFRS:
    """k-sliceable grasp rows: g(k) = g_coef . phi(k) + g_rad <= 0 for
    every t, row order (sep, slip, tip)."""

    g_coef: torch.Tensor  # [W, T, 3, B]
    g_rad: torch.Tensor   # [W, T, 3]


def grasp_params(cfg: ArmourConfig) -> GraspParams:
    """The contact parameters of cfg (the planner's grasp branch)."""
    return GraspParams(mu=cfg.grasp_mu, support_radius=cfg.grasp_support_radius,
                       normal_axis=cfg.grasp_normal_axis)


def grasp_rows_plain(f_c: BPZ, n_c: BPZ, params: GraspParams, cfg: ArmourConfig,
                     basis: KBasis) -> GraspFRS:
    """Plain version of kernel K16: the grasp rows from the RNEA's wrench
    f_c, n_c [W, P, T, 3] (the interval set last, as rnea_pz_sets(("nom",
    "int"), wrench_at=) gives it), every sum in K16's fixed order
    (bpz._mul; the reduction's abs sum in a warp's order), on any
    device."""
    P = f_c.rad.shape[1]
    f_int, n_int = _set(f_c, P - 1), _set(n_c, P - 1)
    w = ContactWrenchFRS(f_nom=f_int, n_nom=n_int, f_int=f_int, n_int=n_int)
    rows = _contact_constraint_pzs(w, params, basis, cfg)
    g_rad = [p.rad + warp_sum_in_order(torch.abs(p.egen)) for p in rows]
    return GraspFRS(g_coef=torch.stack([p.coef for p in rows], dim=-2),
                    g_rad=torch.stack(g_rad, dim=-1))


def grasp_rows(f_c: BPZ, n_c: BPZ, params: GraspParams, cfg: ArmourConfig,
               basis: KBasis) -> GraspFRS:
    """The grasp rows from the RNEA's wrench f_c, n_c [W, P, T, 3]: kernel
    K16 on CUDA tensors (it reads the interval set in place),
    grasp_rows_plain on CPU tensors."""
    if not f_c.rad.is_cuda:
        return grasp_rows_plain(f_c, n_c, params, cfg, basis)
    from .kernels import grasp as kgrasp

    return kgrasp.grasp_rows(f_c, n_c, params, cfg, basis)


def grasp_frs(jrs: JRS, robot: RobotModel, cfg: ArmourConfig, basis: KBasis,
              params: GraspParams, contact_joint: int | None = None) -> GraspFRS:
    """Planner-facing grasp rows (armour_tpu/grasp.py:131-140): the RNEA's
    wrench at the contact joint (K10 on the card), then the rows (K16)."""
    j = contact_joint_of(robot, contact_joint)
    _, f_c, n_c = rnea_pz_sets(jrs, robot, cfg, basis, ("nom", "int"), wrench_at=j)
    return grasp_rows(f_c, n_c, params, cfg, basis)

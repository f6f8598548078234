"""Robust passivity/CBF low-level controller (counterpart of
armour_tpu/controller.py:35-153):

    r       = (qd_des - qd) + Kr (q_des - q)
    qd_ref  = qd_des + Kr (q_des - q);  qdd_ref = qdd_des + Kr (qd_des - qd)
    tau     = RNEA(q, qd, qd_ref, qdd_ref; nominal params)
    rho     = sup |r|^T |disturbance|           (interval disturbance)
    V       = sup 0.5 r^T M_int(q) r            (interval Lyapunov)
    h       = V_max - V;  lambda = max(0, (-alpha h + rho) / ||r||^2)
    u       = tau + lambda r

RNEA is linear in each link's (mass, inertia), so the interval bounds come
exactly from per-link sensitivity evaluations (2J extra RNEA chains).  Every
function broadcasts over leading (worlds) dims.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import ArmourConfig
from .rnea_numeric import rnea
from .robot import RobotModel


def _directions(robot: RobotModel, dt, dev):
    """The 2J uncertainty directions: masses [2J, J] (the J mass directions,
    then zeros) and inertias [2J, J, 3, 3] (zeros, then the J inertia
    directions)."""
    J = robot.num_joints
    mass = torch.as_tensor(robot.mass, dtype=dt).to(dev)
    inertia = torch.as_tensor(robot.inertia, dtype=dt).to(dev)
    mass_dirs = torch.diag(mass * robot.mass_uncertainty)                        # [J, J]
    mass_b = torch.cat([mass_dirs, torch.zeros(J, J, dtype=dt, device=dev)], 0)  # [2J, J]
    eye = torch.eye(J, dtype=dt, device=dev)
    inertia_dirs = eye[:, :, None, None] * inertia[None] * robot.inertia_uncertainty
    inertia_b = torch.cat([torch.zeros_like(inertia_dirs), inertia_dirs], 0)    # [2J, J, 3, 3]
    return mass_b, inertia_b


def _controller_taus(robot: RobotModel, q, qd, qd_ref, qdd_ref, r=None, rotations=None):
    """The controller's RNEAs at one q as one batched call over 1 + 2J
    chains (2 + 4J with r), which share q's rotations: tau = rnea(q, qd,
    qd_ref, qdd_ref), and pert [2J, ..., F], the tau contribution of each
    of the 2J uncertainty directions of _directions at the same point
    (armour_tpu/controller.py _perturbation_taus: gravity on, armature off);
    with r also the Lyapunov pass rnea(q, 0, 0, r; no gravity) and pert_r,
    the directions' contributions at (q, 0, 0, r).  Each chain's arithmetic
    is its own call's; returns (tau, pert[, mr, pert_r])."""
    J = robot.num_joints
    dt, dev = q.dtype, q.device
    mass_b, inertia_b = _directions(robot, dt, dev)
    mass = torch.as_tensor(robot.mass, dtype=dt).to(dev)[None]
    inertia = torch.as_tensor(robot.inertia, dtype=dt).to(dev)[None]
    n = 1 + 2 * J
    masses, inertias = [mass, mass_b], [inertia, inertia_b]
    grav, arm = [1.0] + [1.0] * (2 * J), [1.0] + [0.0] * (2 * J)
    qds, qas, qdds = [qd], [qd_ref], [qdd_ref]
    if r is not None:
        z = torch.zeros_like(q)
        masses, inertias = masses * 2, inertias * 2
        grav, arm = grav + [0.0] + [1.0] * (2 * J), arm * 2
        qds, qas, qdds = [qd, z], [qd_ref, z], [qdd_ref, r]
    lead = (1,) * (q.dim() - 1)

    def chains(xs):
        return torch.cat([x.expand((n,) + x.shape) for x in xs])

    def per_chain(xs, tail):
        return torch.cat(xs).reshape((-1,) + lead + tail)

    def flag(v):
        return torch.as_tensor(v, dtype=dt).to(dev).reshape((-1,) + lead)

    out = rnea(robot, q, chains(qds), chains(qas), chains(qdds),
               mass=per_chain(masses, (J,)), inertia=per_chain(inertias, (J, 3, 3)),
               set_gravity=flag(grav), include_armature=flag(arm), rotations=rotations)
    if r is None:
        return out[0], out[1:n]
    return out[0], out[1:n], out[n], out[n + 1:]


def _refs(cfg: ArmourConfig, q, qd, q_des, qd_des, qdd_des):
    k_r = cfg.ub.k_r
    err = q_des - q
    derr = qd_des - qd
    return err, derr, qd_des + k_r * err, qdd_des + k_r * derr, derr + k_r * err


def robust_control(robot: RobotModel, cfg: ArmourConfig, q, qd, q_des, qd_des, qdd_des, *,
                   rotations=None):
    """(u, tau, v): control input u = tau_nominal + robust term v.
    rotations: joint_rotations(robot, q), where the caller has them."""
    ub = cfg.ub
    _, _, qd_ref, qdd_ref, r = _refs(cfg, q, qd, q_des, qd_des, qdd_des)

    # tau, the perturbations at (qd, qd_ref, qdd_ref) [2J, ..., F], and the
    # interval Lyapunov's passes: V = 0.5 r^T M(q) r with M (armature
    # included) from rnea(qdd = r, no gravity), its perturbations [2J, ..., F]
    tau, pert, mr, v_pert = _controller_taus(robot, q, qd, qd_ref, qdd_ref, r, rotations)
    dist_sup = pert.abs().sum(0)                                    # [..., F]
    rho = (r.abs() * dist_sup).sum(-1)
    v_nom = 0.5 * (r * mr).sum(-1)
    v_sup = v_nom + 0.5 * (v_pert * r).sum(-1).abs().sum(0)
    h = ub.v_max - v_sup

    r_sq = (r * r).sum(-1)
    lam = torch.clamp_min((-ub.alpha * h + rho) / torch.clamp_min(r_sq, 1e-12), 0.0)
    v = lam[..., None] * r
    u = tau + torch.where(r_sq[..., None] > 0, v, torch.zeros_like(v))
    return u, tau, v


def nominal_passivity_control(robot: RobotModel, cfg: ArmourConfig,
                              q, qd, q_des, qd_des, qdd_des, *, rotations=None):
    """Ablation controller: the nominal passivity RNEA only."""
    _, _, qd_ref, qdd_ref, _ = _refs(cfg, q, qd, q_des, qd_des, qdd_des)
    return rnea(robot, q, qd, qd_ref, qdd_ref, rotations=rotations)


@dataclasses.dataclass(frozen=True)
class AlthoffGains:
    """PI-adaptive gains of the Giusti-Althoff comparison controller."""

    kp: tuple = (28.1037, 28.1037)
    ki: tuple = (4.0, 4.0)
    max_error: float = 1e-5


ALTHOFF_DEFAULT = AlthoffGains()


def althoff_control(robot: RobotModel, cfg: ArmourConfig, q, qd,
                    q_des, qd_des, qdd_des, e_acc, dt,
                    gains: AlthoffGains = ALTHOFF_DEFAULT, *, rotations=None):
    """Giusti-Althoff PI-adaptive robust comparison controller:

        phi(t)   = Kp[0] + Ki[0] E(t);  kappa(t) = Kp[1] + Ki[1] E(t)
        u        = tau_nominal + (kappa(t) ||bound|| + phi(t)) r

    bound is the per-joint interval-disturbance sup and E(t) accumulates the
    tracking-error norm while it exceeds max_error.  Returns
    (u, tau, v, e_acc_new); e_acc [...] is carried through the rollout."""
    err, derr, qd_ref, qdd_ref, r = _refs(cfg, q, qd, q_des, qd_des, qdd_des)

    tau, pert = _controller_taus(robot, q, qd, qd_ref, qdd_ref, rotations=rotations)
    bound_norm = torch.linalg.vector_norm(pert.abs().sum(0), dim=-1)

    state_err = torch.sqrt((err * err).sum(-1) + (derr * derr).sum(-1))
    e_acc_new = e_acc + torch.where(state_err > gains.max_error, state_err * dt,
                                    torch.zeros_like(state_err))
    phi_t = gains.kp[0] + gains.ki[0] * e_acc_new
    kappa_t = gains.kp[1] + gains.ki[1] * e_acc_new
    v = (kappa_t * bound_norm + phi_t)[..., None] * r
    return tau + v, tau, v, e_acc_new

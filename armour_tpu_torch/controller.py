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


def _perturbation_taus(robot: RobotModel, q, qd, qd_aux, qdd):
    """tau contribution of each link's +-uncertainty direction: [2J, ..., F]
    (the J mass directions, then the J inertia directions)."""
    J = robot.num_joints
    dt, dev = q.dtype, q.device
    mass = torch.as_tensor(robot.mass, dtype=dt).to(dev)
    inertia = torch.as_tensor(robot.inertia, dtype=dt).to(dev)
    mass_dirs = torch.diag(mass * robot.mass_uncertainty)                        # [J, J]
    mass_b = torch.cat([mass_dirs, torch.zeros(J, J, dtype=dt, device=dev)], 0)  # [2J, J]
    eye = torch.eye(J, dtype=dt, device=dev)
    inertia_dirs = eye[:, :, None, None] * inertia[None] * robot.inertia_uncertainty
    inertia_b = torch.cat([torch.zeros_like(inertia_dirs), inertia_dirs], 0)    # [2J, J, 3, 3]
    lead = (1,) * (q.dim() - 1)
    mass_b = mass_b.reshape((2 * J,) + lead + (J,))
    inertia_b = inertia_b.reshape((2 * J,) + lead + (J, 3, 3))

    def b(x):
        return x.expand((2 * J,) + x.shape)

    return rnea(robot, b(q), b(qd), b(qd_aux), b(qdd), mass=mass_b, inertia=inertia_b,
                set_gravity=True, include_armature=False)


def _refs(cfg: ArmourConfig, q, qd, q_des, qd_des, qdd_des):
    k_r = cfg.ub.k_r
    err = q_des - q
    derr = qd_des - qd
    return err, derr, qd_des + k_r * err, qdd_des + k_r * derr, derr + k_r * err


def robust_control(robot: RobotModel, cfg: ArmourConfig, q, qd, q_des, qd_des, qdd_des):
    """(u, tau, v): control input u = tau_nominal + robust term v."""
    ub = cfg.ub
    _, _, qd_ref, qdd_ref, r = _refs(cfg, q, qd, q_des, qd_des, qdd_des)

    tau = rnea(robot, q, qd, qd_ref, qdd_ref)
    pert = _perturbation_taus(robot, q, qd, qd_ref, qdd_ref)        # [2J, ..., F]
    dist_sup = pert.abs().sum(0)                                    # [..., F]
    rho = (r.abs() * dist_sup).sum(-1)

    # interval Lyapunov: V = 0.5 r^T M(q) r with M (armature included) from
    # rnea(qdd = r, no gravity)
    z = torch.zeros_like(q)
    v_nom = 0.5 * (r * rnea(robot, q, z, z, r, set_gravity=False,
                            include_armature=True)).sum(-1)
    v_pert = _perturbation_taus(robot, q, z, z, r)                  # [2J, ..., F]
    v_sup = v_nom + 0.5 * (v_pert * r).sum(-1).abs().sum(0)
    h = ub.v_max - v_sup

    r_sq = (r * r).sum(-1)
    lam = torch.clamp_min((-ub.alpha * h + rho) / torch.clamp_min(r_sq, 1e-12), 0.0)
    v = lam[..., None] * r
    u = tau + torch.where(r_sq[..., None] > 0, v, torch.zeros_like(v))
    return u, tau, v


def nominal_passivity_control(robot: RobotModel, cfg: ArmourConfig,
                              q, qd, q_des, qd_des, qdd_des):
    """Ablation controller: the nominal passivity RNEA only."""
    _, _, qd_ref, qdd_ref, _ = _refs(cfg, q, qd, q_des, qd_des, qdd_des)
    return rnea(robot, q, qd, qd_ref, qdd_ref)


@dataclasses.dataclass(frozen=True)
class AlthoffGains:
    """PI-adaptive gains of the Giusti-Althoff comparison controller."""

    kp: tuple = (28.1037, 28.1037)
    ki: tuple = (4.0, 4.0)
    max_error: float = 1e-5


ALTHOFF_DEFAULT = AlthoffGains()


def althoff_control(robot: RobotModel, cfg: ArmourConfig, q, qd,
                    q_des, qd_des, qdd_des, e_acc, dt,
                    gains: AlthoffGains = ALTHOFF_DEFAULT):
    """Giusti-Althoff PI-adaptive robust comparison controller:

        phi(t)   = Kp[0] + Ki[0] E(t);  kappa(t) = Kp[1] + Ki[1] E(t)
        u        = tau_nominal + (kappa(t) ||bound|| + phi(t)) r

    bound is the per-joint interval-disturbance sup and E(t) accumulates the
    tracking-error norm while it exceeds max_error.  Returns
    (u, tau, v, e_acc_new); e_acc [...] is carried through the rollout."""
    err, derr, qd_ref, qdd_ref, r = _refs(cfg, q, qd, q_des, qd_des, qdd_des)

    tau = rnea(robot, q, qd, qd_ref, qdd_ref)
    pert = _perturbation_taus(robot, q, qd, qd_ref, qdd_ref)
    bound_norm = torch.linalg.vector_norm(pert.abs().sum(0), dim=-1)

    state_err = torch.sqrt((err * err).sum(-1) + (derr * derr).sum(-1))
    e_acc_new = e_acc + torch.where(state_err > gains.max_error, state_err * dt,
                                    torch.zeros_like(state_err))
    phi_t = gains.kp[0] + gains.ki[0] * e_acc_new
    kappa_t = gains.kp[1] + gains.ki[1] * e_acc_new
    v = (kappa_t * bound_norm + phi_t)[..., None] * r
    return tau + v, tau, v, e_acc_new

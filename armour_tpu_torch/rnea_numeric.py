"""Numeric (pointwise) passivity-form RNEA (counterpart of
armour_tpu/rnea_numeric.py:24-190).

The runtime twin of the PZ RNEA in dynamics.py, evaluated at concrete joint
states: the nominal torque inside the robust controller and the
mass/Coriolis/gravity split of the simulated plant.  Every function
broadcasts over leading batch dims; per-link inertial overrides (mass [..., J],
com [..., J, 3], inertia [..., J, 3, 3]) broadcast against them.

Small products are written as a multiply and a sum over the last axis, so
that the plain closed loop on the card makes few launches per call.
"""

from __future__ import annotations

import torch

from .robot import RobotModel


def _const(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype).to(like.device)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M [..., 3, 3] @ v [..., 3]."""
    return (M * v[..., None, :]).sum(-1)


def _mtv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M^T [..., 3, 3] @ v [..., 3]."""
    return (M * v[..., :, None]).sum(-2)


def _mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A [..., 3, 3] @ B [..., 3, 3]."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _axis_patterns(robot: RobotModel):
    """Per joint: the constant matrices C, S, K with Rot_axis(th) =
    cos(th) C + sin(th) S + K, and the sign of each joint angle.  A fixed
    joint (or one past num_factors) is C = S = 0, K = I."""
    import numpy as np

    J = robot.num_joints
    C = np.zeros((J, 3, 3))
    S = np.zeros((J, 3, 3))
    K = np.zeros((J, 3, 3))
    sgn = np.zeros(J)
    for i in range(J):
        axis = int(robot.axes[i])
        if axis == 0 or i >= robot.num_factors:
            K[i] = np.eye(3)
            continue
        a = abs(axis) - 1
        b, c = [x for x in range(3) if x != a]
        K[i, a, a] = 1.0
        C[i, b, b] = C[i, c, c] = 1.0
        # x: [[1,0,0],[0,c,-s],[0,s,c]]; y: [[c,0,s],[0,1,0],[-s,0,c]];
        # z: [[c,-s,0],[s,c,0],[0,0,1]]
        if a == 1:
            S[i, 0, 2], S[i, 2, 0] = 1.0, -1.0
        else:
            S[i, b, c], S[i, c, b] = -1.0, 1.0
        sgn[i] = 1.0 if axis > 0 else -1.0
    return C, S, K, sgn


def joint_rotations(robot: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """R_i = RPY_i @ Rot_axis(q_i): [..., J, 3, 3]."""
    C, S, K, sgn = (_const(x, q) for x in _axis_patterns(robot))
    J, F = robot.num_joints, robot.num_factors
    th = torch.zeros(q.shape[:-1] + (J,), dtype=q.dtype, device=q.device)
    th[..., :min(F, J)] = q[..., :min(F, J)]
    th = th * sgn
    c, s = torch.cos(th)[..., None, None], torch.sin(th)[..., None, None]
    R_axis = c * C + s * S + K
    return _mm(_const(robot.rot_mats, q), R_axis)


def forward_kinematics(robot: RobotModel, q: torch.Tensor):
    """World rotation + position of each joint frame and link box centre:
    (R_w [..., J, 3, 3], p_w [..., J, 3], link_centers [..., J, 3])."""
    Rs = joint_rotations(robot, q)
    trans = _const(robot.trans, q)
    link_c = _const(robot.link_center, q)
    fk_r = torch.eye(3, dtype=q.dtype, device=q.device).expand(q.shape[:-1] + (3, 3))
    fk_t = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
    R_out, p_out, c_out = [], [], []
    for i in range(robot.num_joints):
        fk_t = fk_t + _mv(fk_r, trans[i])
        fk_r = _mm(fk_r, Rs[..., i, :, :])
        R_out.append(fk_r)
        p_out.append(fk_t)
        c_out.append(fk_t + _mv(fk_r, link_c[i]))
    return torch.stack(R_out, -3), torch.stack(p_out, -2), torch.stack(c_out, -2)


def rnea(robot: RobotModel, q, qd, qd_aux, qdd, *, mass=None, com=None, inertia=None,
         set_gravity: bool = True, include_armature: bool = True, wrench_at=None):
    """Passivity-form RNEA torque [..., F].  mass/com/inertia default to the
    robot's nominal values; pass perturbed tensors for true-parameter or
    sensitivity evaluations.  wrench_at: a chain index; then the backward
    recursion's wrench (f, n) [..., 3] at that body is returned too,
    (tau, f, n) (the contact wrench's ground truth for grasp.py)."""
    J = robot.num_joints
    mass = _const(robot.mass if mass is None else mass, q)
    com = _const(robot.com if com is None else com, q)
    inertia = _const(robot.inertia if inertia is None else inertia, q)
    trans = _const(robot.trans, q)
    batch = q.shape[:-1]
    Rs = joint_rotations(robot, q)

    zero3 = torch.zeros(batch + (3,), dtype=q.dtype, device=q.device)
    w, w_aux, wdot = zero3, zero3, zero3
    lin_acc = zero3
    if set_gravity:
        lin_acc = zero3.clone()
        lin_acc[..., 2] = robot.gravity

    Fs, Ns = [], []
    for i in range(J):
        R = Rs[..., i, :, :]
        lin_acc = _mtv(R, lin_acc + _cross(wdot, trans[i]) + _cross(w, _cross(w_aux, trans[i])))
        w = _mtv(R, w)
        w_aux = _mtv(R, w_aux)
        wdot = _mtv(R, wdot)
        axis = int(robot.axes[i])
        if axis != 0 and i < robot.num_factors:
            ax = abs(axis) - 1
            e = torch.zeros(3, dtype=q.dtype, device=q.device)
            e[ax] = 1.0 if axis > 0 else -1.0
            w = w + e * qd[..., i, None]
            wdot = wdot + _cross(w_aux, e * qd[..., i, None]) + e * qdd[..., i, None]
            w_aux = w_aux + e * qd_aux[..., i, None]
        mb = mass[..., i]
        cb = com[..., i, :]
        Ib = inertia[..., i, :, :]
        Fs.append(mb[..., None] * (lin_acc + _cross(wdot, cb) + _cross(w, _cross(w_aux, cb))))
        Ns.append(_mv(Ib, wdot) + _cross(w_aux, _mv(Ib, w)))

    f, n = zero3, zero3
    taus = [None] * robot.num_factors
    wrench = None
    for i in reversed(range(J)):
        cb = com[..., i, :]
        if i + 1 < J:
            R_ip1 = Rs[..., i + 1, :, :]
            rf, rn = _mv(R_ip1, f), _mv(R_ip1, n)
        else:
            rf, rn = f, n
        n = Ns[i] + rn + _cross(cb, Fs[i]) + _cross(trans[i + 1], rf)
        f = rf + Fs[i]
        if wrench_at is not None and i == wrench_at:
            wrench = (f, n)
        axis = int(robot.axes[i])
        if axis != 0 and i < robot.num_factors:
            tau = (1.0 if axis > 0 else -1.0) * n[..., abs(axis) - 1]
            if include_armature:
                tau = tau + float(robot.armature[i]) * qdd[..., i]
            if robot.damping[i] != 0.0:
                tau = tau + float(robot.damping[i]) * qd[..., i]
            taus[i] = tau
    out = torch.stack(taus, -1)
    if wrench_at is not None:
        return out, wrench[0], wrench[1]
    return out


def mass_matrix(robot: RobotModel, q, *, mass=None, com=None, inertia=None,
                include_armature: bool = True):
    """M(q) [..., F, F], columnwise via one RNEA over the F unit
    accelerations.  Overrides with a batch shape get a direction axis."""
    F = robot.num_factors
    eye = torch.eye(F, dtype=q.dtype, device=q.device)
    bq = q[..., None, :].expand(q.shape[:-1] + (F, F))
    bz = torch.zeros_like(bq)
    bqdd = eye.expand(q.shape[:-1] + (F, F))

    def _dir(x, nd):
        if x is None:
            return None
        x = torch.as_tensor(x)
        return x if x.dim() <= nd else x.unsqueeze(-nd - 1)

    cols = rnea(robot, bq, bz, bz, bqdd, mass=_dir(mass, 1), com=_dir(com, 2),
                inertia=_dir(inertia, 3), set_gravity=False,
                include_armature=include_armature)
    return cols.transpose(-1, -2)


def coriolis_gravity(robot: RobotModel, q, qd, *, mass=None, com=None, inertia=None):
    """C(q, qd) qd + g(q), the combined bias torque."""
    return rnea(robot, q, qd, qd, torch.zeros_like(q), mass=mass, com=com,
                inertia=inertia, set_gravity=True, include_armature=False)

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

import functools

import numpy as np
import torch

from .robot import RobotModel


def _const(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype).to(like.device)


_CONSTS: dict = {}


def _robot_consts(robot: RobotModel, like: torch.Tensor) -> dict:
    """The robot's constant tensors in like's dtype on its device, formed
    once per (robot, dtype, device): the closed loop calls the RNEA ten
    times a control step."""
    key = (id(robot), like.dtype, like.device)
    hit = _CONSTS.get(key)
    if hit is not None and hit[0] is robot:
        return hit[1]
    if len(_CONSTS) > 64:
        _CONSTS.clear()
    F = robot.num_factors
    C, S, K, sgn = _axis_patterns(robot)
    c = {name: _const(x, like) for name, x in (
        ("C", C), ("S", S), ("K", K), ("sgn", sgn), ("rot_mats", robot.rot_mats),
        ("trans", robot.trans), ("link_center", robot.link_center), ("mass", robot.mass),
        ("com", robot.com), ("inertia", robot.inertia), ("units", _unit_axes(robot)),
        ("armature", robot.armature[:F]), ("damping", robot.damping[:F]))}
    c["damped"] = any(d != 0.0 for d in robot.damping[:F])
    _CONSTS[key] = (robot, c)
    return c


@functools.lru_cache(maxsize=256)
def _broadcast(*shapes) -> torch.Size:
    """torch.broadcast_shapes, cached by the shapes (the closed loop meets a
    handful of shape tuples many thousand times)."""
    return torch.broadcast_shapes(*shapes)


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
    """a x b over the last axis, for operands of one shape (torch's fast
    path: linalg.cross broadcasting its operands costs three times as much
    on small tensors)."""
    return torch.linalg.cross(a, b, dim=-1)


def _axis_patterns(robot: RobotModel):
    """Per joint: the constant matrices C, S, K with Rot_axis(th) =
    cos(th) C + sin(th) S + K, and the sign of each joint angle.  A fixed
    joint (or one past num_factors) is C = S = 0, K = I."""
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


def _unit_axes(robot: RobotModel):
    """Per joint its signed unit axis [J, 3] (a zero row for a fixed joint or
    one past num_factors)."""
    E = np.zeros((robot.num_joints, 3))
    for i, axis in enumerate(int(a) for a in robot.axes):
        if axis != 0 and i < robot.num_factors:
            E[i, abs(axis) - 1] = 1.0 if axis > 0 else -1.0
    return E


def joint_rotations(robot: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """R_i = RPY_i @ Rot_axis(q_i): [..., J, 3, 3]."""
    k = _robot_consts(robot, q)
    J, F = robot.num_joints, robot.num_factors
    th = torch.zeros(q.shape[:-1] + (J,), dtype=q.dtype, device=q.device)
    th[..., :min(F, J)] = q[..., :min(F, J)]
    th = th * k["sgn"]
    c, s = torch.cos(th)[..., None, None], torch.sin(th)[..., None, None]
    R_axis = c * k["C"] + s * k["S"] + k["K"]
    return _mm(k["rot_mats"], R_axis)


def forward_kinematics(robot: RobotModel, q: torch.Tensor):
    """World rotation + position of each joint frame and link box centre:
    (R_w [..., J, 3, 3], p_w [..., J, 3], link_centers [..., J, 3])."""
    Rs = joint_rotations(robot, q)
    k = _robot_consts(robot, q)
    trans, link_c = k["trans"], k["link_center"]
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


def _flag(x, like: torch.Tensor):
    """A per-chain switch: a bool, or a 0 / 1 tensor broadcasting against the
    batch dims (as a float multiplier)."""
    return bool(x) if isinstance(x, bool) else _const(x, like)


def rnea(robot: RobotModel, q, qd, qd_aux, qdd, *, mass=None, com=None, inertia=None,
         set_gravity=True, include_armature=True, wrench_at=None, rotations=None):
    """Passivity-form RNEA torque [..., F].  mass/com/inertia default to the
    robot's nominal values; pass perturbed tensors for true-parameter or
    sensitivity evaluations.  wrench_at: a chain index; then the backward
    recursion's wrench (f, n) [..., 3] at that body is returned too,
    (tau, f, n) (the contact wrench's ground truth for grasp.py).

    Port-only: rotations, joint_rotations(robot, q) when the caller already
    has them (broadcasting against the batch dims); set_gravity and
    include_armature may be 0 / 1 tensors over the batch dims, so that
    chains differing in them run as one batched call.  Every chain's
    arithmetic is the per-chain call's: the link wrenches are formed for all
    links at once after the forward recursion, and the quantities one
    rotation moves are moved together."""
    J, F = robot.num_joints, robot.num_factors
    k = _robot_consts(robot, q)
    mass = k["mass"] if mass is None else _const(mass, q)
    com = k["com"] if com is None else _const(com, q)
    inertia = k["inertia"] if inertia is None else _const(inertia, q)
    Rs = joint_rotations(robot, q) if rotations is None else rotations
    grav, arm = _flag(set_gravity, q), _flag(include_armature, q)
    batch = _broadcast(
        q.shape[:-1], qd.shape[:-1], qd_aux.shape[:-1], qdd.shape[:-1], mass.shape[:-1],
        com.shape[:-2], inertia.shape[:-3], Rs.shape[:-3],
        *(x.shape for x in (grav, arm) if isinstance(x, torch.Tensor)))

    def full(x, trailing):
        return x.expand(batch + x.shape[x.dim() - trailing:])

    # one shape for every operand of a cross product (torch's fast path)
    Rs = full(Rs, 3).unbind(-3)
    trans = full(k["trans"], 2).unbind(-2)
    com = full(com, 2)
    qd, qd_aux, qdd = full(qd, 1), full(qd_aux, 1), full(qdd, 1)

    zero3 = torch.zeros(batch + (3,), dtype=q.dtype, device=q.device)
    w, w_aux, wdot = zero3, zero3, zero3
    lin_acc = zero3
    if grav is not False:
        lin_acc = zero3.clone()
        lin_acc[..., 2] = robot.gravity if grav is True else robot.gravity * grav
    units = k["units"]
    # each joint's e qd_i, e qdd_i, e qd_aux_i (its signed unit axis e), all
    # joints at once
    n_act = min(F, J)
    eqs, eqdds, eqas = ((units[:n_act] * x[..., :n_act, None]).unbind(-2)
                        for x in (qd, qdd, qd_aux))
    accs, ws, w_auxs, wdots = [], [], [], []
    for i in range(J):
        pre = lin_acc + _cross(wdot, trans[i]) + _cross(w, _cross(w_aux, trans[i]))
        lin_acc, w, w_aux, wdot = _mtv(Rs[i][..., None, :, :],
                                       torch.stack([pre, w, w_aux, wdot], -2)).unbind(-2)
        if int(robot.axes[i]) != 0 and i < F:
            eq = eqs[i]
            w = w + eq
            wdot = wdot + _cross(w_aux, eq) + eqdds[i]
            w_aux = w_aux + eqas[i]
        accs.append(lin_acc)
        ws.append(w)
        w_auxs.append(w_aux)
        wdots.append(wdot)
    acc, w, w_aux, wdot = (torch.stack(x, -2) for x in (accs, ws, w_auxs, wdots))
    inertia = full(inertia, 3)
    Fs = full(mass, 1)[..., None] * (acc + _cross(wdot, com) + _cross(w, _cross(w_aux, com)))
    Ns = _mv(inertia, wdot) + _cross(w_aux, _mv(inertia, w))
    CF = _cross(com, Fs).unbind(-2)
    Fs, Ns = Fs.unbind(-2), Ns.unbind(-2)

    f, n = zero3, zero3
    ns = [None] * J
    wrench = None
    for i in reversed(range(J)):
        if i + 1 < J:
            rf, rn = _mv(Rs[i + 1][..., None, :, :], torch.stack([f, n], -2)).unbind(-2)
        else:
            rf, rn = f, n
        n = Ns[i] + rn + CF[i] + _cross(trans[i + 1], rf)
        f = rf + Fs[i]
        if wrench_at is not None and i == wrench_at:
            wrench = (f, n)
        ns[i] = n
    # every joint i < F is actuated: tau_i = sign_i n_i[axis_i], the one
    # non-zero term of the sum with its signed unit axis
    tau = (torch.stack(ns[:F], -2) * units[:F]).sum(-1)
    if arm is not False:
        a = k["armature"]
        tau = tau + (a if arm is True else a * arm[..., None]) * qdd[..., :F]
    if k["damped"]:
        tau = tau + k["damping"] * qd[..., :F]
    if wrench_at is not None:
        return tau, wrench[0], wrench[1]
    return tau


def mass_matrix(robot: RobotModel, q, *, mass=None, com=None, inertia=None,
                include_armature: bool = True, rotations=None):
    """M(q) [..., F, F], columnwise via one RNEA over the F unit
    accelerations.  Overrides with a batch shape get a direction axis.
    rotations: joint_rotations(robot, q), where the caller has them."""
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
                include_armature=include_armature,
                rotations=None if rotations is None else rotations.unsqueeze(-4))
    return cols.transpose(-1, -2)


def coriolis_gravity(robot: RobotModel, q, qd, *, mass=None, com=None, inertia=None,
                     rotations=None):
    """C(q, qd) qd + g(q), the combined bias torque (rotations as in rnea)."""
    return rnea(robot, q, qd, qd, torch.zeros_like(q), mass=mass, com=com,
                inertia=inertia, set_gravity=True, include_armature=False,
                rotations=rotations)

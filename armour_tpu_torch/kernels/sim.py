"""Launchers of the closed-loop kernels K5 (rollout) and K6 (oracle_check).
Called by simulator.py for CUDA tensors only; each checks device, dtype,
shapes and contiguity, raises on anything its kernel does not take,
allocates the outputs with torch.empty / torch.zeros and launches on the
current stream."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import launched, record
from .build import launcher
from .collision import _require, _stream

MAXJ = 8
K5_LANES = (32, 64)       # threads per world of K5 (rollout.cu's instantiations)
CONTROLLER_IDS = {"robust": 0, "nominal": 1, "althoff": 2}

_f = ctypes.c_float
_p = ctypes.c_void_p


def _farr(n):
    return _f * n


class K5Robot(ctypes.Structure):
    _fields_ = [("J", ctypes.c_int), ("F", ctypes.c_int), ("axes", ctypes.c_int * MAXJ),
                ("trans", _farr((MAXJ + 1) * 3)), ("rot", _farr(MAXJ * 9)),
                ("mass", _farr(MAXJ)), ("com", _farr(MAXJ * 3)),
                ("inertia", _farr(MAXJ * 9)), ("armature", _farr(MAXJ)),
                ("damping", _farr(MAXJ)), ("gravity", _f), ("mass_unc", _f),
                ("inertia_unc", _f)]


class K5Args(ctypes.Structure):
    _fields_ = [("rb", K5Robot),
                ("q0", _p), ("qd0", _p), ("q_des", _p), ("qd_des", _p), ("qdd_des", _p),
                ("noise", _p), ("tmass", _p), ("tinertia", _p), ("tcom", _p),
                ("q_out", _p), ("qd_out", _p), ("q_log", _p), ("qd_log", _p),
                ("u_log", _p),
                ("k_r", _f), ("alpha", _f), ("v_max", _f), ("dt", _f), ("h", _f),
                ("half_h", _f), ("h6", _f),
                ("kp0", _f), ("kp1", _f), ("ki0", _f), ("ki1", _f), ("max_error", _f),
                ("W", ctypes.c_int), ("n", ctypes.c_int), ("substeps", ctypes.c_int),
                ("controller", ctypes.c_int)]


class K6Robot(ctypes.Structure):
    _fields_ = [("J", ctypes.c_int), ("F", ctypes.c_int), ("axes", ctypes.c_int * MAXJ),
                ("trans", _farr((MAXJ + 1) * 3)), ("rot", _farr(MAXJ * 9)),
                ("link_c", _farr(MAXJ * 3)), ("link_h", _farr(MAXJ * 3)),
                ("torque_lim", _farr(MAXJ)), ("pos_lb", _farr(MAXJ)),
                ("pos_ub", _farr(MAXJ)), ("speed_lim", _farr(MAXJ)),
                ("qe", _f), ("qde", _f)]


class K6Args(ctypes.Structure):
    _fields_ = [("rb", K6Robot),
                ("q", _p), ("qd", _p), ("u", _p), ("q_des", _p), ("qd_des", _p),
                ("centers", _p), ("gens", _p), ("mask", _p), ("flags", _p),
                ("overlaps", _p),
                ("W", ctypes.c_int), ("N", ctypes.c_int), ("O", ctypes.c_int)]


def _fill(arr, values) -> None:
    """Copy values (numpy, float32-rounded) into a ctypes array."""
    flat = np.asarray(values, dtype=np.float64).reshape(-1)
    if flat.size > len(arr):
        raise ValueError(f"{flat.size} values for a field of {len(arr)}")
    for i, v in enumerate(flat.astype(np.float32)):
        arr[i] = float(v)


def _chain(rb, robot) -> None:
    J, F = robot.num_joints, robot.num_factors
    if J > MAXJ or F > J:
        raise ValueError(f"the closed-loop kernels take F <= J <= {MAXJ}, got F={F} J={J}")
    rb.J, rb.F = J, F
    for i in range(J):
        rb.axes[i] = int(robot.axes[i])
    _fill(rb.trans, robot.trans[: J + 1])
    _fill(rb.rot, robot.rot_mats[:J])


def _k5_robot(robot) -> K5Robot:
    rb = K5Robot()
    _chain(rb, robot)
    _fill(rb.mass, robot.mass)
    _fill(rb.com, robot.com)
    _fill(rb.inertia, robot.inertia)
    _fill(rb.armature, robot.armature)
    _fill(rb.damping, robot.damping)
    rb.gravity = float(np.float32(robot.gravity))
    rb.mass_unc = float(np.float32(robot.mass_uncertainty))
    rb.inertia_unc = float(np.float32(robot.inertia_uncertainty))
    return rb


def _k6_robot(robot, cfg) -> K6Robot:
    rb = K6Robot()
    _chain(rb, robot)
    _fill(rb.link_c, robot.link_center)
    _fill(rb.link_h, robot.link_generators)
    _fill(rb.torque_lim, robot.torque_limits)
    _fill(rb.pos_lb, robot.position_limits_lb)
    _fill(rb.pos_ub, robot.position_limits_ub)
    _fill(rb.speed_lim, robot.speed_limits)
    rb.qe = float(np.float32(cfg.ub.qe))
    rb.qde = float(np.float32(cfg.ub.qde))
    return rb


def k5_chains(J: int, F: int) -> int:
    """Independent RNEA chains of one K5 control step: the nominal torque,
    the nominal r-pass, 2J perturbation chains at each of the two, and F
    mass-matrix columns."""
    return 2 + 4 * J + F


def k5_geometry(J: int, F: int) -> int:
    """Threads per world of K5: 32 when every chain of a step fits one
    warp, else 64 (two warps; the controller then runs beside the
    Gauss-Jordan inverse), so that all chains run in one round."""
    if not 1 <= F <= J <= MAXJ:
        raise ValueError(f"the closed-loop kernels take 1 <= F <= J <= {MAXJ}, got F={F} J={J}")
    return next(n for n in K5_LANES if k5_chains(J, F) <= n)


def rollout(robot, cfg, q, qd, q_des, qd_des, qdd_des, tp, control_dt, substeps=2,
            controller="robust", noise=None, gains=None):
    """K5: one move of W worlds.  q, qd [W, F]; q_des/qd_des/qdd_des
    [W, n, F]; tp TrueParams (mass [W, J], inertia [W, J, 3, 3], com
    [W, J, 3]); noise [W, n, 2, F] or None.  Returns (q, qd, q_log, qd_log,
    u_log) as rollout_plain does."""
    from ..controller import ALTHOFF_DEFAULT

    gains = ALTHOFF_DEFAULT if gains is None else gains
    Wn, F = q.shape
    n = q_des.shape[1]
    J = robot.num_joints
    if controller not in CONTROLLER_IDS:
        raise ValueError(controller)
    _require(q, "q", (Wn, F))
    _require(qd, "qd", (Wn, F))
    for name, t in (("q_des", q_des), ("qd_des", qd_des), ("qdd_des", qdd_des)):
        _require(t, name, (Wn, n, F))
    if noise is not None:
        _require(noise, "noise", (Wn, n, 2, F))
    _require(tp.mass, "mass", (Wn, J))
    _require(tp.inertia, "inertia", (Wn, J, 3, 3))
    _require(tp.com, "com", (Wn, J, 3))
    if substeps < 1:
        raise ValueError("substeps must be >= 1")
    dev = q.device
    q_out = torch.empty(Wn, F, device=dev, dtype=torch.float32)
    qd_out = torch.empty(Wn, F, device=dev, dtype=torch.float32)
    logs = [torch.empty(Wn, n, F, device=dev, dtype=torch.float32) for _ in range(3)]
    record("rollout", (tuple(q_des.shape), controller, noise is not None),
           dict(q=q, qd=qd, q_des=q_des, qd_des=qd_des, qdd_des=qdd_des,
                tp=tp, control_dt=control_dt, substeps=substeps, controller=controller,
                noise=noise, gains=gains))
    if Wn * n:
        h = control_dt / substeps
        args = K5Args(_k5_robot(robot),
                      q.data_ptr(), qd.data_ptr(), q_des.data_ptr(), qd_des.data_ptr(),
                      qdd_des.data_ptr(), noise.data_ptr() if noise is not None else None,
                      tp.mass.data_ptr(), tp.inertia.data_ptr(), tp.com.data_ptr(),
                      q_out.data_ptr(), qd_out.data_ptr(),
                      *(t.data_ptr() for t in logs),
                      cfg.ub.k_r, cfg.ub.alpha, cfg.ub.v_max, control_dt, h, 0.5 * h, h / 6.0,
                      gains.kp[0], gains.kp[1], gains.ki[0], gains.ki[1], gains.max_error,
                      Wn, n, substeps, CONTROLLER_IDS[controller])
        fn = launcher("rollout", "k5_launch",
                      [ctypes.POINTER(K5Args), ctypes.c_int, ctypes.c_void_p])
        err = fn(ctypes.byref(args), k5_geometry(J, F), _stream(q))
        if err:
            raise RuntimeError(f"rollout launch failed: cudaError {err}")
        launched("rollout")
    else:
        q_out.copy_(q)
        qd_out.copy_(qd)
    return (q_out, qd_out, *logs)


def oracle_check(robot, cfg, q, qd, u, q_des, qd_des, centers, generators, mask):
    """K6: (flags [W, 4] bool, overlaps [W] int64) of logs [W, N, F]
    against obstacles centers [W, O, 3], generators [W, O, 3, 3], mask
    [W, O]."""
    Wn, N, F = q.shape
    O = centers.shape[1]
    for name, t in (("q", q), ("qd", qd), ("u", u), ("q_des", q_des), ("qd_des", qd_des)):
        _require(t, name, (Wn, N, F))
    _require(centers, "centers", (Wn, O, 3))
    _require(generators, "generators", (Wn, O, 3, 3))
    _require(mask, "mask", (Wn, O), torch.bool)
    dev = q.device
    flags = torch.zeros(Wn, 4, device=dev, dtype=torch.int32)
    overlaps = torch.zeros(Wn, device=dev, dtype=torch.int64)
    record("oracle_check", (tuple(q.shape), O),
           dict(q=q, qd=qd, u=u, q_des=q_des, qd_des=qd_des, centers=centers,
                generators=generators, mask=mask))
    if Wn * N:
        args = K6Args(_k6_robot(robot, cfg), q.data_ptr(), qd.data_ptr(), u.data_ptr(),
                      q_des.data_ptr(), qd_des.data_ptr(), centers.data_ptr(),
                      generators.data_ptr(), mask.data_ptr(), flags.data_ptr(),
                      overlaps.data_ptr(), Wn, N, O)
        fn = launcher("oracle_check", "k6_launch", [ctypes.POINTER(K6Args), ctypes.c_void_p])
        err = fn(ctypes.byref(args), _stream(q))
        if err:
            raise RuntimeError(f"oracle_check launch failed: cudaError {err}")
        launched("oracle_check")
    return flags != 0, overlaps

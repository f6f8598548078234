"""Launchers of the closed-loop kernels K5 (rollout) and K6 (oracle_check).
Called by simulator.py for CUDA tensors only; each checks device, dtype,
shapes and contiguity, raises on anything its kernel does not take,
allocates the outputs with torch.empty (K6's one output buffer is zeroed by
its launcher) and launches on the current stream.

k5_geometry and k6_geometry are K5's and K6's launch geometries, pure
Python so that the CPU tests check them."""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import H100_SMS, launched, record
from .build import launcher
from .collision import _require, _stream

MAXJ = 8
K5_LANES = (32, 64)       # threads per world of K5 (rollout.cu's instantiations)
K6_STEPS = 32             # logged steps of a K6 chunk, one per lane (csrc/oracle_check.cu)
K6_THREADS = 256
K6_MAXSPLIT = 16          # blocks that may share one chunk's (link, obstacle) pairs
K6_FRAME, K6_OBS = 27, 32  # floats of a staged link frame and obstacle
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
                ("centers", _p), ("gens", _p), ("mask", _p), ("out", _p),
                ("W", ctypes.c_int), ("N", ctypes.c_int), ("O", ctypes.c_int),
                ("chunks", ctypes.c_int), ("splits", ctypes.c_int)]


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


_K6_ARGS = {}


def _k6_args(robot, cfg, device) -> K6Args:
    """K6's arguments with the robot's part filled, one per (robot, cfg,
    device) object and reused by every call (the launch copies them): forming
    the robot's part costs more host time than the kernel takes.  RobotModel
    and ArmourConfig are frozen; the entry keeps both alive, so their ids
    stay theirs."""
    key = (id(robot), id(cfg), str(device))
    hit = _K6_ARGS.get(key)
    if hit is None or hit[0] is not robot or hit[1] is not cfg:
        hit = (robot, cfg, K6Args(_k6_robot(robot, cfg)))
        _K6_ARGS[key] = hit
    return hit[2]


@dataclasses.dataclass(frozen=True)
class K6Geometry:
    """K6's grid: per world `chunks` chunks of K6_STEPS logged steps, each
    taken by `splits` blocks of K6_THREADS threads."""

    chunks: int
    splits: int
    grid: int

    def block(self, b: int):
        """(world, first step, split) of block b (the kernel's indexing)."""
        w, r = divmod(b, self.chunks * self.splits)
        chunk, split = divmod(r, self.splits)
        return w, chunk * K6_STEPS, split

    def pairs(self, split: int, warp: int, J: int, nobs: int):
        """The (link, real obstacle) pairs warp `warp` of a block of split
        `split` tests, a lane per logged step of its chunk."""
        n = J * nobs
        return [divmod(p, nobs) for p in range(split + self.splits * warp, n,
                                               self.splits * (K6_THREADS // 32))]


def k6_smem(O: int) -> int:
    """Bytes of dynamic shared memory of a K6 block (oracle_check.cu:k6_smem):
    the chunk's link frames and the staged obstacles."""
    return 4 * (MAXJ * K6_FRAME * K6_STEPS + K6_OBS * O)


@functools.lru_cache(maxsize=64)
def k6_geometry(Wn: int, N: int, sms: int = H100_SMS) -> K6Geometry:
    """Chunks of K6_STEPS logged steps; where the worlds x chunks give fewer
    than 2 x sms blocks, up to K6_MAXSPLIT blocks share each chunk's pairs
    so that the grid reaches 2 x sms."""
    chunks = -(-N // K6_STEPS)
    base = max(1, Wn * chunks)
    splits = max(1, min(K6_MAXSPLIT, -(-2 * sms // base)))
    return K6Geometry(chunks=chunks, splits=splits, grid=Wn * chunks * splits)


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
    if F != robot.num_factors:
        raise ValueError(f"oracle_check: logs of {F} joints for a robot of {robot.num_factors}")
    dev = q.device
    record("oracle_check", (tuple(q.shape), O),
           dict(q=q, qd=qd, u=u, q_des=q_des, qd_des=qd_des, centers=centers,
                generators=generators, mask=mask))
    if not Wn * N:
        return (torch.zeros(Wn, 4, device=dev, dtype=torch.bool),
                torch.zeros(Wn, device=dev, dtype=torch.int64))
    # one buffer, zeroed by the launcher: overlaps [W] int64, then flags [W, 4] bytes
    out = torch.empty(12 * Wn, device=dev, dtype=torch.bool)
    geo = k6_geometry(Wn, N, torch.cuda.get_device_properties(dev).multi_processor_count)
    args = _k6_args(robot, cfg, dev)
    args.q, args.qd, args.u = q.data_ptr(), qd.data_ptr(), u.data_ptr()
    args.q_des, args.qd_des = q_des.data_ptr(), qd_des.data_ptr()
    args.centers, args.gens, args.mask = (centers.data_ptr(), generators.data_ptr(),
                                          mask.data_ptr())
    args.out = out.data_ptr()
    args.W, args.N, args.O, args.chunks, args.splits = Wn, N, O, geo.chunks, geo.splits
    fn = launcher("oracle_check", "k6_launch", [ctypes.POINTER(K6Args), ctypes.c_void_p])
    err = fn(ctypes.byref(args), _stream(q))
    if err:
        raise RuntimeError(f"oracle_check launch failed: cudaError {err}")
    launched("oracle_check")
    return out.as_strided((Wn, 4), (4, 1), 8 * Wn), out[:8 * Wn].view(torch.int64)

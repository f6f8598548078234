"""Launchers of the joint-reachable-set kernels K11 (jrs_armtd: the
constant-acceleration family, called by armtd.build_jrs_armtd) and K12
(jrs_bernstein: the Bernstein family, called by jrs.build_jrs), for CUDA
tensors only.  Each checks device, dtype, shapes and contiguity, raises on
anything its kernel does not take, allocates every output with torch.empty
(the kernel writes each entry, zeros included) and launches on the current
stream without a host synchronisation.  The robot's and config's part of
the arguments is built once and kept in basis.kernel_args.  Both kernels
write through one writer (csrc/jrs_tail.cuh), launched with the (slabs a
block, grid) of jrs_geometry."""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import H100_SMS, launched, record
from .build import launcher, on_device
from .collision import _require
from ..jrs import JRS, QDD_K_DEP_MAXIMA, QDD_K_DEP_MINIMA, TrajectoryCoeffs
from ..pz.basis import KBasis, error_layout
from ..pz.bpz import BPZ

MAXJ, MAXF = 10, 8          # csrc/jrs_tail.cuh: JRS_MAXJ (joints + 1), JRS_MAXF
MAX_G = 16                  # csrc/jrs_tail.cuh: JRS_MAX_G, the slabs a block holds
THREADS = 256               # K11_THREADS, K12_THREADS
BLOCKS_PER_SM = 4           # K11_BLOCKS_PER_SM, K12_BLOCKS_PER_SM


def jrs_geometry(WT: int, sms: int = H100_SMS) -> tuple:
    """(G, blocks) of K11 / K12 for W T slabs: G slabs a block (at most
    MAX_G), as few as keep every SM's BLOCKS_PER_SM blocks busy, and no more
    blocks than are resident at once (a grid-stride loop takes the rest)."""
    G = min(MAX_G, max(1, -(-WT // (sms * BLOCKS_PER_SM))))
    return G, max(1, min(-(-WT // G), sms * BLOCKS_PER_SM))


def _sms(x) -> int:
    return torch.cuda.get_device_properties(x.device).multi_processor_count


class JrsTrig(ctypes.Structure):
    _fields_ = [("two_pi", ctypes.c_float), ("pi", ctypes.c_float),
                ("half_pi", ctypes.c_float), ("neg_half_pi", ctypes.c_float)]


class K11Args(ctypes.Structure):
    _fields_ = [("q0", ctypes.c_void_p), ("qd0", ctypes.c_void_p),
                ("R_coef", ctypes.c_void_p), ("R_egen", ctypes.c_void_p),
                ("R_rad", ctypes.c_void_p), ("v_coef", ctypes.c_void_p),
                ("v_egen", ctypes.c_void_p), ("v_rad", ctypes.c_void_p),
                ("traj", ctypes.c_void_p),
                ("W", ctypes.c_int), ("T", ctypes.c_int), ("J", ctypes.c_int),
                ("F", ctypes.c_int), ("B", ctypes.c_int), ("E", ctypes.c_int),
                ("e_cos", ctypes.c_int), ("e_sin", ctypes.c_int),
                ("e_qde", ctypes.c_int), ("e_qdae", ctypes.c_int), ("e_qddae", ctypes.c_int),
                ("lin", ctypes.c_int * MAXF), ("axis", ctypes.c_int * MAXJ),
                ("rotm", ctypes.c_float * (MAXJ * 9)),
                ("trig", JrsTrig),
                ("step", ctypes.c_float), ("tp", ctypes.c_float), ("ts", ctypes.c_float),
                ("eps", ctypes.c_float),
                ("brk", ctypes.c_float), ("neg_tp_brk", ctypes.c_float),
                ("half_tp2", ctypes.c_float), ("half_tp_brk", ctypes.c_float),
                ("pi24", ctypes.c_float), ("pi3", ctypes.c_float),
                ("qe", ctypes.c_float), ("qde", ctypes.c_float), ("qdae", ctypes.c_float),
                ("qddae", ctypes.c_float)]


def _template(robot, cfg, basis: KBasis) -> K11Args:
    """The robot's, config's and basis' part of K11's arguments, formed once
    and kept in basis.kernel_args.  Every constant is the Python double the
    plain version computes, rounded once to float32 by ctypes."""
    J, F = robot.num_joints, robot.num_factors
    ub = cfg.ub
    key = ("k11", J, F, cfg.num_time_steps, cfg.t_plan, cfg.duration, ub.qe, ub.qde, ub.qdae,
           ub.qddae) + tuple(np.asarray(x).tobytes() for x in (robot.axes, robot.rot_mats))
    tab = basis.kernel_args
    if key in tab:
        return tab[key]
    if J + 1 > MAXJ or F > MAXF or F != basis.nf:
        raise ValueError(f"jrs_armtd takes J + 1 <= {MAXJ} and F = basis factors <= {MAXF}, "
                         f"got J = {J}, F = {F}, basis nf = {basis.nf}")
    lay = error_layout(basis.nf)
    a = K11Args()
    a.J, a.F, a.B, a.E = J, F, basis.size, lay["size"]
    a.e_cos, a.e_sin = lay["cosqe"].start, lay["sinqe"].start
    a.e_qde, a.e_qdae, a.e_qddae = lay["qde"].start, lay["qdae"].start, lay["qddae"].start
    for f in range(F):
        a.lin[f] = int(basis.lin_idx[f])
    rotm = np.asarray(robot.rot_mats, dtype=np.float64).reshape(J, 9)
    for j in range(J):
        a.axis[j] = int(robot.axes[j]) if j < F else 0
        for i in range(9):
            a.rotm[j * 9 + i] = float(rotm[j, i])
    a.trig = JrsTrig(2.0 * math.pi, math.pi, math.pi / 2, -math.pi / 2)
    tp, ts = cfg.t_plan, cfg.duration
    brk = 1.0 / (ts - tp)
    a.step, a.tp, a.ts, a.eps = ts / cfg.num_time_steps, tp, ts, 1e-9
    a.brk, a.neg_tp_brk = brk, -tp * brk
    a.half_tp2, a.half_tp_brk = 0.5 * tp * tp, 0.5 * tp * brk
    a.pi24, a.pi3 = math.pi / 24, math.pi / 3.0
    a.qe, a.qde, a.qdae, a.qddae = ub.qe, ub.qde, ub.qdae, ub.qddae
    tab[key] = a
    return a


def jrs_armtd(q0, qd0, robot, cfg, basis: KBasis) -> JRS:
    """K11: the constant-acceleration JRS of q0 / qd0 [W, F] (float32 on the
    card); Rt views R's transposes, the trajectory's zeros view one row."""
    Wn = q0.shape[0] if q0.dim() == 2 else -1
    F = robot.num_factors
    _require(q0, "q0", (Wn, F))
    _require(qd0, "qd0", (Wn, F))
    if cfg.num_time_steps % 2:
        raise ValueError("jrs_armtd takes an even num_time_steps")
    tmpl = _template(robot, cfg, basis)
    T, J, B, E = cfg.num_time_steps, tmpl.J, tmpl.B, tmpl.E
    dev, f32 = q0.device, torch.float32
    R = BPZ(coef=torch.empty(Wn, T, J + 1, 3, 3, B, device=dev, dtype=f32),
            egen=torch.empty(Wn, T, J + 1, 3, 3, E, device=dev, dtype=f32),
            rad=torch.empty(Wn, T, J + 1, 3, 3, device=dev, dtype=f32))
    v_coef = torch.empty(3, Wn, T, F, B, device=dev, dtype=f32)
    v_egen = torch.empty(3, Wn, T, F, E, device=dev, dtype=f32)
    v_rad = torch.empty(3, Wn, T, F, device=dev, dtype=f32)
    traj = torch.empty(Wn, 3, F, device=dev, dtype=f32)
    record("jrs_armtd", (Wn, T), (q0, qd0, robot, cfg, basis))
    if Wn * T:
        args = K11Args()
        ctypes.memmove(ctypes.addressof(args), ctypes.addressof(tmpl), ctypes.sizeof(K11Args))
        args.q0, args.qd0 = q0.data_ptr(), qd0.data_ptr()
        args.R_coef, args.R_egen, args.R_rad = (R.coef.data_ptr(), R.egen.data_ptr(),
                                                R.rad.data_ptr())
        args.v_coef, args.v_egen, args.v_rad = (v_coef.data_ptr(), v_egen.data_ptr(),
                                                v_rad.data_ptr())
        args.traj = traj.data_ptr()
        args.W, args.T = Wn, T
        G, blocks = jrs_geometry(Wn * T, _sms(q0))
        fn = launcher("jrs_armtd", "k11_launch", [ctypes.POINTER(K11Args), ctypes.c_int,
                                                  ctypes.c_int, ctypes.c_void_p])
        with on_device(q0) as stream:
            err = fn(ctypes.byref(args), G, blocks, stream)
        if err:
            raise RuntimeError(f"jrs_armtd launch failed: cudaError {err}")
        launched("jrs_armtd")
    Rt = BPZ(coef=R.coef[:, :, :J].transpose(3, 4), egen=R.egen[:, :, :J].transpose(3, 4),
             rad=R.rad[:, :, :J].transpose(3, 4))
    vel = [BPZ(coef=v_coef[p], egen=v_egen[p], rad=v_rad[p]) for p in range(3)]
    tr = TrajectoryCoeffs(q0=q0, qd0=qd0, qdd0=traj[:, 2], Tqd0=traj[:, 1],
                          TTqdd0=traj[:, 2], k_scale=traj[:, 0], family="armtd")
    return JRS(R=R, Rt=Rt, qd=vel[0], qda=vel[1], qdda=vel[2], traj=tr)


class K12Args(ctypes.Structure):
    _fields_ = [("q0", ctypes.c_void_p), ("qd0", ctypes.c_void_p), ("qdd0", ctypes.c_void_p),
                ("R_coef", ctypes.c_void_p), ("R_egen", ctypes.c_void_p),
                ("R_rad", ctypes.c_void_p), ("v_coef", ctypes.c_void_p),
                ("v_egen", ctypes.c_void_p), ("v_rad", ctypes.c_void_p),
                ("traj", ctypes.c_void_p),
                ("W", ctypes.c_int), ("T", ctypes.c_int), ("J", ctypes.c_int),
                ("F", ctypes.c_int), ("B", ctypes.c_int), ("E", ctypes.c_int),
                ("e_cos", ctypes.c_int), ("e_sin", ctypes.c_int),
                ("e_qde", ctypes.c_int), ("e_qdae", ctypes.c_int), ("e_qddae", ctypes.c_int),
                ("lin", ctypes.c_int * MAXF), ("axis", ctypes.c_int * MAXJ),
                ("rotm", ctypes.c_float * (MAXJ * 9)), ("k_range", ctypes.c_float * MAXF),
                ("trig", JrsTrig),
                ("ds", ctypes.c_float), ("dur", ctypes.c_float), ("dur2", ctypes.c_float),
                ("acc_max", ctypes.c_float), ("acc_min", ctypes.c_float),
                ("qe", ctypes.c_float), ("qde", ctypes.c_float), ("qdae", ctypes.c_float),
                ("qddae", ctypes.c_float)]


def _template_k12(robot, cfg, basis: KBasis) -> K12Args:
    """The robot's, config's and basis' part of K12's arguments, formed once
    and kept in basis.kernel_args.  Every constant is the Python double the
    plain version computes (1 / T, duration, duration * duration, the
    acceleration's extrema, k_range, the ultimate bound's radii), rounded
    once to float32 by ctypes."""
    J, F = robot.num_joints, robot.num_factors
    ub = cfg.ub
    key = ("k12", J, F, cfg.num_time_steps, cfg.duration, tuple(cfg.k_range), ub.qe, ub.qde,
           ub.qdae, ub.qddae) + tuple(np.asarray(x).tobytes() for x in (robot.axes,
                                                                        robot.rot_mats))
    tab = basis.kernel_args
    if key in tab:
        return tab[key]
    if J + 1 > MAXJ or F > MAXF or F != basis.nf:
        raise ValueError(f"jrs_bernstein takes J + 1 <= {MAXJ} and F = basis factors <= "
                         f"{MAXF}, got J = {J}, F = {F}, basis nf = {basis.nf}")
    if len(cfg.k_range) != F:
        raise ValueError(
            f"cfg.k_range has {len(cfg.k_range)} entries but the robot has "
            f"{F} actuated joints; use ArmourConfig.for_robot(robot, ...)")
    lay = error_layout(basis.nf)
    a = K12Args()
    a.J, a.F, a.B, a.E = J, F, basis.size, lay["size"]
    a.e_cos, a.e_sin = lay["cosqe"].start, lay["sinqe"].start
    a.e_qde, a.e_qdae, a.e_qddae = lay["qde"].start, lay["qdae"].start, lay["qddae"].start
    rotm = np.asarray(robot.rot_mats, dtype=np.float64).reshape(J, 9)
    for f in range(F):
        a.lin[f] = int(basis.lin_idx[f])
        a.k_range[f] = float(cfg.k_range[f])
    for j in range(J):
        a.axis[j] = int(robot.axes[j]) if j < F else 0
        for i in range(9):
            a.rotm[j * 9 + i] = float(rotm[j, i])
    a.trig = JrsTrig(2.0 * math.pi, math.pi, math.pi / 2, -math.pi / 2)
    dur = cfg.duration
    a.ds, a.dur, a.dur2 = 1.0 / cfg.num_time_steps, dur, dur * dur
    a.acc_max, a.acc_min = QDD_K_DEP_MAXIMA, QDD_K_DEP_MINIMA
    a.qe, a.qde, a.qdae, a.qddae = ub.qe, ub.qde, ub.qdae, ub.qddae
    tab[key] = a
    return a


def jrs_bernstein(q0, qd0, qdd0, robot, cfg, basis: KBasis) -> JRS:
    """K12: the Bernstein JRS of q0 / qd0 / qdd0 [W, F] (float32 on the
    card); Rt views R's transposes, the trajectory scalars view one
    [W, 3, F] buffer (k_range, Tqd0, TTqdd0)."""
    Wn = q0.shape[0] if q0.dim() == 2 else -1
    F = robot.num_factors
    _require(q0, "q0", (Wn, F))
    _require(qd0, "qd0", (Wn, F))
    _require(qdd0, "qdd0", (Wn, F))
    tmpl = _template_k12(robot, cfg, basis)
    T, J, B, E = cfg.num_time_steps, tmpl.J, tmpl.B, tmpl.E
    dev, f32 = q0.device, torch.float32
    R = BPZ(coef=torch.empty(Wn, T, J + 1, 3, 3, B, device=dev, dtype=f32),
            egen=torch.empty(Wn, T, J + 1, 3, 3, E, device=dev, dtype=f32),
            rad=torch.empty(Wn, T, J + 1, 3, 3, device=dev, dtype=f32))
    v_coef = torch.empty(3, Wn, T, F, B, device=dev, dtype=f32)
    v_egen = torch.empty(3, Wn, T, F, E, device=dev, dtype=f32)
    v_rad = torch.empty(3, Wn, T, F, device=dev, dtype=f32)
    traj = torch.empty(Wn, 3, F, device=dev, dtype=f32)
    record("jrs_bernstein", (Wn, T), (q0, qd0, qdd0, robot, cfg, basis))
    if Wn * T:
        args = K12Args()
        ctypes.memmove(ctypes.addressof(args), ctypes.addressof(tmpl), ctypes.sizeof(K12Args))
        args.q0, args.qd0, args.qdd0 = q0.data_ptr(), qd0.data_ptr(), qdd0.data_ptr()
        args.R_coef, args.R_egen, args.R_rad = (R.coef.data_ptr(), R.egen.data_ptr(),
                                                R.rad.data_ptr())
        args.v_coef, args.v_egen, args.v_rad = (v_coef.data_ptr(), v_egen.data_ptr(),
                                                v_rad.data_ptr())
        args.traj = traj.data_ptr()
        args.W, args.T = Wn, T
        G, blocks = jrs_geometry(Wn * T, _sms(q0))
        fn = launcher("jrs_bernstein", "k12_launch", [ctypes.POINTER(K12Args), ctypes.c_int,
                                                      ctypes.c_int, ctypes.c_void_p])
        with on_device(q0) as stream:
            err = fn(ctypes.byref(args), G, blocks, stream)
        if err:
            raise RuntimeError(f"jrs_bernstein launch failed: cudaError {err}")
        launched("jrs_bernstein")
    Rt = BPZ(coef=R.coef[:, :, :J].transpose(3, 4), egen=R.egen[:, :, :J].transpose(3, 4),
             rad=R.rad[:, :, :J].transpose(3, 4))
    vel = [BPZ(coef=v_coef[p], egen=v_egen[p], rad=v_rad[p]) for p in range(3)]
    tr = TrajectoryCoeffs(q0=q0, qd0=qd0, qdd0=qdd0, Tqd0=traj[:, 1], TTqdd0=traj[:, 2],
                          k_scale=traj[:, 0])
    return JRS(R=R, Rt=Rt, qd=vel[0], qda=vel[1], qdda=vel[2], traj=tr)

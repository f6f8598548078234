"""Launchers of the reach-set chain kernels K9 (fk_chain: the PZ forward
kinematics) and K10 (rnea_chain: the PZ RNEA for P <= 2 parameter sets).
Called by kinematics.forward_occupancy and dynamics.rnea_pz_sets for CUDA
tensors only; each checks device, dtype, shapes and contiguity, raises on
anything its kernel does not take, allocates the outputs with torch.empty
and launches on the current stream."""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, record
from .build import launcher
from .pz import upload_tables
from ..pz.basis import KBasis, error_layout
from ..pz.bpz import BPZ

MAX_J, MAX_P = 8, 2

_F3 = ctypes.c_float * 3
_PTRS = [(n, ctypes.c_void_p) for n in ("rc", "re", "rr")]


class K9Args(ctypes.Structure):
    _fields_ = _PTRS + [(n, ctypes.c_void_p) for n in ("bc", "be", "br", "lc", "le", "lr")] + [
        ("J", ctypes.c_int), ("Jr", ctypes.c_int), ("slop", ctypes.c_float),
        ("trans", _F3 * (MAX_J + 1))]


class K10Args(ctypes.Structure):
    _fields_ = _PTRS + [(n, ctypes.c_void_p) for n in (
        "qc", "qe", "qr", "ac", "ae", "ar", "dc", "de", "dr", "uc", "ue", "ur")] + [
        ("T", ctypes.c_int), ("J", ctypes.c_int), ("P", ctypes.c_int),
        ("slop", ctypes.c_float), ("gravity", ctypes.c_float),
        ("trans", _F3 * (MAX_J + 1)), ("com", _F3 * MAX_J),
        ("mc", (ctypes.c_float * MAX_P) * MAX_J), ("mr", (ctypes.c_float * MAX_P) * MAX_J),
        ("Ic", ((ctypes.c_float * 9) * MAX_P) * MAX_J),
        ("Ir", ((ctypes.c_float * 9) * MAX_P) * MAX_J),
        ("ax", ctypes.c_int * MAX_J), ("sgn", ctypes.c_float * MAX_J),
        ("rv", ctypes.c_float * MAX_J), ("arm", ctypes.c_float * MAX_J),
        ("damp", ctypes.c_float * MAX_J)]


def _require(p: BPZ, what: str, shape) -> BPZ:
    """p as contiguous float32 CUDA tensors of value shape `shape`."""
    for t in (p.coef, p.egen, p.rad):
        if not t.is_cuda:
            raise ValueError(f"{what}: all operands must be CUDA tensors")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: the kernel takes float32, got {t.dtype}")
    if tuple(p.rad.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(p.rad.shape)}")
    return BPZ(coef=p.coef.contiguous(), egen=p.egen.contiguous(), rad=p.rad.contiguous())


def _ptrs(p: BPZ):
    return p.coef.data_ptr(), p.egen.data_ptr(), p.rad.data_ptr()


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _empty(shape, B: int, E: int, like: torch.Tensor) -> BPZ:
    kw = dict(device=like.device, dtype=torch.float32)
    return BPZ(coef=torch.empty(*shape, B, **kw), egen=torch.empty(*shape, E, **kw),
               rad=torch.empty(*shape, **kw))


def _widths(basis: KBasis, R: BPZ, what: str):
    B, E = R.coef.shape[-1], R.egen.shape[-1]
    if B != basis.size or E != error_layout(basis.nf)["size"]:
        raise ValueError(f"{what}: operand widths do not match the basis")
    return B, E


def _launch(name: str, symbol: str, argtype, args, blocks: int, ld: int, like) -> None:
    fn = launcher(name, symbol, [ctypes.POINTER(argtype), ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_void_p])
    err = fn(ctypes.byref(args), blocks, ld, _stream(like))
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def fk_chain(jrs, robot, cfg, basis: KBasis) -> BPZ:
    """K9: the link PZs [W, T, J, 3] of the forward-kinematics chain
    (kinematics.forward_occupancy_plain's result)."""
    from ..kinematics import link_box_pz

    Wn, T, Jr = jrs.R.rad.shape[:3]
    J = robot.num_joints
    if J > MAX_J or Jr < J:
        raise ValueError(f"fk_chain takes at most {MAX_J} joints, got {J} (R holds {Jr})")
    R = _require(jrs.R, "fk_chain", (Wn, T, Jr, 3, 3))
    B, E = _widths(basis, R, "fk_chain")
    boxes = link_box_pz(robot, basis, torch.float32, R.coef.device)
    links = _empty((Wn, T, J, 3), B, E, R.coef)
    args = K9Args()
    args.rc, args.re, args.rr = _ptrs(R)
    args.bc, args.be, args.br = _ptrs(boxes)
    args.lc, args.le, args.lr = _ptrs(links)
    args.J, args.Jr, args.slop = J, Jr, float(cfg.float_slop)
    for i in range(J):
        args.trans[i][:] = [float(x) for x in robot.trans[i]]
    record("fk_chain", tuple(R.rad.shape), (jrs, robot, cfg, basis))
    if Wn * T:
        upload_tables("fk_chain", "k9_tables", basis, E)
        _launch("fk_chain", "k9_launch", K9Args, args, Wn * T, B + E + 1, R.coef)
    return links


def chain_params(robot, sets, basis: KBasis) -> dict:
    """The robot's constants as K10 reads them: joint axes, the interval
    operands (centre, radius) of mass and inertia per parameter set, exactly
    as dynamics._inertial_pzs / bpz.interval_operand form them in float32."""
    from ..dynamics import _inertial_pzs
    from ..pz import bpz

    mass_pz, inertia_pz, _ = _inertial_pzs(robot, basis, torch.float32, "cpu", sets)
    mc, mr = bpz.interval_operand(mass_pz)            # [J, P]
    Ic, Ir = bpz.interval_operand(inertia_pz)         # [J, P, 3, 3]
    J = robot.num_joints
    ax, sgn, rv = [], [], []
    for i in range(J):
        rev = robot.axes[i] != 0 and i < robot.num_factors
        ax.append(abs(int(robot.axes[i])) - 1 if rev else 0)
        sgn.append((1.0 if robot.axes[i] > 0 else -1.0) if rev else 0.0)
        rv.append(1.0 if rev else 0.0)
    return {"mc": mc.numpy(), "mr": mr.numpy(), "Ic": Ic.reshape(J, -1, 9).numpy(),
            "Ir": Ir.reshape(J, -1, 9).numpy(), "ax": ax, "sgn": sgn, "rv": rv}


def rnea_chain(jrs, robot, cfg, basis: KBasis, sets=("nom", "int")) -> BPZ:
    """K10: the PZ RNEA torque u [W, P, T, F] for P = len(sets) <= 2
    parameter sets without COM uncertainty (dynamics.rnea_pz_sets_plain's
    result)."""
    Wn, T, Jr = jrs.R.rad.shape[:3]
    J, F, P = robot.num_joints, robot.num_factors, len(sets)
    if J > MAX_J or Jr != J + 1 or F != J or not 1 <= P <= MAX_P:
        raise ValueError(f"rnea_chain takes J = F <= {MAX_J} joints, J + 1 rotations and "
                         f"1..{MAX_P} parameter sets; got J={J}, F={F}, {Jr} rotations, "
                         f"P={P}")
    if robot.com_uncertainty and "int" in sets:
        raise ValueError("rnea_chain does not take an uncertain centre of mass")
    R = _require(jrs.R, "rnea_chain", (Wn, T, Jr, 3, 3))
    qd = _require(jrs.qd, "rnea_chain", (Wn, T, F))
    qda = _require(jrs.qda, "rnea_chain", (Wn, T, F))
    qdda = _require(jrs.qdda, "rnea_chain", (Wn, T, F))
    B, E = _widths(basis, R, "rnea_chain")
    u = _empty((Wn, P, T, F), B, E, R.coef)
    args = K10Args()
    args.rc, args.re, args.rr = _ptrs(R)
    args.qc, args.qe, args.qr = _ptrs(qd)
    args.ac, args.ae, args.ar = _ptrs(qda)
    args.dc, args.de, args.dr = _ptrs(qdda)
    args.uc, args.ue, args.ur = _ptrs(u)
    args.T, args.J, args.P = T, J, P
    args.slop = float(cfg.float_slop)
    args.gravity = float(robot.gravity)
    prm = chain_params(robot, sets, basis)
    for i in range(J + 1):
        args.trans[i][:] = [float(x) for x in robot.trans[i]]
    for i in range(J):
        args.com[i][:] = [float(x) for x in robot.com[i]]
        args.mc[i][:P] = [float(x) for x in prm["mc"][i]]
        args.mr[i][:P] = [float(x) for x in prm["mr"][i]]
        for p in range(P):
            args.Ic[i][p][:] = [float(x) for x in prm["Ic"][i, p]]
            args.Ir[i][p][:] = [float(x) for x in prm["Ir"][i, p]]
        args.ax[i], args.sgn[i], args.rv[i] = prm["ax"][i], prm["sgn"][i], prm["rv"][i]
        args.arm[i], args.damp[i] = float(robot.armature[i]), float(robot.damping[i])
    record("rnea_chain", (tuple(R.rad.shape), tuple(sets)), (jrs, robot, cfg, basis, tuple(sets)))
    if Wn * T:
        upload_tables("rnea_chain", "k10_tables", basis, E)
        _launch("rnea_chain", "k10_launch", K10Args, args, Wn * T, B + E + 1, R.coef)
    return u

"""Launchers of the reach-set chain kernels K9 (fk_chain: the PZ forward
kinematics) and K10 (rnea_chain: the PZ RNEA for P <= 2 parameter sets),
and of K15 (reach_assembly: the torque radius and the link split after
them).  Called by kinematics.forward_occupancy and dynamics.rnea_pz_sets
/ reach_assembly for CUDA tensors only; each checks device, dtype, shapes
and contiguity, raises on anything its kernel does not take, allocates
the outputs and scratch with torch.empty and launches on the current
stream.

k9_geometry and k10_geometry are K9's and K10's launch geometries
(threads per element, elements per block, the persistent grid of
kernels/pz.py:chain_geometry, which K2 shares), k15_geometry K15's (tiles
of time steps, kernels/pz.py:tile_geometry, which K16 shares), pure
Python so that the CPU tests check them; reach_assembly raises on an input
that does not start 16-byte aligned."""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import H100_SMS, launched, record
from .build import launcher, on_device
from .pz import (PZ_MAXMASS, PZ_TAB_BYTES, ChainGeometry, TileGeometry, chain_geometry,
                 group_size, lin_ld, tile_geometry, upload_tables)
from ..pz.basis import KBasis, error_layout
from ..pz.bpz import BPZ

MAX_J, MAX_P = 9, 2
K9_THREADS = 256          # threads per block of several elements at most (csrc/fk_chain.cu)
K9_ENTRIES = 3 * 4 + 3                       # four fk_r row slots, fk_t
K9_CONST = -(-(3 * (MAX_J + 1) + 12 * MAX_J) // 4) * 4
K10_THREADS = 128         # threads per block of several elements (csrc/rnea_chain.cu)
K10_ENTRIES = 3 * 5 + 3 * 3                  # five carry column slots, three temporaries
K10_CONST = -(-(3 * (MAX_J + 1) + 3 * MAX_J + 18 * MAX_J * MAX_P) // 4) * 4


def _group_floats(ld: int, ldl: int, entries: int) -> int:
    """Floats of one element's group area (compact R, the mass scratch,
    `entries` packed entries), a multiple of 4."""
    return -(-(9 * ldl + 4 * PZ_MAXMASS + entries * ld) // 4) * 4


def k9_smem(ld: int, ldl: int, NG: int) -> int:
    """Bytes of shared memory of a K9 block of NG elements
    (fk_chain.cu:k9_smem): the tables, the translations and the link boxes'
    masses, the link boxes in compact form (stride ldl), and per element its
    group area."""
    return PZ_TAB_BYTES + 4 * (K9_CONST + 3 * MAX_J * ldl
                               + NG * _group_floats(ld, ldl, K9_ENTRIES))


def k10_smem(ld: int, ldl: int, NG: int) -> int:
    """Bytes of shared memory of a K10 block of NG elements
    (rnea_chain.cu:k10_smem): the tables, the robot's constants, and per
    element the mass scratch, R in compact form and the PZ entries."""
    return PZ_TAB_BYTES + 4 * (K10_CONST + NG * _group_floats(ld, ldl, K10_ENTRIES))


def k9_geometry(n: int, ld: int, ldl: int, sms: int = H100_SMS) -> ChainGeometry:
    """K9's geometry: K10's group sizes, up to eight elements (256 threads)
    a block, fewer until the grid reaches 2 x sms blocks; two blocks of
    eight warps fit an SM's shared memory at the flagship widths."""
    G = group_size(n, sms)
    NG = max(1, min(K9_THREADS // G, n // (2 * sms)))
    return chain_geometry(n, G, NG, k9_smem(ld, ldl, NG), sms)


def k10_geometry(n: int, ld: int, ldl: int, sms: int = H100_SMS) -> ChainGeometry:
    """K10's geometry: one warp per element, four to a block, once there are
    enough elements to give every SM several; two warps per element from 2
    per SM, eight below that (the W = 1 planner's 128 elements, one block
    each); fewer elements per block until the grid reaches 2 x sms blocks."""
    G = group_size(n, sms)
    NG = max(1, min(K10_THREADS // G, n // (2 * sms)))   # 1 for G = 256
    return chain_geometry(n, G, NG, k10_smem(ld, ldl, NG), sms)

_F3 = ctypes.c_float * 3
_PTRS = [(n, ctypes.c_void_p) for n in ("rc", "re", "rr")]


class K9Args(ctypes.Structure):
    _fields_ = _PTRS + [(n, ctypes.c_void_p) for n in ("bc", "be", "br", "lc", "le", "lr")] + [
        ("n", ctypes.c_longlong), ("J", ctypes.c_int), ("Jr", ctypes.c_int),
        ("slop", ctypes.c_float),
        ("trans", _F3 * (MAX_J + 1))]


class K10Args(ctypes.Structure):
    _fields_ = _PTRS + [(n, ctypes.c_void_p) for n in (
        "qc", "qe", "qr", "ac", "ae", "ar", "dc", "de", "dr", "zero", "uc", "ue", "ur",
        "wfc", "wfe", "wfr", "wnc", "wne", "wnr", "fn")] + [
        ("n", ctypes.c_longlong), ("T", ctypes.c_int), ("J", ctypes.c_int), ("F", ctypes.c_int),
        ("P", ctypes.c_int), ("wj", ctypes.c_int),
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


def _empty(shape, B: int, E: int, like: torch.Tensor) -> BPZ:
    kw = dict(device=like.device, dtype=torch.float32)
    return BPZ(coef=torch.empty(*shape, B, **kw), egen=torch.empty(*shape, E, **kw),
               rad=torch.empty(*shape, **kw))


def _widths(basis: KBasis, R: BPZ, what: str):
    B, E = R.coef.shape[-1], R.egen.shape[-1]
    if B != basis.size or E != error_layout(basis.nf)["size"]:
        raise ValueError(f"{what}: operand widths do not match the basis")
    return B, E


def _launch(name: str, symbol: str, argtype, args, geo: ChainGeometry, ld: int, ldl: int,
            like) -> None:
    fn = launcher(name, symbol, [ctypes.POINTER(argtype), ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with on_device(like) as stream:
        err = fn(ctypes.byref(args), ld, ldl, geo.G, geo.NG, geo.grid, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launched(name)


def _sms(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def _k9_robot(robot, cfg, basis: KBasis, device):
    """The link boxes on the device and the robot's part of K9's arguments,
    formed once per robot, slop and device and kept in basis.kernel_args
    (the boxes with them, so that the pointers stay valid): forming them
    costs a host-to-device copy and several launches a call otherwise."""
    from ..kinematics import link_box_pz

    key = ("k9", str(device), float(cfg.float_slop), robot.num_joints) + tuple(
        np.asarray(x).tobytes() for x in (robot.trans, robot.link_center, robot.link_generators))
    tab = basis.kernel_args
    if key not in tab:
        boxes = link_box_pz(robot, basis, torch.float32, device=device)
        args = K9Args()
        args.bc, args.be, args.br = _ptrs(boxes)
        args.J, args.slop = robot.num_joints, float(cfg.float_slop)
        for i in range(robot.num_joints):
            args.trans[i][:] = [float(x) for x in robot.trans[i]]
        tab[key] = (boxes, args)
    return tab[key][1]


def fk_chain(jrs, robot, cfg, basis: KBasis) -> BPZ:
    """K9: the link PZs [W, T, J, 3] of the forward-kinematics chain
    (kinematics.forward_occupancy_plain's result)."""
    Wn, T, Jr = jrs.R.rad.shape[:3]
    J = robot.num_joints
    if J > MAX_J or Jr < J:
        raise ValueError(f"fk_chain takes at most {MAX_J} joints, got {J} (R holds {Jr})")
    R = _require(jrs.R, "fk_chain", (Wn, T, Jr, 3, 3))
    B, E = _widths(basis, R, "fk_chain")
    links = _empty((Wn, T, J, 3), B, E, R.coef)
    args = K9Args()
    ctypes.memmove(ctypes.addressof(args),
                   ctypes.addressof(_k9_robot(robot, cfg, basis, R.coef.device)),
                   ctypes.sizeof(K9Args))
    args.rc, args.re, args.rr = _ptrs(R)
    args.lc, args.le, args.lr = _ptrs(links)
    args.Jr, args.n = Jr, Wn * T
    record("fk_chain", tuple(R.rad.shape), (jrs, robot, cfg, basis))
    if Wn * T:
        ld, ldl = B + E + 1, lin_ld(basis.nf, E)
        upload_tables("fk_chain", "k9_tables", basis, E, R.coef.device)
        _launch("fk_chain", "k9_launch", K9Args, args, k9_geometry(Wn * T, ld, ldl, _sms(R.coef)),
                ld, ldl, R.coef)
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


def _robot_args(robot, cfg, basis: KBasis, sets) -> K10Args:
    """The robot's part of K10's arguments (constants, inertial intervals,
    joint axes, float slop), formed once per robot, sets and slop and kept
    in basis.kernel_args: forming them takes more host time than a W = 1
    launch."""
    key = ("k10", tuple(sets), float(cfg.float_slop), robot.num_joints, robot.num_factors,
           float(robot.gravity), float(robot.mass_uncertainty),
           float(robot.inertia_uncertainty), float(robot.com_uncertainty)) + tuple(
        np.asarray(x).tobytes() for x in (robot.axes, robot.trans, robot.com, robot.mass,
                                          robot.inertia, robot.armature, robot.damping))
    tab = basis.kernel_args
    if key not in tab:
        J, P = robot.num_joints, len(sets)
        args = K10Args()
        args.J, args.F, args.P = J, robot.num_factors, P
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
        tab[key] = args
    return tab[key]


def _zero_row(basis: KBasis, E: int, device) -> torch.Tensor:
    """B + E + 1 zeros on `device`, formed once per device and kept in
    basis.kernel_args: K10's qd, qda, qdda of a joint past num_factors."""
    key = ("k10_zero", str(device))
    tab = basis.kernel_args
    if key not in tab:
        tab[key] = torch.zeros(basis.size + E + 1, device=device, dtype=torch.float32)
    return tab[key]


def rnea_chain(jrs, robot, cfg, basis: KBasis, sets=("nom", "int"), *, wrench_at=None):
    """K10: the PZ RNEA torque u [W, P, T, F] for P = len(sets) <= 2
    parameter sets without COM uncertainty (dynamics.rnea_pz_sets_plain's
    result); with wrench_at, (u, f, n): the wrench [W, P, T, 3] after that
    joint, from the same launch.  J <= 9 joints, the last J - F fixed."""
    Wn, T, Jr = jrs.R.rad.shape[:3]
    J, F, P = robot.num_joints, robot.num_factors, len(sets)
    if J > MAX_J or Jr != J + 1 or F > J or not 1 <= P <= MAX_P:
        raise ValueError(f"rnea_chain takes F <= J <= {MAX_J} joints, J + 1 rotations and "
                         f"1..{MAX_P} parameter sets; got J={J}, F={F}, {Jr} rotations, "
                         f"P={P}")
    if any(robot.axes[i] != 0 for i in range(F, J)):
        raise ValueError("rnea_chain: the joints past num_factors must be fixed")
    if wrench_at is not None and not 0 <= wrench_at < J:
        raise ValueError(f"rnea_chain: wrench_at must be a joint index below {J}, "
                         f"got {wrench_at}")
    if robot.com_uncertainty and "int" in sets:
        raise ValueError("rnea_chain does not take an uncertain centre of mass")
    R = _require(jrs.R, "rnea_chain", (Wn, T, Jr, 3, 3))
    qd = _require(jrs.qd, "rnea_chain", (Wn, T, F))
    qda = _require(jrs.qda, "rnea_chain", (Wn, T, F))
    qdda = _require(jrs.qdda, "rnea_chain", (Wn, T, F))
    B, E = _widths(basis, R, "rnea_chain")
    u = _empty((Wn, P, T, F), B, E, R.coef)
    args = K10Args()
    ctypes.memmove(ctypes.addressof(args), ctypes.addressof(_robot_args(robot, cfg, basis, sets)),
                   ctypes.sizeof(K10Args))
    args.rc, args.re, args.rr = _ptrs(R)
    args.qc, args.qe, args.qr = _ptrs(qd)
    args.ac, args.ae, args.ar = _ptrs(qda)
    args.dc, args.de, args.dr = _ptrs(qdda)
    args.uc, args.ue, args.ur = _ptrs(u)
    args.zero = _zero_row(basis, E, R.coef.device).data_ptr()
    args.T = T
    args.wj = -1 if wrench_at is None else int(wrench_at)
    f_c = n_c = None
    if wrench_at is not None:
        f_c, n_c = _empty((Wn, P, T, 3), B, E, R.coef), _empty((Wn, P, T, 3), B, E, R.coef)
        args.wfc, args.wfe, args.wfr = _ptrs(f_c)
        args.wnc, args.wne, args.wnr = _ptrs(n_c)
    record("rnea_chain", (tuple(R.rad.shape), tuple(sets), wrench_at),
           (jrs, robot, cfg, basis, tuple(sets), wrench_at))
    if Wn * T:
        ld, ldl = B + E + 1, lin_ld(basis.nf, E)
        geo = k10_geometry(Wn * T, ld, ldl, _sms(R.coef))
        fn = torch.empty(geo.grid * geo.NG * J * P * 6 * ld, device=R.coef.device,
                         dtype=torch.float32)
        args.fn, args.n = fn.data_ptr(), Wn * T
        upload_tables("rnea_chain", "k10_tables", basis, E, R.coef.device)
        _launch("rnea_chain", "k10_launch", K10Args, args, geo, ld, ldl, R.coef)
    if wrench_at is None:
        return u
    return u, f_c, n_c


K15_TILE = 4              # time steps a tile, a warp each (csrc/reach_assembly.cu)
K15_THREADS = 32 * K15_TILE
K15_STAGES = 2            # the ring's stages: the next tile lands while this one is summed
K15_RANGES = 8            # a tile's ranges: coef, egen, rad of both planes; the links' egen, rad
K15_PART = 5              # per warp and factor: the two disturbance sums, the nominal sum, d_max, sq
K15_MAX_F, K15_MAX_J3 = 8, 27
K15_SMEM_MAX = 232448     # dynamic shared memory of a block after the opt-in, bytes


class K15Args(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "uc", "ue", "ur", "le", "lr", "torque_radius", "shape_gens", "radius")] + [
        (n, ctypes.c_int) for n in ("W", "T", "F", "J3", "B", "E", "sh0")] + [
        ("c0", ctypes.c_float), ("friction", ctypes.c_float * K15_MAX_F)]


def k15_counts(F: int, J3: int, B: int, E: int) -> tuple:
    """Floats a time step holds of each of a tile's ranges
    (reach_assembly.cu:k15_count)."""
    return (F * B, F * B, F * E, F * E, F, F, J3 * E, J3)


def k15_slot(count: int) -> int:
    """Floats of a range's ring slot: a tile and 3 floats of phase, a
    multiple of 4 (reach_assembly.cu:k15_slot)."""
    return (K15_TILE * count + 3 + 3) // 4 * 4


def k15_smem(F: int, J3: int, B: int, E: int) -> int:
    """Bytes of dynamic shared memory of a K15 block (reach_assembly.cu:
    k15_smem): the ring's stages of one tile each, then the warps' parts."""
    stage = sum(k15_slot(c) for c in k15_counts(F, J3, B, E))
    return 4 * (K15_STAGES * stage + K15_TILE * K15_PART * K15_MAX_F)


@functools.lru_cache(maxsize=64)
def k15_geometry(W: int, T: int, F: int, J3: int, B: int, E: int,
                 sms: int = H100_SMS) -> TileGeometry:
    """K15's persistent grid over tiles of K15_TILE steps: as many blocks
    as fit the card at once by shared memory (two an SM at the flagship's
    and the dumbbell's widths), at most one per tile.  Cached (its host
    time is a tenth of the kernel's): clear the cache after changing this
    module's constants."""
    return tile_geometry(W, T, K15_TILE, K15_THREADS, k15_smem(F, J3, B, E), sms)


def _k15_template(robot, cfg, basis: KBasis) -> K15Args:
    """The robot's and config's part of K15's arguments (c0 and the
    friction, each the plain version's Python double rounded once to
    float32), kept in basis.kernel_args."""
    ub = cfg.ub
    c0 = ub.alpha * (ub.m_max - ub.m_min) * ub.eps
    F = robot.num_factors
    key = ("k15", F, float(c0)) + (np.asarray(robot.friction[:F], np.float64).tobytes(),)
    tab = basis.kernel_args
    if key not in tab:
        if F > K15_MAX_F:
            raise ValueError(f"reach_assembly takes at most {K15_MAX_F} factors, got {F}")
        args = K15Args()
        args.c0 = float(c0)
        args.friction[:F] = [float(x) for x in robot.friction[:F]]
        tab[key] = args
    return tab[key]


def reach_assembly(links, u_both, robot, cfg, basis: KBasis):
    """K15: (LinkFRS of the links [W, T, J, 3], TorqueFRS of the RNEA
    torque u_both [W, 2, T, F]) in one launch (dynamics.
    reach_assembly_plain's result)."""
    from ..dynamics import TorqueFRS
    from ..kinematics import LinkFRS

    Wn, T, J = links.rad.shape[:3]
    F = u_both.rad.shape[-1]
    if 3 * J > K15_MAX_J3:
        raise ValueError(f"reach_assembly takes at most {K15_MAX_J3 // 3} links, got {J}")
    if F != robot.num_factors:
        raise ValueError(f"reach_assembly: u_both has {F} factors, the robot "
                         f"{robot.num_factors}")
    L = _require(links, "reach_assembly", (Wn, T, J, 3))
    U = _require(u_both, "reach_assembly", (Wn, 2, T, F))
    if L.rad.device != U.rad.device:
        raise ValueError("reach_assembly: the links and the torque lie on different devices")
    B, E = _widths(basis, L, "reach_assembly")
    _widths(basis, U, "reach_assembly")
    for t in (U.coef, U.egen, U.rad, L.egen, L.rad):
        if t.data_ptr() % 16:
            raise ValueError("reach_assembly: the kernel copies 16-byte chunks at each range's "
                             "phase in its tensor, so every input must start 16-byte aligned")
    kw = dict(device=L.rad.device, dtype=torch.float32)
    shape_gens = torch.empty(Wn, T, J, 3, 3, **kw)
    radius = torch.empty(Wn, T, J, 3, **kw)
    torque_radius = torch.empty(Wn, T, F, **kw)
    args = K15Args()
    ctypes.memmove(ctypes.addressof(args),
                   ctypes.addressof(_k15_template(robot, cfg, basis)), ctypes.sizeof(K15Args))
    args.uc, args.ue, args.ur = _ptrs(U)
    args.le, args.lr = L.egen.data_ptr(), L.rad.data_ptr()
    args.torque_radius = torque_radius.data_ptr()
    args.shape_gens, args.radius = shape_gens.data_ptr(), radius.data_ptr()
    args.W, args.T, args.F, args.J3, args.B, args.E = Wn, T, F, 3 * J, B, E
    args.sh0 = error_layout(basis.nf)["shape"].start
    record("reach_assembly", (tuple(links.rad.shape), tuple(u_both.rad.shape)),
           (links, u_both, robot, cfg, basis))
    if Wn * T:
        geo = k15_geometry(Wn, T, F, 3 * J, B, E, _sms(L.rad))
        if geo.smem > K15_SMEM_MAX:
            raise ValueError(f"reach_assembly: {geo.smem} bytes of shared memory a block exceed "
                             f"{K15_SMEM_MAX}")
        fn = launcher("reach_assembly", "k15_launch",
                      [ctypes.POINTER(K15Args), ctypes.c_int, ctypes.c_void_p])
        with on_device(L.rad) as stream:
            err = fn(ctypes.byref(args), geo.grid, stream)
        if err:
            raise RuntimeError(f"reach_assembly launch failed: cudaError {err}")
        launched("reach_assembly")
    return (LinkFRS(center_coef=links.coef, shape_gens=shape_gens, radius=radius),
            TorqueFRS(u_coef=U.coef[:, 0], torque_radius=torque_radius))

"""Launchers of the PZ product kernels K1 (pz_matmul_linear) and K2
(pz_cross), and the basis tables every PZ kernel (K1, K2, K9, K10) reads
from constant memory.  Called by pz/bpz.py for CUDA tensors only; each
checks device, dtype, shapes and strides, raises on anything its kernel
does not take, allocates the outputs with torch.empty and launches on the
current stream."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import launched, record
from .build import launcher
from ..pz.basis import KBasis, linear_tables, pair_segments
from ..pz.bpz import BPZ

_LL3 = ctypes.c_longlong * 3
_LL2 = ctypes.c_longlong * 2

MAX_B, MAX_E, MAX_NF, MAX_PAIRS = 128, 64, 8, 1024


class PZView(ctypes.Structure):
    _fields_ = [("coef", ctypes.c_void_p), ("egen", ctypes.c_void_p), ("rad", ctypes.c_void_p),
                ("cb", _LL3), ("eb", _LL3), ("rb", _LL3),
                ("cv", _LL2), ("ev", _LL2), ("rv", _LL2)]


class PZTables(ctypes.Structure):
    """The basis tables every PZ kernel reads (csrc/pz_ops.cuh), uploaded
    to each library's constant memory once."""
    _fields_ = [("B", ctypes.c_int), ("E", ctypes.c_int), ("nf", ctypes.c_int),
                ("P", ctypes.c_int), ("lin", ctypes.c_int * MAX_NF),
                ("seg", ctypes.c_short * (MAX_B + 2)),
                ("src", ctypes.c_ubyte * (MAX_NF * MAX_B)), ("ovf", ctypes.c_ubyte * MAX_B),
                ("pi", ctypes.c_ubyte * MAX_PAIRS), ("pj", ctypes.c_ubyte * MAX_PAIRS)]


class K1Args(ctypes.Structure):
    _fields_ = [("a", PZView), ("b", PZView), ("out", PZView),
                ("bd", ctypes.c_int * 3), ("n", ctypes.c_int), ("m", ctypes.c_int),
                ("p", ctypes.c_int), ("slop", ctypes.c_float)]


class K2Args(ctypes.Structure):
    _fields_ = [("a", PZView), ("b", PZView), ("out", PZView),
                ("bd", ctypes.c_int * 3), ("slop", ctypes.c_float)]


def pz_tables(basis: KBasis, E: int) -> PZTables:
    """The tables of `basis` with E error slots (cached on the basis)."""
    key = ("pz_tables", E)
    tab = basis.kernel_args
    if key not in tab:
        src, ovf = linear_tables(basis.nf, basis.max_degree)
        pi, pj, seg = pair_segments(basis.nf, basis.max_degree)
        B, nf = basis.size, basis.nf
        if B > MAX_B or nf > MAX_NF or len(pi) > MAX_PAIRS or E > MAX_E:
            raise ValueError(f"basis (nf={nf}, B={B}, pairs={len(pi)}, E={E}) exceeds the "
                             "kernels' tables")
        t = PZTables()
        t.B, t.E, t.nf, t.P = B, E, nf, len(pi)
        t.lin[:nf] = [int(x) for x in basis.lin_idx]
        t.seg[:B + 1] = [int(x) for x in seg]
        t.src[:nf * B] = [int(x) for x in src.reshape(-1)]
        t.ovf[:B] = [int(x) for x in ovf]
        t.pi[:len(pi)] = [int(x) for x in pi]
        t.pj[:len(pj)] = [int(x) for x in pj]
        tab[key] = t
    return tab[key]


_UPLOADED = {}


def upload_tables(name: str, symbol: str, basis: KBasis, E: int) -> None:
    """Copy the basis tables into kernel `name`'s constant memory, once per
    (library, tables); a change of tables waits for the queued work first."""
    t = pz_tables(basis, E)
    if _UPLOADED.get(name) is t:
        return
    if name in _UPLOADED:
        torch.cuda.synchronize()
    fn = launcher(name, symbol, [ctypes.POINTER(PZTables)])
    err = fn(ctypes.byref(t))
    if err:
        raise RuntimeError(f"{name}: uploading the basis tables failed: cudaError {err}")
    _UPLOADED[name] = t


def _check(p: BPZ, what: str) -> None:
    for t in (p.coef, p.egen, p.rad):
        if not t.is_cuda:
            raise ValueError(f"{what}: all operands must be CUDA tensors")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: the kernel takes float32, got {t.dtype}")


def _batch_shape(a: BPZ, b: BPZ, nval: int):
    shape = torch.broadcast_shapes(a.rad.shape[:-nval], b.rad.shape[:-nval])
    if len(shape) > 3:
        raise ValueError(f"at most 3 batch dims are supported, got {tuple(shape)}")
    return tuple(shape)


def _view(p: BPZ, bshape, nval: int, what: str) -> PZView:
    """Strides of p broadcast to batch shape bshape (stride 0 where it is
    broadcast); the trailing coef/egen axis must be contiguous."""
    coef = p.coef.expand(*bshape, *p.coef.shape[-nval - 1:])
    egen = p.egen.expand(*bshape, *p.egen.shape[-nval - 1:])
    rad = p.rad.expand(*bshape, *p.rad.shape[-nval:])
    if coef.stride(-1) != 1 or egen.stride(-1) != 1:
        raise ValueError(f"{what}: the monomial / error axis must be contiguous")
    nb = len(bshape)

    def bstr(t):
        s = t.stride()[:nb]
        return _LL3(*([0] * (3 - nb) + list(s)))

    def vstr(t, trailing):
        s = list(t.stride()[nb:t.dim() - trailing])
        return _LL2(*(s + [0] * (2 - len(s))))

    return PZView(coef.data_ptr(), egen.data_ptr(), rad.data_ptr(),
                  bstr(coef), bstr(egen), bstr(rad),
                  vstr(coef, 1), vstr(egen, 1), vstr(rad, 0))


def _bd(bshape):
    full = [1] * (3 - len(bshape)) + list(bshape)
    return (ctypes.c_int * 3)(*full), int(np.prod(full))


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def matmul_linear(a: BPZ, b: BPZ, basis: KBasis, slop: float = 0.0,
                  transpose_out: bool = False) -> BPZ:
    """K1: a [.., n, m] @ b [.., m, p] with a of degree <= 1 in k.  With
    transpose_out the result is returned transposed ([.., p, n]), written
    through strides."""
    _check(a, "pz_matmul_linear")
    _check(b, "pz_matmul_linear")
    n, m = a.rad.shape[-2:]
    m2, p = b.rad.shape[-2:]
    B, E = a.coef.shape[-1], a.egen.shape[-1]
    if m != m2 or n > 3 or m > 3 or p > 4:
        raise ValueError(f"pz_matmul_linear takes [.., n<=3, m<=3] @ [.., m, p<=4], "
                         f"got {tuple(a.rad.shape)} @ {tuple(b.rad.shape)}")
    if B != basis.size or b.coef.shape[-1] != B or E > MAX_E or b.egen.shape[-1] != E:
        raise ValueError("pz_matmul_linear: operand widths do not match the basis")
    bshape = _batch_shape(a, b, 2)
    dev = a.coef.device
    if transpose_out:
        res = BPZ(coef=torch.empty(*bshape, p, n, B, device=dev, dtype=torch.float32),
                  egen=torch.empty(*bshape, p, n, E, device=dev, dtype=torch.float32),
                  rad=torch.empty(*bshape, p, n, device=dev, dtype=torch.float32))
        out = BPZ(coef=res.coef.transpose(-3, -2), egen=res.egen.transpose(-3, -2),
                  rad=res.rad.transpose(-2, -1))
    else:
        res = out = BPZ(coef=torch.empty(*bshape, n, p, B, device=dev, dtype=torch.float32),
                        egen=torch.empty(*bshape, n, p, E, device=dev, dtype=torch.float32),
                        rad=torch.empty(*bshape, n, p, device=dev, dtype=torch.float32))
    args = K1Args()
    args.a = _view(a, bshape, 2, "pz_matmul_linear")
    args.b = _view(b, bshape, 2, "pz_matmul_linear")
    args.out = _view(out, bshape, 2, "pz_matmul_linear")
    args.bd, blocks = _bd(bshape)
    args.n, args.m, args.p = n, m, p
    args.slop = float(slop)
    record("pz_matmul_linear", (tuple(a.rad.shape), tuple(b.rad.shape), transpose_out),
           (a, b, basis, slop, transpose_out))
    if blocks:
        upload_tables("pz_matmul_linear", "k1_tables", basis, E)
        fn = launcher("pz_matmul_linear", "k1_launch",
                      [ctypes.POINTER(K1Args), ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        err = fn(ctypes.byref(args), blocks, B + E + 1, _stream(a.coef))
        if err:
            raise RuntimeError(f"pz_matmul_linear launch failed: cudaError {err}")
        launched("pz_matmul_linear")
    return res


def cross(a: BPZ, b: BPZ, basis: KBasis, slop: float = 0.0) -> BPZ:
    """K2: PZ x PZ cross product of 3-vectors [.., 3]."""
    _check(a, "pz_cross")
    _check(b, "pz_cross")
    B, E = a.coef.shape[-1], a.egen.shape[-1]
    if a.rad.shape[-1] != 3 or b.rad.shape[-1] != 3:
        raise ValueError("pz_cross takes 3-vectors")
    if B != basis.size or b.coef.shape[-1] != B or E > MAX_E or b.egen.shape[-1] != E:
        raise ValueError("pz_cross: operand widths do not match the basis")
    bshape = _batch_shape(a, b, 1)
    dev = a.coef.device
    out = BPZ(coef=torch.empty(*bshape, 3, B, device=dev, dtype=torch.float32),
              egen=torch.empty(*bshape, 3, E, device=dev, dtype=torch.float32),
              rad=torch.empty(*bshape, 3, device=dev, dtype=torch.float32))
    args = K2Args()
    args.a = _view(a, bshape, 1, "pz_cross")
    args.b = _view(b, bshape, 1, "pz_cross")
    args.out = _view(out, bshape, 1, "pz_cross")
    args.bd, blocks = _bd(bshape)
    args.slop = float(slop)
    record("pz_cross", (tuple(a.rad.shape), tuple(b.rad.shape)), (a, b, basis, slop))
    if blocks:
        upload_tables("pz_cross", "k2_tables", basis, E)
        fn = launcher("pz_cross", "k2_launch",
                      [ctypes.POINTER(K2Args), ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        err = fn(ctypes.byref(args), blocks, B + E + 1, _stream(a.coef))
        if err:
            raise RuntimeError(f"pz_cross launch failed: cudaError {err}")
        launched("pz_cross")
    return out

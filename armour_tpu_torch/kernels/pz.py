"""Launchers of the PZ product kernels K1 (pz_matmul_linear) and K2
(pz_cross), the basis tables every PZ kernel (K1, K2, K9, K10) reads
from constant memory, and the persistent-grid geometry they share.  Called
by pz/bpz.py for CUDA tensors only; each launcher checks device, dtype,
shapes and strides, raises on anything its kernel does not take, allocates
the outputs with torch.empty and launches on the current stream.

chain_geometry, k1_geometry and k2_geometry are pure Python, so that the
CPU tests check them."""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from . import H100_SMS, launched, record
from .build import launcher
from ..pz.basis import KBasis, linear_tables, pair_segments
from ..pz.bpz import BPZ

_LL3 = ctypes.c_longlong * 3
_LL2 = ctypes.c_longlong * 2

MAX_B, MAX_E, MAX_NF, MAX_PAIRS = 128, 64, 8, 1024
SM_SMEM = 233472          # bytes of shared memory of one Hopper SM, for all its blocks
BLOCK_SMEM_RESERVED = 1024  # bytes the runtime keeps per resident block
PZ_TAB_BYTES, PZ_MAXMASS = 3520, 32          # csrc/pz_ops.cuh
K1_THREADS = 256          # threads per block of several elements at most (csrc/pz_matmul_linear.cu)
K1_BLOCKS_PER_SM = 2      # its __launch_bounds__ (128 registers a thread): two blocks an SM
K2_THREADS = 256          # threads per block of several elements at most (csrc/pz_cross.cu)
K2_BLOCKS_PER_SM = 2      # its __launch_bounds__ (128 registers a thread): two blocks an SM


@dataclasses.dataclass(frozen=True)
class ChainGeometry:
    """G threads per element, NG elements per block, a grid of `grid`
    blocks; block b takes the elements b NG + gi, (b + grid) NG + gi, ..."""

    G: int
    NG: int
    grid: int

    def elements(self, b: int, gi: int, n: int):
        """The elements group gi of block b works on (the kernels' loop)."""
        return list(range(b * self.NG + gi, n, self.grid * self.NG))


def chain_geometry(n: int, G: int, NG: int, smem: int, sms: int = H100_SMS,
                   blocks_per_sm: int = 32) -> ChainGeometry:
    """The persistent grid of NG groups of G threads: as many blocks as fit
    on the card at once (by shared memory, threads and the kernel's
    registers, blocks_per_sm), at most one per NG elements."""
    per_sm = min(SM_SMEM // (smem + BLOCK_SMEM_RESERVED), 2048 // (G * NG), blocks_per_sm)
    return ChainGeometry(G=G, NG=NG, grid=max(1, min(-(-n // NG), sms * per_sm)))


def group_size(n: int, sms: int) -> int:
    """One warp per element once there are enough elements to give every SM
    several; two warps from 2 per SM; eight below that (one element a
    block)."""
    return 32 if n >= 8 * sms else 64 if n >= 2 * sms else 256


def lin_ld(nf: int, E: int) -> int:
    """Floats of a compact degree-1 entry (pz_ops.cuh:pz_lin_ld)."""
    return -(-(nf + E + 5) // 4) * 4


def k1_smem(ld: int, ldl: int, n: int, m: int, NG: int) -> int:
    """Bytes of shared memory of a K1 block of NG elements of an [n, m] @
    [m, p] product (pz_matmul_linear.cu:k1_smem): the tables, and per
    element the mass scratch, a's compact entries (stride ldl) and the
    packed entries of one column of b and of the result (stride ld)."""
    floats = 4 * PZ_MAXMASS + n * m * ldl + (m + n) * ld
    return PZ_TAB_BYTES + 4 * NG * (-(-floats // 4) * 4)


def k1_geometry(total: int, ld: int, ldl: int, n: int, m: int,
                sms: int = H100_SMS) -> ChainGeometry:
    """K1's geometry: K2's group sizes (a warp per element at the flagship's
    8,192-16,384 elements), as many elements a block as 256 threads and two
    blocks' shared memory an SM allow (eight at the flagship widths), fewer
    until the grid reaches 2 x sms blocks; two blocks an SM, as many as its
    registers let stay resident."""
    G = group_size(total, sms)
    fit = 1
    while (fit < K1_THREADS // G and K1_BLOCKS_PER_SM * (
            k1_smem(ld, ldl, n, m, fit + 1) + BLOCK_SMEM_RESERVED) <= SM_SMEM):
        fit += 1
    NG = max(1, min(fit, total // (2 * sms)))
    return chain_geometry(total, G, NG, k1_smem(ld, ldl, n, m, NG), sms, K1_BLOCKS_PER_SM)


def k2_smem(ld: int, NG: int) -> int:
    """Bytes of shared memory of a K2 block of NG elements
    (pz_cross.cu:k2_smem): the tables, and per element the mass scratch and
    the packed entries of a, b and the result."""
    return PZ_TAB_BYTES + 4 * NG * (-(-(4 * PZ_MAXMASS + 9 * ld) // 4) * 4)


def k2_geometry(n: int, ld: int, sms: int = H100_SMS) -> ChainGeometry:
    """K2's geometry: K10's group sizes (a warp per element at the
    flagship's 8,192-16,384 elements), up to eight elements (256 threads) a
    block, fewer until the grid reaches 2 x sms blocks; two blocks an SM, as
    many as its registers let stay resident (a grid of four an SM, the rest
    waiting, was 8% slower on an 8,192-element call on an H100)."""
    G = group_size(n, sms)
    NG = max(1, min(K2_THREADS // G, n // (2 * sms)))
    return chain_geometry(n, G, NG, k2_smem(ld, NG), sms, K2_BLOCKS_PER_SM)


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
    """The broadcast batch shape of a and b (their shapes without the nval
    value dims), in plain Python: torch.broadcast_shapes costs more host
    time than a small launch."""
    sa, sb = tuple(a.rad.shape[:-nval]), tuple(b.rad.shape[:-nval])
    n = max(len(sa), len(sb))
    sa, sb = (1,) * (n - len(sa)) + sa, (1,) * (n - len(sb)) + sb
    if any(x != y and x != 1 and y != 1 for x, y in zip(sa, sb)):
        raise ValueError(f"batch shapes {sa} and {sb} do not broadcast")
    if n > 3:
        raise ValueError(f"at most 3 batch dims are supported, got {n}")
    return tuple(y if x == 1 else x for x, y in zip(sa, sb))


def _view(p: BPZ, bshape, nval: int, what: str) -> PZView:
    """Strides of p broadcast to batch shape bshape (stride 0 where it is
    broadcast, as Tensor.expand gives them, formed without it); the trailing
    coef/egen axis must be contiguous."""
    if p.coef.stride(-1) != 1 or p.egen.stride(-1) != 1:
        raise ValueError(f"{what}: the monomial / error axis must be contiguous")
    nb = len(bshape)

    def bstr(t, trailing):
        shape, stride = t.shape, t.stride()
        off = nb - (t.dim() - trailing)
        s = [0] * (3 - nb)
        for i, n in enumerate(bshape):
            j = i - off
            s.append(stride[j] if j >= 0 and shape[j] == n else 0)
        return _LL3(*s)

    def vstr(t, trailing):
        s = list(t.stride()[t.dim() - trailing - nval:t.dim() - trailing])
        return _LL2(*(s + [0] * (2 - len(s))))

    return PZView(p.coef.data_ptr(), p.egen.data_ptr(), p.rad.data_ptr(),
                  bstr(p.coef, nval + 1), bstr(p.egen, nval + 1), bstr(p.rad, nval),
                  vstr(p.coef, 1), vstr(p.egen, 1), vstr(p.rad, 0))


def _bd(bshape):
    full = [1] * (3 - len(bshape)) + list(bshape)
    return (ctypes.c_int * 3)(*full), math.prod(full)


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


_K1_SIGS = {}
_K1_TYPES = [ctypes.POINTER(K1Args), ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _sig_key(a: BPZ, b: BPZ, *rest):
    """The operands' shapes and strides and the launch's other arguments:
    what K1's and K2's views, batch sizes and argument structs depend on."""
    return tuple((p.coef.shape, p.coef.stride(), p.egen.shape, p.egen.stride(), p.rad.shape,
                  p.rad.stride()) for p in (a, b)) + rest


def matmul_linear(a: BPZ, b: BPZ, basis: KBasis, slop: float = 0.0,
                  transpose_out: bool = False) -> BPZ:
    """K1: a [.., n, m] @ b [.., m, p] with a of degree <= 1 in k.  With
    transpose_out the result is returned transposed ([.., p, n]), written
    through strides.  As for K2, the shapes are checked and the views,
    batch sizes and argument struct formed once per signature and kept; a
    call sets the data pointers and picks the geometry."""
    _check(a, "pz_matmul_linear")
    _check(b, "pz_matmul_linear")
    B, E = a.coef.shape[-1], a.egen.shape[-1]
    dev = a.coef.device
    key = _sig_key(a, b, float(slop), bool(transpose_out), dev.index)
    sig = _K1_SIGS.get(key)
    if sig is None:
        n, m = a.rad.shape[-2:]
        m2, p = b.rad.shape[-2:]
        if m != m2 or n > 3 or m > 3:
            raise ValueError(f"pz_matmul_linear takes [.., n<=3, m<=3] @ [.., m, p], "
                             f"got {tuple(a.rad.shape)} @ {tuple(b.rad.shape)}")
        if B != basis.size or b.coef.shape[-1] != B or E > MAX_E or b.egen.shape[-1] != E:
            raise ValueError("pz_matmul_linear: operand widths do not match the basis")
        bshape = _batch_shape(a, b, 2)
    else:
        bshape, n, p = sig[0], sig[2], sig[3]
    shape = (*bshape, p, n) if transpose_out else (*bshape, n, p)
    res = BPZ(coef=torch.empty(*shape, B, device=dev, dtype=torch.float32),
              egen=torch.empty(*shape, E, device=dev, dtype=torch.float32),
              rad=torch.empty(*shape, device=dev, dtype=torch.float32))
    out = BPZ(coef=res.coef.transpose(-3, -2), egen=res.egen.transpose(-3, -2),
              rad=res.rad.transpose(-2, -1)) if transpose_out else res
    if sig is None:
        args = K1Args()
        args.a = _view(a, bshape, 2, "pz_matmul_linear")
        args.b = _view(b, bshape, 2, "pz_matmul_linear")
        args.out = _view(out, bshape, 2, "pz_matmul_linear")
        args.bd, total = _bd(bshape)
        args.n, args.m, args.p = n, m, p
        args.slop = float(slop)
        if len(_K1_SIGS) >= 256:
            _K1_SIGS.clear()
        sig = _K1_SIGS[key] = (bshape, args, n, p, total,
                               torch.cuda.get_device_properties(dev).multi_processor_count)
    _, args, n, p, total, sms = sig
    for view, t in ((args.a, a), (args.b, b), (args.out, out)):
        view.coef, view.egen, view.rad = t.coef.data_ptr(), t.egen.data_ptr(), t.rad.data_ptr()
    record("pz_matmul_linear", (tuple(a.rad.shape), tuple(b.rad.shape), transpose_out),
           (a, b, basis, slop, transpose_out))
    if total:
        ld, ldl = B + E + 1, lin_ld(basis.nf, E)
        geo = k1_geometry(total, ld, ldl, n, args.m, sms)
        upload_tables("pz_matmul_linear", "k1_tables", basis, E)
        fn = launcher("pz_matmul_linear", "k1_launch", _K1_TYPES)
        err = fn(ctypes.byref(args), total, ld, ldl, geo.G, geo.NG, geo.grid, _stream(a.coef))
        if err:
            raise RuntimeError(f"pz_matmul_linear launch failed: cudaError {err}")
        launched("pz_matmul_linear")
    return res


_K2_SIGS = {}
_K2_TYPES = [ctypes.POINTER(K2Args), ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]


def cross(a: BPZ, b: BPZ, basis: KBasis, slop: float = 0.0) -> BPZ:
    """K2: PZ x PZ cross product of 3-vectors [.., 3].  The views' strides
    and batch sizes are formed once per signature (the operands' shapes and
    strides, slop, device) and kept: forming them costs more host time than
    the launch; a call sets the data pointers and picks the geometry."""
    _check(a, "pz_cross")
    _check(b, "pz_cross")
    B, E = a.coef.shape[-1], a.egen.shape[-1]
    if a.rad.shape[-1] != 3 or b.rad.shape[-1] != 3:
        raise ValueError("pz_cross takes 3-vectors")
    if B != basis.size or b.coef.shape[-1] != B or E > MAX_E or b.egen.shape[-1] != E:
        raise ValueError("pz_cross: operand widths do not match the basis")
    dev = a.coef.device
    key = _sig_key(a, b, float(slop), dev.index)
    sig = _K2_SIGS.get(key)
    bshape = sig[0] if sig is not None else _batch_shape(a, b, 1)
    out = BPZ(coef=torch.empty(*bshape, 3, B, device=dev, dtype=torch.float32),
              egen=torch.empty(*bshape, 3, E, device=dev, dtype=torch.float32),
              rad=torch.empty(*bshape, 3, device=dev, dtype=torch.float32))
    if sig is None:
        args = K2Args()
        args.a = _view(a, bshape, 1, "pz_cross")
        args.b = _view(b, bshape, 1, "pz_cross")
        args.out = _view(out, bshape, 1, "pz_cross")
        args.bd, n = _bd(bshape)
        args.slop = float(slop)
        if len(_K2_SIGS) >= 256:
            _K2_SIGS.clear()
        sig = _K2_SIGS[key] = (bshape, args, n,
                               torch.cuda.get_device_properties(dev).multi_processor_count)
    _, args, n, sms = sig
    for view, p in ((args.a, a), (args.b, b), (args.out, out)):
        view.coef, view.egen, view.rad = p.coef.data_ptr(), p.egen.data_ptr(), p.rad.data_ptr()
    record("pz_cross", (tuple(a.rad.shape), tuple(b.rad.shape)), (a, b, basis, slop))
    if n:
        geo = k2_geometry(n, B + E + 1, sms)
        upload_tables("pz_cross", "k2_tables", basis, E)
        fn = launcher("pz_cross", "k2_launch", _K2_TYPES)
        err = fn(ctypes.byref(args), n, B + E + 1, geo.G, geo.NG, geo.grid, _stream(a.coef))
        if err:
            raise RuntimeError(f"pz_cross launch failed: cudaError {err}")
        launched("pz_cross")
    return out

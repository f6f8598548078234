"""Launcher of kernel K16 (grasp_rows, csrc/grasp_rows.cu): the grasp
rows from the RNEA's contact wrench.  Called by grasp.grasp_rows for CUDA
tensors only; it checks device, dtype, shapes and contiguity, raises on
anything the kernel does not take, uploads the basis tables (kernels/pz.py),
allocates the outputs with torch.empty and launches on the current stream.
k16_args, k16_smem and k16_geometry are pure Python so that the CPU tests
check them."""

from __future__ import annotations

import ctypes

import torch

from . import H100_SMS, launched, record
from .build import launcher
from .pz import PZ_MAXMASS, PZ_TAB_BYTES, ChainGeometry, chain_geometry, upload_tables
from .reach import _ptrs, _require, _stream, _widths
from ..pz.basis import KBasis

K16_NG = 4                 # warps a block
K16_THREADS = 32 * K16_NG
K16_BLOCKS_PER_SM = 8      # its __launch_bounds__ (64 registers a thread)
K16_SQ = 5                 # the squares f_t0, f_t1, f_n, n_t0, n_t1
K16_SMEM_MAX = 48 * 1024   # dynamic shared memory without the opt-in, bytes


class K16Args(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "fc", "fe", "fr", "nc", "ne", "nr", "g_coef", "g_rad")] + [
        (n, ctypes.c_int) for n in ("W", "T", "P", "pset", "normal")] + [
        ("s_mu", ctypes.c_float), ("s_r", ctypes.c_float), ("slop", ctypes.c_float)]


def k16_smem(ld: int) -> int:
    """Bytes of dynamic shared memory of a K16 block (grasp_rows.cu:
    k16_smem): the tables, and per warp the mass scratch and the packed
    operands (then the rows) and squares."""
    return PZ_TAB_BYTES + 4 * K16_NG * (-(-(4 * PZ_MAXMASS + 2 * K16_SQ * ld) // 4) * 4)


def k16_geometry(n: int, ld: int, sms: int = H100_SMS) -> ChainGeometry:
    """K16's persistent grid: a warp per (world, step), K16_NG a block, as
    many blocks as stay resident (by shared memory and registers), at most
    one per K16_NG elements."""
    return chain_geometry(n, 32, K16_NG, k16_smem(ld), sms, K16_BLOCKS_PER_SM)


def k16_args(params, cfg) -> K16Args:
    """The contact model's part of K16's arguments: the normal axis, -mu^2
    and -r^2 (Python doubles rounded once to float32, as bpz.scale rounds
    them) and the float slop."""
    if not 0 <= params.normal_axis <= 2:
        raise ValueError(f"grasp_rows: normal_axis must be 0, 1 or 2, got "
                         f"{params.normal_axis}")
    args = K16Args()
    args.normal = int(params.normal_axis)
    args.s_mu = -params.mu ** 2
    args.s_r = -params.support_radius ** 2
    args.slop = float(cfg.float_slop)
    return args


def grasp_rows(f_c, n_c, params, cfg, basis: KBasis):
    """K16: GraspFRS (g_coef [W, T, 3, B], g_rad [W, T, 3]) from the RNEA's
    wrench f_c, n_c [W, P, T, 3], its interval set (the last) read in place
    (grasp.grasp_rows_plain's result)."""
    from ..grasp import GraspFRS

    if f_c.rad.dim() != 4 or f_c.rad.shape[-1] != 3:
        raise ValueError(f"grasp_rows: the wrench must be [W, P, T, 3], got "
                         f"{tuple(f_c.rad.shape)}")
    Wn, P, T, _ = f_c.rad.shape
    f = _require(f_c, "grasp_rows", (Wn, P, T, 3))
    n = _require(n_c, "grasp_rows", (Wn, P, T, 3))
    if f.rad.device != n.rad.device:
        raise ValueError("grasp_rows: f and n lie on different devices")
    B, E = _widths(basis, f, "grasp_rows")
    _widths(basis, n, "grasp_rows")
    smem = k16_smem(B + E + 1)
    if smem > K16_SMEM_MAX:
        raise ValueError(f"grasp_rows: {smem} bytes of shared memory a block exceed "
                         f"{K16_SMEM_MAX}")
    kw = dict(device=f.rad.device, dtype=torch.float32)
    g_coef = torch.empty(Wn, T, 3, B, **kw)
    g_rad = torch.empty(Wn, T, 3, **kw)
    args = k16_args(params, cfg)
    args.fc, args.fe, args.fr = _ptrs(f)
    args.nc, args.ne, args.nr = _ptrs(n)
    args.g_coef, args.g_rad = g_coef.data_ptr(), g_rad.data_ptr()
    args.W, args.T, args.P, args.pset = Wn, T, P, P - 1
    record("grasp_rows", (tuple(f_c.rad.shape), params), (f_c, n_c, params, cfg, basis))
    if Wn * T:
        upload_tables("grasp_rows", "k16_tables", basis, E)
        geo = k16_geometry(Wn * T, B + E + 1,
                           torch.cuda.get_device_properties(f.rad.device).multi_processor_count)
        fn = launcher("grasp_rows", "k16_launch",
                      [ctypes.POINTER(K16Args), ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        err = fn(ctypes.byref(args), B + E + 1, geo.grid, _stream(f.rad))
        if err:
            raise RuntimeError(f"grasp_rows launch failed: cudaError {err}")
        launched("grasp_rows")
    return GraspFRS(g_coef=g_coef, g_rad=g_rad)

"""Launcher of kernel K16 (grasp_rows, csrc/grasp_rows.cu): the grasp
rows from the RNEA's contact wrench.  Called by grasp.grasp_rows for CUDA
tensors only; it checks device, dtype, shapes and contiguity, raises on
anything the kernel does not take, uploads the basis tables (kernels/pz.py),
allocates the outputs with torch.empty and launches on the current stream;
it raises on an input that does not start 16-byte aligned.
k16_args, k16_smem and k16_geometry are pure Python so that the CPU tests
check them."""

from __future__ import annotations

import ctypes
import functools

import torch

from . import H100_SMS, launched, record
from .build import launcher, on_device
from .pz import MAX_B, MAX_PAIRS, TileGeometry, tile_geometry, upload_tables
from .reach import _ptrs, _require, _widths
from ..pz.basis import KBasis

K16_NG = 8                 # warps a block, and time steps a tile
K16_THREADS = 32 * K16_NG
K16_BLOCKS_PER_SM = 2      # its __launch_bounds__ (at most 128 registers a thread)
K16_STAGES = 2             # the ring's stages: the next tile lands while this one is squared
K16_SQ = 5                 # the squares f_t0, f_t1, f_n, n_t0, n_t1
K16_SLOTS = 4              # monomials a lane takes: MAX_B / 32
K16_RANGES = 6             # a tile's ranges: coef, egen, rad of f, then of n
K16_TAB_BYTES = 4 * MAX_PAIRS + 2 * (MAX_B + 8)  # the pairs' packed offsets, the segment bounds
K16_SMEM_MAX = 232448      # dynamic shared memory of a block after the opt-in, bytes


class K16Args(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "fc", "fe", "fr", "nc", "ne", "nr", "g_coef", "g_rad")] + [
        (n, ctypes.c_int) for n in ("W", "T", "P", "pset", "normal")] + [
        ("s_mu", ctypes.c_float), ("s_r", ctypes.c_float), ("slop", ctypes.c_float)]


def k16_slot(width: int) -> int:
    """Floats of a range's ring slot (grasp_rows.cu:k16_slot): a tile's 3
    K16_NG entries of `width` floats and 3 floats of phase, a multiple of
    4."""
    return (3 * K16_NG * width + 3 + 3) // 4 * 4


def k16_stage_floats(ld: int) -> int:
    """Floats of a ring stage (grasp_rows.cu:k16_stage_floats), bounded by
    ld = B + E + 1 alone: the six slots sum to at most 6 K16_NG ld + 32."""
    return (6 * K16_NG * ld + 36 + 3) // 4 * 4


def k16_smem(ld: int) -> int:
    """Bytes of dynamic shared memory of a K16 block (grasp_rows.cu:
    k16_smem): the pair and segment tables, the ring's stages of one tile
    each, and per warp its coefficients interleaved [MAX_B][5]."""
    return K16_TAB_BYTES + 4 * (K16_STAGES * k16_stage_floats(ld) + K16_NG * K16_SQ * MAX_B)


@functools.lru_cache(maxsize=64)
def k16_geometry(W: int, T: int, ld: int, sms: int = H100_SMS) -> TileGeometry:
    """K16's persistent grid over tiles of K16_NG steps: as many blocks as
    stay resident (by shared memory and registers: two an SM at the
    dumbbell's widths), at most one per tile.  Cached: clear the cache
    after changing this module's constants."""
    return tile_geometry(W, T, K16_NG, K16_THREADS, k16_smem(ld), sms, K16_BLOCKS_PER_SM)


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
    if Wn * P * T * 3 >= 2 ** 31:
        raise ValueError(f"grasp_rows: {Wn * P * T * 3} wrench entries exceed the kernel's "
                         "32-bit indices")
    B, E = _widths(basis, f, "grasp_rows")
    _widths(basis, n, "grasp_rows")
    for t in (f.coef, f.egen, f.rad, n.coef, n.egen, n.rad):
        if t.data_ptr() % 16:
            raise ValueError("grasp_rows: the kernel copies 16-byte chunks at each entry's phase "
                             "in its tensor, so every input must start 16-byte aligned")
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
        upload_tables("grasp_rows", "k16_tables", basis, E, f.rad.device)
        geo = k16_geometry(Wn, T, B + E + 1,
                           torch.cuda.get_device_properties(f.rad.device).multi_processor_count)
        fn = launcher("grasp_rows", "k16_launch",
                      [ctypes.POINTER(K16Args), ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        with on_device(f.rad) as stream:
            err = fn(ctypes.byref(args), B + E + 1, geo.grid, stream)
        if err:
            raise RuntimeError(f"grasp_rows launch failed: cudaError {err}")
        launched("grasp_rows")
    return GraspFRS(g_coef=g_coef, g_rad=g_rad)

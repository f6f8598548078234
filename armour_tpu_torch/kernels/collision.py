"""Launchers of the collision kernels K3 (build_hyperplanes), K4
(collision_rows, and its cell mode collision_cells) and K13
(screen_collision).  Called by collision.py for
CUDA tensors only; each checks device, dtype, shapes and contiguity, raises
on anything its kernel does not take, allocates the outputs with
torch.empty and launches on the current stream."""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import launched, record
from ..collision import smooth_shift
from .build import launcher, on_device

N_COMB = 36
_F32 = torch.float32


class K3Args(ctypes.Structure):
    _fields_ = [("shape_gens", ctypes.c_void_p), ("radius", ctypes.c_void_p),
                ("centers", ctypes.c_void_p), ("gens", ctypes.c_void_p),
                ("A", ctypes.c_void_p), ("d", ctypes.c_void_p), ("delta", ctypes.c_void_p),
                ("W", ctypes.c_int), ("T", ctypes.c_int), ("J", ctypes.c_int),
                ("O", ctypes.c_int)]


class K4Args(ctypes.Structure):
    _fields_ = [("A", ctypes.c_void_p), ("d", ctypes.c_void_p), ("delta", ctypes.c_void_p),
                ("row", ctypes.c_void_p), ("row_ws", ctypes.c_longlong),
                ("mask", ctypes.c_void_p),
                ("shape_gens", ctypes.c_void_p), ("radius", ctypes.c_void_p),
                ("centers", ctypes.c_void_p), ("gens", ctypes.c_void_p),
                ("obs_mask", ctypes.c_void_p),
                ("p_all", ctypes.c_void_p), ("dp_all", ctypes.c_void_p),
                ("g", ctypes.c_void_p), ("dg", ctypes.c_void_p),
                ("W", ctypes.c_int), ("Q", ctypes.c_int), ("C", ctypes.c_int),
                ("R", ctypes.c_int), ("TJ", ctypes.c_int), ("F", ctypes.c_int),
                ("O", ctypes.c_int), ("G", ctypes.c_int),
                ("tau", ctypes.c_float), ("tau_log2c", ctypes.c_float)]


class K13Args(ctypes.Structure):
    _fields_ = [("shape_gens", ctypes.c_void_p), ("radius", ctypes.c_void_p),
                ("centers", ctypes.c_void_p), ("gens", ctypes.c_void_p),
                ("center", ctypes.c_void_p), ("env", ctypes.c_void_p),
                ("obs_mask", ctypes.c_void_p), ("g", ctypes.c_void_p), ("idx", ctypes.c_void_p),
                ("sort", ctypes.c_void_p), ("A_out", ctypes.c_void_p),
                ("d_out", ctypes.c_void_p), ("delta_out", ctypes.c_void_p),
                ("row", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("W", ctypes.c_int), ("N", ctypes.c_int), ("TJ", ctypes.c_int),
                ("O", ctypes.c_int), ("B", ctypes.c_int), ("K", ctypes.c_int),
                ("quota", ctypes.c_int), ("Kp", ctypes.c_int), ("smem_sort", ctypes.c_int)]


# csrc/screen_collision.cu: K13_BOUND_THREADS, K13_SELECT_THREADS, K13_GATHER_THREADS
K13_BOUND_THREADS, K13_SELECT_THREADS, K13_GATHER_THREADS = 256, 1024, 256
K13_SMEM_SORT_MAX = 64 * 1024   # the sort buffer's largest size in shared memory, bytes
# csrc/collision_rows.cu: K4_THREADS, K4_MAX_G and k4_launch's cases
K4_THREADS, K4_MAX_G = 256, 6
K4_GROUPS = (1, 2, 4, 6)


def k4_group(Q: int) -> int:
    """K4's queries a thread (its grid, collision_rows.cu:k4_launch_g:
    blocks of K4_THREADS rows, groups of G queries, worlds): the fewest
    groups of at most K4_MAX_G queries, then the least G of K4_GROUPS that
    covers Q in that many groups.  The planning paths send the full-set
    check Q = 1 or 2S', the screened rows Q = S, S' and each times the A
    line-search alphas (S seeds, S' kept after the cull: 4, 2 and A = 3 at
    the default profile), so Q = 1, 2, 4, 6, 12 and G = 1, 2, 4, 6, 6 with
    no query padded."""
    n = -(-Q // K4_MAX_G) if Q > 0 else 1
    return next(G for G in K4_GROUPS if G * n >= Q)


def _k4_check_group(G: int) -> None:
    if G not in K4_GROUPS:
        raise ValueError(f"K4 takes {K4_GROUPS} queries a thread, not {G}")


@dataclasses.dataclass(frozen=True)
class ScreenGeometry:
    """K13's launch: (a) bound_grid = (blocks over N, W) of
    K13_BOUND_THREADS; (b) W blocks of K13_SELECT_THREADS, the sort over Kp
    (a power of two >= K) entries of 8 bytes, in smem_bytes of dynamic
    shared memory or (smem_bytes = 0) in a global scratch [W, Kp]; (c)
    gather_blocks of K13_GATHER_THREADS, a thread per (world, chosen row)."""

    bound_grid: tuple
    Kp: int
    smem_bytes: int
    gather_blocks: int


def k13_geometry(Wn: int, N: int, K: int) -> ScreenGeometry:
    Kp = 1
    while Kp < K:
        Kp <<= 1
    smem = Kp * 8 if Kp * 8 <= K13_SMEM_SORT_MAX else 0
    return ScreenGeometry(bound_grid=(-(-N // K13_BOUND_THREADS), Wn), Kp=Kp, smem_bytes=smem,
                          gather_blocks=-(-(Wn * K) // K13_GATHER_THREADS))


def _require(t: torch.Tensor, name: str, shape, dtype=_F32) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def build_hyperplanes(shape_gens, radius, centers, generators):
    """K3: (A [W,3,C,N], d [W,C,N], delta [W,C,N]) from the link shape
    generators [W,T,J,3,3], radii [W,T,J,3] and the obstacles [W,O,3(,3)]."""
    Wn, T, J = radius.shape[:3]
    O = centers.shape[1]
    _require(shape_gens, "shape_gens", (Wn, T, J, 3, 3))
    _require(radius, "radius", (Wn, T, J, 3))
    _require(centers, "centers", (Wn, O, 3))
    _require(generators, "generators", (Wn, O, 3, 3))
    N = T * J * O
    dev = radius.device
    A = torch.empty(Wn, 3, N_COMB, N, device=dev, dtype=_F32)
    d = torch.empty(Wn, N_COMB, N, device=dev, dtype=_F32)
    delta = torch.empty(Wn, N_COMB, N, device=dev, dtype=_F32)
    record("build_hyperplanes", (tuple(radius.shape), O), (shape_gens, radius, centers, generators))
    if Wn * N:
        args = K3Args(shape_gens.data_ptr(), radius.data_ptr(), centers.data_ptr(),
                      generators.data_ptr(), A.data_ptr(), d.data_ptr(), delta.data_ptr(),
                      Wn, T, J, O)
        fn = launcher("build_hyperplanes", "k3_launch",
                      [ctypes.POINTER(K3Args), ctypes.c_void_p])
        with on_device(radius) as stream:
            err = fn(ctypes.byref(args), stream)
        if err:
            raise RuntimeError(f"build_hyperplanes launch failed: cudaError {err}")
        launched("build_hyperplanes")
    return A, d, delta


def _k4_launch(args: K4Args, like: torch.Tensor) -> None:
    fn = launcher("collision_rows", "k4_launch", [ctypes.POINTER(K4Args), ctypes.c_void_p])
    with on_device(like) as stream:
        err = fn(ctypes.byref(args), stream)
    if err:
        raise RuntimeError(f"collision_rows launch failed: cudaError {err}")
    launched("collision_rows")


def collision_rows(A, d, delta, row, mask, p_all, dp_all=None, *, smooth_tau: float = 0.0):
    """K4: g [W,Q,R] and, when dp_all is given, dg/dk [W,Q,R,F] of rows with
    normals A [W,3,C,R], offsets d, buffers delta [W,C,R], link cell index
    row ([W,R], or [R] shared by every world, int32) and real-obstacle mask
    [W,R], at link centres p_all [W,Q,3,TJ] (dp_all [W,Q,3,F,TJ]).
    smooth_tau > 0: the smooth mode (collision.screened_constraints), for
    screened rows only; the full set (row [R]) is the exact check."""
    return _collision_rows(A, d, delta, row, mask, p_all, dp_all, smooth_tau,
                           k4_group(p_all.shape[1]))


def _collision_rows(A, d, delta, row, mask, p_all, dp_all, smooth_tau: float, G: int):
    """collision_rows at G queries a thread (one of K4_GROUPS): every G
    gives the same bits, and the checks hold k4_group's G against G = 1."""
    Wn, _, C, R = A.shape
    Q, TJ = p_all.shape[1], p_all.shape[-1]
    smooth = smooth_tau > 0
    if smooth and row.dim() == 1:
        raise ValueError("K4's smooth mode takes screened rows (row [W, R]); the full-set "
                         "check over a shared row [R] stays exact")
    _k4_check_group(G)
    _require(A, "A", (Wn, 3, C, R))
    _require(d, "d", (Wn, C, R))
    _require(delta, "delta", (Wn, C, R))
    _require(mask, "mask", (Wn, R), torch.bool)
    _require(p_all, "p_all", (Wn, Q, 3, TJ))
    if row.dim() == 1:
        _require(row, "row", (R,), torch.int32)
        row_ws = 0
    else:
        _require(row, "row", (Wn, R), torch.int32)
        row_ws = R
    F = 0
    if dp_all is not None:
        F = dp_all.shape[3]
        _require(dp_all, "dp_all", (Wn, Q, 3, F, TJ))
    dev = A.device
    g = torch.empty(Wn, Q, R, device=dev, dtype=_F32)
    dg = torch.empty(Wn, Q, R, F, device=dev, dtype=_F32) if dp_all is not None else None
    key = (tuple(A.shape), tuple(p_all.shape), row.dim(), dp_all is not None)
    record("collision_rows", key + (("smooth", float(smooth_tau)) if smooth else ()),
           (A, d, delta, row, mask, p_all, dp_all, smooth_tau))
    if Wn * Q * R:
        args = K4Args(A=A.data_ptr(), d=d.data_ptr(), delta=delta.data_ptr(),
                      row=row.data_ptr(), row_ws=row_ws, mask=mask.data_ptr(),
                      p_all=p_all.data_ptr(),
                      dp_all=dp_all.data_ptr() if dp_all is not None else None,
                      g=g.data_ptr(), dg=dg.data_ptr() if dg is not None else None,
                      W=Wn, Q=Q, C=C, R=R, TJ=TJ, F=F, G=G)
        if smooth:
            args.tau = smooth_tau
            args.tau_log2c = float(smooth_shift(smooth_tau, C, _F32))
        _k4_launch(args, A)
    return g, dg


def collision_cells(shape_gens, radius, centers, generators, obs_mask, p_all):
    """K4's cell mode, the full-set check formed from the cells: g [W,Q,N]
    (N = T*J*O rows, obstacle fastest; -BIG for a padded obstacle's) from the
    link shape generators [W,T,J,3,3], radii [W,T,J,3], the obstacles'
    centres [W,O,3], generators [W,O,3,3] and real-obstacle mask [W,O], at
    link centres p_all [W,Q,3,T*J].  The kernel forms each row's 36
    hyperplanes with K3's device code: the bits of collision_rows over K3's
    tensors of the same cells, with no hyperplane tensor made."""
    return _collision_cells(shape_gens, radius, centers, generators, obs_mask, p_all,
                            k4_group(p_all.shape[1]))


def _collision_cells(shape_gens, radius, centers, generators, obs_mask, p_all, G: int):
    """collision_cells at G queries a thread (one of K4_GROUPS)."""
    Wn, T, J = radius.shape[:3]
    O = obs_mask.shape[-1]
    Q, TJ = p_all.shape[1], T * J
    N = TJ * O
    _k4_check_group(G)
    _require(shape_gens, "shape_gens", (Wn, T, J, 3, 3))
    _require(radius, "radius", (Wn, T, J, 3))
    _require(centers, "centers", (Wn, O, 3))
    _require(generators, "generators", (Wn, O, 3, 3))
    _require(obs_mask, "obs_mask", (Wn, O), torch.bool)
    _require(p_all, "p_all", (Wn, Q, 3, TJ))
    g = torch.empty(Wn, Q, N, device=radius.device, dtype=_F32)
    record("collision_rows", (tuple(radius.shape), O, tuple(p_all.shape), "cells"),
           (shape_gens, radius, centers, generators, obs_mask, p_all))
    if Wn * Q * N:
        args = K4Args(shape_gens=shape_gens.data_ptr(), radius=radius.data_ptr(),
                      centers=centers.data_ptr(), gens=generators.data_ptr(),
                      obs_mask=obs_mask.data_ptr(), p_all=p_all.data_ptr(), g=g.data_ptr(),
                      W=Wn, Q=Q, C=N_COMB, R=N, TJ=TJ, O=O, G=G)
        _k4_launch(args, radius)
    return g


def screen_collision(shape_gens, radius, centers, generators, center_coef, env, obs_mask,
                     K: int, obstacle_quota: int = 0):
    """K13: the K worst rows (collision.py:screen_collision_plain's order)
    of the cells' hyperplanes, which the kernel forms itself with K3's code
    from the link shape generators [W,T,J,3,3], radii [W,T,J,3] and the
    obstacles' centres [W,O,3] and generators [W,O,3,3] (N = T*J*O rows,
    obstacle fastest), at the link centres center_coef [W,T,J,3,B] with
    their envelope env [W,T,J,3] (collision.screen_envelope) and the
    real-obstacle mask obs_mask [W,O]: (A [W,3,C,K'], d [W,C,K'], delta
    [W,C,K'], row int32 [W,K'], mask [W,K']), K' = min(K, N)."""
    Wn, T, J, _, B = center_coef.shape
    O = obs_mask.shape[-1]
    N = T * J * O
    if tuple(centers.shape) != (Wn, O, 3) or tuple(generators.shape) != (Wn, O, 3, 3):
        raise ValueError(f"the obstacles' centres {tuple(centers.shape)} / generators "
                         f"{tuple(generators.shape)} do not match the mask's {O} obstacles")
    _require(shape_gens, "shape_gens", (Wn, T, J, 3, 3))
    _require(radius, "radius", (Wn, T, J, 3))
    _require(centers, "centers", (Wn, O, 3))
    _require(generators, "generators", (Wn, O, 3, 3))
    _require(center_coef, "center_coef", (Wn, T, J, 3, B))
    _require(env, "env", (Wn, T, J, 3))
    _require(obs_mask, "obs_mask", (Wn, O), torch.bool)
    Kk = min(K, N)
    quota = obstacle_quota if obstacle_quota > 0 and obstacle_quota * O < Kk else 0
    dev = radius.device
    C = N_COMB
    A_out = torch.empty(Wn, 3, C, Kk, device=dev, dtype=_F32)
    d_out = torch.empty(Wn, C, Kk, device=dev, dtype=_F32)
    delta_out = torch.empty(Wn, C, Kk, device=dev, dtype=_F32)
    row = torch.empty(Wn, Kk, device=dev, dtype=torch.int32)
    mask = torch.empty(Wn, Kk, device=dev, dtype=torch.bool)
    record("screen_collision", (tuple(radius.shape), O, Kk, quota),
           (shape_gens, radius, centers, generators, center_coef, env, obs_mask, K,
            obstacle_quota))
    if Wn * Kk:
        geo = k13_geometry(Wn, N, Kk)
        g = torch.empty(Wn, N, device=dev, dtype=_F32)
        idx = torch.empty(Wn, Kk, device=dev, dtype=torch.int32)
        sort = (torch.empty(Wn, geo.Kp, device=dev, dtype=torch.int64)
                if geo.smem_bytes == 0 else None)
        args = K13Args(shape_gens.data_ptr(), radius.data_ptr(), centers.data_ptr(),
                       generators.data_ptr(), center_coef.data_ptr(), env.data_ptr(),
                       obs_mask.data_ptr(), g.data_ptr(), idx.data_ptr(),
                       sort.data_ptr() if sort is not None else None, A_out.data_ptr(),
                       d_out.data_ptr(), delta_out.data_ptr(), row.data_ptr(), mask.data_ptr(),
                       Wn, N, T * J, O, B, Kk, quota, geo.Kp, int(geo.smem_bytes > 0))
        fn = launcher("screen_collision", "k13_launch",
                      [ctypes.POINTER(K13Args), ctypes.c_int, ctypes.c_void_p])
        with on_device(radius) as stream:
            err = fn(ctypes.byref(args), geo.smem_bytes, stream)
        if err:
            raise RuntimeError(f"screen_collision launch failed: cudaError {err}")
        launched("screen_collision", 3)
    return A_out, d_out, delta_out, row, mask

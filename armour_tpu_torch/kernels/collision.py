"""Launchers of the collision kernels K3 (build_hyperplanes) and K4
(collision_rows).  Called by collision.py for CUDA tensors only; each checks
device, dtype, shapes and contiguity, raises on anything its kernel does not
take, allocates the outputs with torch.empty and launches on the current
stream."""

from __future__ import annotations

import ctypes

import torch

from . import launched, record
from .build import launcher

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
                ("p_all", ctypes.c_void_p), ("dp_all", ctypes.c_void_p),
                ("g", ctypes.c_void_p), ("dg", ctypes.c_void_p),
                ("W", ctypes.c_int), ("Q", ctypes.c_int), ("C", ctypes.c_int),
                ("R", ctypes.c_int), ("TJ", ctypes.c_int), ("F", ctypes.c_int)]


def _require(t: torch.Tensor, name: str, shape, dtype=_F32) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


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
        err = fn(ctypes.byref(args), _stream(radius))
        if err:
            raise RuntimeError(f"build_hyperplanes launch failed: cudaError {err}")
        launched("build_hyperplanes")
    return A, d, delta


def collision_rows(A, d, delta, row, mask, p_all, dp_all=None):
    """K4: g [W,Q,R] and, when dp_all is given, dg/dk [W,Q,R,F] of rows with
    normals A [W,3,C,R], offsets d, buffers delta [W,C,R], link cell index
    row ([W,R], or [R] shared by every world, int32) and real-obstacle mask
    [W,R], at link centres p_all [W,Q,3,TJ] (dp_all [W,Q,3,F,TJ])."""
    Wn, _, C, R = A.shape
    Q, TJ = p_all.shape[1], p_all.shape[-1]
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
    record("collision_rows", (tuple(A.shape), tuple(p_all.shape), row.dim(), dp_all is not None),
           (A, d, delta, row, mask, p_all, dp_all))
    if Wn * Q * R:
        args = K4Args(A.data_ptr(), d.data_ptr(), delta.data_ptr(), row.data_ptr(), row_ws,
                      mask.data_ptr(), p_all.data_ptr(),
                      dp_all.data_ptr() if dp_all is not None else None,
                      g.data_ptr(), dg.data_ptr() if dg is not None else None,
                      Wn, Q, C, R, TJ, F)
        fn = launcher("collision_rows", "k4_launch", [ctypes.POINTER(K4Args), ctypes.c_void_p])
        err = fn(ctypes.byref(args), _stream(A))
        if err:
            raise RuntimeError(f"collision_rows launch failed: cudaError {err}")
        launched("collision_rows")
    return g, dg

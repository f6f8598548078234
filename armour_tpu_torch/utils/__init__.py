"""Small helpers shared by the port's modules."""

import numpy as np
import torch


def to_device(x, dtype, device) -> torch.Tensor:
    """Host array -> tensor on `device` without a stream synchronisation
    (a pageable host-to-device copy is staged before the call returns)."""
    return torch.as_tensor(np.asarray(x), dtype=dtype).to(device, non_blocking=True)


_DIVISORS = {}


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c for a Python number c, an IEEE division on every device.

    On a CUDA tensor, x / c with c a Python number is a multiply by c's
    float32 reciprocal (ATen's shortcut), one ulp from the division the CPU,
    the JAX package and the kernels compute; dividing by c as a 0-d tensor
    on x's device (formed once per value, dtype and device) divides."""
    key = (float(c), x.dtype, x.device)
    t = _DIVISORS.get(key)
    if t is None:
        t = torch.tensor(float(c), dtype=x.dtype, device=x.device)
        _DIVISORS[key] = t
    return x / t


def abs_sum_in_order(*parts: torch.Tensor) -> torch.Tensor:
    """sum |x| over the last axis of each part, the parts one after another,
    each left to right, from 0: the order kernel K15 sums in
    (csrc/reach_assembly.cu).  torch.sum's order is its own and differs
    between devices, so a sum that a kernel must repeat bit for bit is
    taken here."""
    total = parts[0].new_zeros(parts[0].shape[:-1])
    for x in parts:
        a = torch.abs(x)
        for i in range(a.shape[-1]):
            total = total + a[..., i]
    return total


_LANES = 32


def warp_sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """sum x over the last axis in the order of a warp reduction of
    csrc/pz_ops.cuh (pz_mass_loop, pz_mul_coefs): lane l sums x[l],
    x[l + 32], ... from 0, then a shuffle butterfly (each lane adds the
    partial sum of lane l ^ 16, then l ^ 8, ..., l ^ 1), lane 0's sum."""
    n = x.shape[-1]
    chunks = max(1, -(-n // _LANES))
    if chunks * _LANES != n:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (chunks * _LANES - n,))], dim=-1)
    parts = x.reshape(x.shape[:-1] + (chunks, _LANES))
    s = x.new_zeros(x.shape[:-1] + (_LANES,))
    for i in range(chunks):
        s = s + parts[..., i, :]
    lane = torch.arange(_LANES, device=x.device)
    for off in (16, 8, 4, 2, 1):
        s = s + s[..., lane ^ off]
    return s[..., 0]

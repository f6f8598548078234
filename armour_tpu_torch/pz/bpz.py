"""Batched polynomial zonotopes (BPZ) as dense tensors (counterpart of
armour_tpu/pz/bpz.py).

A BPZ represents, per tensor entry, the set

    { coef[0] + sum_m coef[m] * phi_m(k) + sum_e egen[e] * eps_e + rad * eps
      : k in [-1,1]^nf, eps_e in [-1,1], eps in [-1,1] }

with phi_m the static k-monomial basis, egen the linear error-generator block
and rad an independent interval radius.  Every op broadcasts over leading
batch dims (worlds, parameter sets, time steps).

Two ops have hand-written CUDA kernels: `matmul_linear` (and its
right-operand form) and `cross`.  Each is a wrapper that takes its plain
PyTorch version (`matmul_linear_plain`, `cross_plain`) for CPU tensors and
launches the kernel for CUDA tensors (kernels/pz.py), raising on anything the
kernel does not take.  The elementwise product `mul` runs on the card only
fused into the grasp rows (kernel K16, grasp.py), in the fixed order of
`_mul`; `mul` itself takes CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..utils import warp_sum_in_order
from .basis import KBasis, error_layout, linear_tables, pair_segments


@dataclasses.dataclass
class BPZ:
    coef: torch.Tensor  # [..., B] k-poly coefficients; index 0 = center
    egen: torch.Tensor  # [..., E] linear error-generator coefficients
    rad: torch.Tensor   # [...]    independent radius (>= 0)

    @property
    def center(self) -> torch.Tensor:
        return self.coef[..., 0]

    @property
    def shape(self):
        return self.rad.shape


def _tables(basis: KBasis, like: torch.Tensor) -> dict:
    """Device tables of the basis plus the float tables for like's dtype."""
    tab = basis.device_tables(like.device)
    key = ("float", like.dtype)
    if key not in tab:
        src, ovf = linear_tables(basis.nf, basis.max_degree)
        S = torch.zeros(len(basis.pair_m), basis.size, dtype=like.dtype)
        S[torch.arange(len(basis.pair_m)), torch.as_tensor(basis.pair_m, dtype=torch.int64)] = 1.0
        tab[key] = {
            "scatter": S.to(like.device),
            "src": torch.as_tensor(src, dtype=torch.int64).to(like.device),
            "ovf": torch.as_tensor(ovf, dtype=like.dtype).to(like.device),
        }
    return {**tab, **tab[key]}


def zeros(shape, basis: KBasis, dtype=torch.float32, *, device="cpu") -> BPZ:
    E = error_layout(basis.nf)["size"]
    return BPZ(
        coef=torch.zeros((*shape, basis.size), dtype=dtype, device=device),
        egen=torch.zeros((*shape, E), dtype=dtype, device=device),
        rad=torch.zeros(shape, dtype=dtype, device=device),
    )


def const(x: torch.Tensor, basis: KBasis) -> BPZ:
    z = zeros(x.shape, basis, x.dtype, device=x.device)
    z.coef[..., 0] = x
    return z


def from_interval(center: torch.Tensor, radius: torch.Tensor, basis: KBasis) -> BPZ:
    """PZ with only an independent interval part."""
    p = const(center, basis)
    return BPZ(coef=p.coef, egen=p.egen,
               rad=torch.broadcast_to(radius.to(p.rad.dtype), p.rad.shape).clone())


def add(a: BPZ, b: BPZ) -> BPZ:
    return BPZ(coef=a.coef + b.coef, egen=a.egen + b.egen, rad=a.rad + b.rad)


def neg(a: BPZ) -> BPZ:
    return BPZ(coef=-a.coef, egen=-a.egen, rad=a.rad)


def sub(a: BPZ, b: BPZ) -> BPZ:
    return add(a, neg(b))


def scale(a: BPZ, s: float) -> BPZ:
    """Multiply by an exact scalar."""
    return BPZ(coef=a.coef * s, egen=a.egen * s, rad=a.rad * abs(s))


# ---------------------------------------------------------------------------
# Bilinear core (armour_tpu/pz/bpz.py:105-167).
# prod(x, y): pairing of coefficient tensors with a trailing aligned axis;
# absprod(x, y): the same pairing on nonnegative magnitudes without it.
# ---------------------------------------------------------------------------


def _bc_last(x: torch.Tensor, n: int) -> torch.Tensor:
    return x[..., None].expand(*x.shape, n)


def bilinear(a: BPZ, b: BPZ, prod: Callable, absprod: Callable, basis: KBasis,
             slop: float = 0.0, absprod_t: Callable | None = None) -> BPZ:
    """Generic PZ x PZ bilinear product: in-basis k-poly products through the
    static pair table, everything else outward-rounded into rad."""
    tab = _tables(basis, a.coef)
    gA = a.coef[..., tab["pair_i"]]             # [..., amat, P]
    gB = b.coef[..., tab["pair_j"]]             # [..., bmat, P]
    pp = prod(gA, gB)                           # [..., omat, P]
    coef = pp @ tab["scatter"]                  # [..., omat, B]
    # |a_i||b_j| over in-table pairs, abs before any contraction so that
    # in-basis cancellation is not charged to the radius
    abs_pair = absprod_t if absprod_t is not None else prod
    in_abs = torch.sum(abs_pair(torch.abs(gA), torch.abs(gB)), dim=-1)

    Sa = torch.sum(torch.abs(a.coef), dim=-1)
    Sb = torch.sum(torch.abs(b.coef), dim=-1)
    overflow = torch.clamp(absprod(Sa, Sb) - in_abs, min=0.0)

    a0 = a.coef[..., 0]
    b0 = b.coef[..., 0]
    E = a.egen.shape[-1]
    egen = prod(a.egen, _bc_last(b0, E)) + prod(_bc_last(a0, E), b.egen)

    Ea = torch.sum(torch.abs(a.egen), dim=-1)
    Eb = torch.sum(torch.abs(b.egen), dim=-1)
    Ta = Sa + Ea
    Tb = Sb + Eb

    rad = (
        absprod(Ta, b.rad)
        + absprod(a.rad, Tb)
        + absprod(a.rad, b.rad)
        + absprod(Ea, Sb - torch.abs(b0))
        + absprod(Sa - torch.abs(a0), Eb)
        + absprod(Ea, Eb)
        + overflow
    )
    if slop:
        rad = rad + slop * (torch.sum(torch.abs(coef), dim=-1)
                            + torch.sum(torch.abs(egen), dim=-1) + rad)
    return BPZ(coef=coef, egen=egen, rad=rad)


def mul(a: BPZ, b: BPZ, basis: KBasis, slop: float = 0.0) -> BPZ:
    """Elementwise (Hadamard) product with broadcasting, the bilinear core
    with the pair table (armour_tpu/pz/bpz.py:170).  The two operands are
    independent: mul(p, p) is not a tightened square.  CPU tensors only: on
    the card the product runs fused into kernel K16 (grasp.grasp_frs), and
    no port code calls it there."""
    if a.coef.is_cuda or b.coef.is_cuda:
        raise ValueError("bpz.mul takes CPU tensors; on the card the product runs in kernel "
                         "K16 (grasp.grasp_frs)")
    return _mul(a, b, basis, slop)


def _segment_table(basis: KBasis, device) -> tuple:
    """The pair table by output monomial as rank-major index tables
    [L, B] (L the longest segment): the r-th pair of monomial m, or B (a
    zero sentinel) past its segment's end."""
    tab = basis.device_tables(device)
    if "seg_i" not in tab:
        pi, pj, seg = pair_segments(basis.nf, basis.max_degree)
        B = basis.size
        L = int((seg[1:] - seg[:-1]).max())
        ti = torch.full((L, B), B, dtype=torch.int64)
        tj = torch.full((L, B), B, dtype=torch.int64)
        for m in range(B):
            n = int(seg[m + 1] - seg[m])
            ti[:n, m] = torch.as_tensor(pi[seg[m]:seg[m + 1]], dtype=torch.int64)
            tj[:n, m] = torch.as_tensor(pj[seg[m]:seg[m + 1]], dtype=torch.int64)
        tab["seg_i"], tab["seg_j"] = ti.to(device), tj.to(device)
    return tab["seg_i"], tab["seg_j"]


def _mul(a: BPZ, b: BPZ, basis: KBasis, slop: float = 0.0) -> BPZ:
    """mul on any device, every sum in the fixed order of kernel K16
    (pz_ops.cuh: pz_mul): each coefficient over its monomial's pairs in
    pair-table order (basis.pair_segments) from 0; the in-table magnitudes
    per monomial in the same order, then over the monomials in a warp's
    order (utils.warp_sum_in_order), as the abs sums of coef and egen; the
    radius' terms as written (bpz.py:146-166)."""
    shape = torch.broadcast_shapes(a.rad.shape, b.rad.shape)
    B, E = a.coef.shape[-1], a.egen.shape[-1]
    a = BPZ(coef=a.coef.expand(*shape, B), egen=a.egen.expand(*shape, E),
            rad=a.rad.expand(shape))
    b = BPZ(coef=b.coef.expand(*shape, B), egen=b.egen.expand(*shape, E),
            rad=b.rad.expand(shape))
    ti, tj = _segment_table(basis, a.coef.device)
    pad = a.coef.new_zeros(shape + (1,))
    ca, cb = torch.cat([a.coef, pad], dim=-1), torch.cat([b.coef, pad], dim=-1)
    coef = torch.zeros_like(ca[..., :B])
    seg_abs = torch.zeros_like(coef)
    for r in range(ti.shape[0]):
        x, y = ca[..., ti[r]], cb[..., tj[r]]
        coef = coef + x * y
        seg_abs = seg_abs + torch.abs(x) * torch.abs(y)
    in_abs = warp_sum_in_order(seg_abs)
    Sa, Sb = warp_sum_in_order(torch.abs(a.coef)), warp_sum_in_order(torch.abs(b.coef))
    overflow = torch.clamp(Sa * Sb - in_abs, min=0.0)
    a0, b0 = a.coef[..., 0], b.coef[..., 0]
    egen = a.egen * b0[..., None] + a0[..., None] * b.egen
    Ea, Eb = warp_sum_in_order(torch.abs(a.egen)), warp_sum_in_order(torch.abs(b.egen))
    Ta, Tb = Sa + Ea, Sb + Eb
    rad = (Ta * b.rad + a.rad * Tb + a.rad * b.rad + Ea * (Sb - torch.abs(b0))
           + (Sa - torch.abs(a0)) * Eb + Ea * Eb + overflow)
    if slop:
        rad = rad + slop * (warp_sum_in_order(torch.abs(coef))
                            + warp_sum_in_order(torch.abs(egen)) + rad)
    return BPZ(coef=coef, egen=egen, rad=rad)


def interval_operand(p: BPZ):
    """Sound (center, radius) interval enclosure of a PZ, for use as the
    interval operand of mul_interval/matmul_interval (exact for
    from_interval PZs)."""
    rad = (p.rad + torch.sum(torch.abs(p.egen), dim=-1)
           + torch.sum(torch.abs(p.coef[..., 1:]), dim=-1))
    return p.coef[..., 0], rad


def mul_interval(c: torch.Tensor, r: torch.Tensor, b: BPZ, slop: float = 0.0) -> BPZ:
    """(c + r*[-1,1]) * b elementwise, exact for a pure interval left
    operand.  (c, r) must enclose the operand: build them with
    interval_operand."""
    cc = c[..., None]
    coef = cc * b.coef
    egen = cc * b.egen
    Tb = (torch.sum(torch.abs(b.coef), dim=-1) + torch.sum(torch.abs(b.egen), dim=-1)
          + b.rad)
    rad = torch.abs(c) * b.rad + r * Tb
    if slop:
        rad = rad + slop * (torch.sum(torch.abs(coef), dim=-1)
                            + torch.sum(torch.abs(egen), dim=-1) + rad)
    return BPZ(coef=coef, egen=egen, rad=rad)


def matmul_linear_plain(a: BPZ, b: BPZ, basis: KBasis, slop: float = 0.0) -> BPZ:
    """Plain version of kernel K1 (armour_tpu/pz/bpz.py:214-285): a @ b where
    a is a matrix PZ whose k-coefficients are degree <= 1, through the
    [nf, B] shift-gather table.  a [..., n, m, :], b [..., m, p, :]."""
    tab = _tables(basis, a.coef)
    SRC, ovf_mask, lin = tab["src"], tab["ovf"], tab["lin"]
    n, m = a.coef.shape[-3], a.coef.shape[-2]
    p = b.coef.shape[-2]

    a0 = a.coef[..., 0]                                 # [..., n, m]
    a_lin = a.coef[..., lin]                            # [..., n, m, F]
    b0 = b.coef[..., 0]                                 # [..., m, p]
    b_pad = torch.cat([b.coef, torch.zeros_like(b.coef[..., :1])], dim=-1)
    gath = b_pad[..., SRC]                              # [..., m, p, F, B]

    Sa = torch.sum(torch.abs(a.coef), dim=-1)
    Ea = torch.sum(torch.abs(a.egen), dim=-1)
    Sb = torch.sum(torch.abs(b.coef), dim=-1)
    Eb = torch.sum(torch.abs(b.egen), dim=-1)
    Ta = Sa + Ea
    Tb = Sb + Eb
    A1 = torch.sum(torch.abs(a_lin), dim=-1)            # [..., n, m]
    ovfsum = torch.sum(torch.abs(b.coef) * ovf_mask, dim=-1)   # [..., m, p]

    # every (i, k, j) term at once as [..., n, p, m, ...] (a's [..., n, m] as
    # [..., n, 1, m], b's [..., m, p] as [..., 1, p, m]); the sum over j then
    # runs in the order of a loop over j
    def bt(x):
        return x.transpose(-2, -1)[..., None, :, :]

    def bt_vec(x):
        return x.transpose(-3, -2)[..., None, :, :, :]

    a0_ = a0[..., :, None, :]
    c_all = (a0_[..., None] * bt_vec(b.coef)
             + torch.sum(a_lin[..., :, None, :, :, None]
                         * gath.transpose(-4, -3)[..., None, :, :, :, :], dim=-2))
    e_all = a0_[..., None] * bt_vec(b.egen) + a.egen[..., :, None, :, :] * bt(b0)[..., None]
    r_all = (Ta[..., :, None, :] * bt(b.rad)
             + a.rad[..., :, None, :] * (bt(Tb) + bt(b.rad))
             + Ea[..., :, None, :] * (bt(Sb) - torch.abs(bt(b0)) + bt(Eb))
             + (Sa - torch.abs(a0))[..., :, None, :] * bt(Eb)
             + A1[..., :, None, :] * bt(ovfsum))
    coef, egen, rad = c_all[..., 0, :], e_all[..., 0, :], r_all[..., 0]
    for j in range(1, m):
        coef = coef + c_all[..., j, :]
        egen = egen + e_all[..., j, :]
        rad = rad + r_all[..., j]
    if slop:
        rad = rad + slop * (torch.sum(torch.abs(coef), dim=-1)
                            + torch.sum(torch.abs(egen), dim=-1) + rad)
    return BPZ(coef=coef, egen=egen, rad=rad)


def _transpose_mat(p: BPZ) -> BPZ:
    """Swap the two matrix axes (a view: no copy)."""
    return BPZ(coef=p.coef.transpose(-3, -2), egen=p.egen.transpose(-3, -2),
               rad=p.rad.transpose(-2, -1))


def matmul_linear(a: BPZ, b: BPZ, basis: KBasis, slop: float = 0.0) -> BPZ:
    """a @ b with a degree<=1 rotation PZ on the left.  Kernel K1 on CUDA
    tensors, matmul_linear_plain on CPU tensors."""
    if not a.coef.is_cuda:
        return matmul_linear_plain(a, b, basis, slop)
    from ..kernels import pz as kpz

    return kpz.matmul_linear(a, b, basis, slop)


def matmul_linear_right_plain(a: BPZ, b_lin: BPZ, basis: KBasis,
                              slop: float = 0.0) -> BPZ:
    """a @ b_lin with the degree<=1 operand on the right:
    (b_lin^T @ a^T)^T (armour_tpu/pz/bpz.py:294-300)."""
    return _transpose_mat(matmul_linear_plain(
        _transpose_mat(b_lin), _transpose_mat(a), basis, slop))


def matmul_linear_right(a: BPZ, b_lin: BPZ, basis: KBasis, slop: float = 0.0) -> BPZ:
    """a @ b_lin with the rotation PZ on the right.  On CUDA the kernel K1
    reads the transposed operands and writes the transposed result through
    strides, without copies."""
    if not a.coef.is_cuda:
        return matmul_linear_right_plain(a, b_lin, basis, slop)
    from ..kernels import pz as kpz

    return kpz.matmul_linear(_transpose_mat(b_lin), _transpose_mat(a), basis, slop,
                             transpose_out=True)


def matvec_const_coef(a: BPZ, b: BPZ, slop: float = 0.0) -> BPZ:
    """a [..., n, m, :] @ b [..., m, :] where b's k-coefficients live only at
    the constant monomial (link box PZs): exact, no pair table."""
    n, m = a.coef.shape[-3], a.coef.shape[-2]
    b0 = b.coef[..., 0]
    Sa = torch.sum(torch.abs(a.coef), dim=-1)
    Ea = torch.sum(torch.abs(a.egen), dim=-1)
    Eb = torch.sum(torch.abs(b.egen), dim=-1)
    Ta = Sa + Ea

    rows_c, rows_e, rows_r = [], [], []
    for i in range(n):
        cacc = eacc = racc = None
        for j in range(m):
            c_j = a.coef[..., i, j, :] * b0[..., j, None]
            e_j = (a.coef[..., i, j, 0, None] * b.egen[..., j, :]
                   + a.egen[..., i, j, :] * b0[..., j, None])
            r_j = (Ta[..., i, j] * b.rad[..., j]
                   + a.rad[..., i, j] * (torch.abs(b0[..., j]) + Eb[..., j]
                                         + b.rad[..., j])
                   + (Sa[..., i, j] - torch.abs(a.coef[..., i, j, 0])
                      + Ea[..., i, j]) * Eb[..., j])
            cacc = c_j if cacc is None else cacc + c_j
            eacc = e_j if eacc is None else eacc + e_j
            racc = r_j if racc is None else racc + r_j
        rows_c.append(cacc)
        rows_e.append(eacc)
        rows_r.append(racc)
    coef = torch.stack(rows_c, dim=-2)
    egen = torch.stack(rows_e, dim=-2)
    rad = torch.stack(rows_r, dim=-1)
    if slop:
        rad = rad + slop * (torch.sum(torch.abs(coef), dim=-1)
                            + torch.sum(torch.abs(egen), dim=-1) + rad)
    return BPZ(coef=coef, egen=egen, rad=rad)


def matmul_interval(C: torch.Tensor, R: torch.Tensor, b: BPZ, slop: float = 0.0) -> BPZ:
    """(C + R*[-1,1]) @ b for an interval matrix (C, R [..., n, m]) and a
    matrix PZ b [..., m, p, :]: exact for an interval operand."""
    n, m = C.shape[-2], C.shape[-1]
    p = b.coef.shape[-2]
    Tb = (torch.sum(torch.abs(b.coef), dim=-1) + torch.sum(torch.abs(b.egen), dim=-1)
          + b.rad)

    def rowcol(x, M, i, k):
        acc = M[..., i, 0, None] * x[..., 0, k, :]
        for j in range(1, m):
            acc = acc + M[..., i, j, None] * x[..., j, k, :]
        return acc

    rows_c, rows_e, rows_r = [], [], []
    absC, absR = torch.abs(C), torch.abs(R)
    for i in range(n):
        cols_c, cols_e, cols_r = [], [], []
        for k in range(p):
            cols_c.append(rowcol(b.coef, C, i, k))
            cols_e.append(rowcol(b.egen, C, i, k))
            acc = absC[..., i, 0] * b.rad[..., 0, k] + absR[..., i, 0] * Tb[..., 0, k]
            for j in range(1, m):
                acc = acc + (absC[..., i, j] * b.rad[..., j, k]
                             + absR[..., i, j] * Tb[..., j, k])
            cols_r.append(acc)
        rows_c.append(torch.stack(cols_c, dim=-2))
        rows_e.append(torch.stack(cols_e, dim=-2))
        rows_r.append(torch.stack(cols_r, dim=-1))
    coef = torch.stack(rows_c, dim=-3)
    egen = torch.stack(rows_e, dim=-3)
    rad = torch.stack(rows_r, dim=-2)
    if slop:
        rad = rad + slop * (torch.sum(torch.abs(coef), dim=-1)
                            + torch.sum(torch.abs(egen), dim=-1) + rad)
    return BPZ(coef=coef, egen=egen, rad=rad)


def _cross_pair(x, y):
    # x, y: [..., 3, t]
    return torch.stack([
        x[..., 1, :] * y[..., 2, :] - x[..., 2, :] * y[..., 1, :],
        x[..., 2, :] * y[..., 0, :] - x[..., 0, :] * y[..., 2, :],
        x[..., 0, :] * y[..., 1, :] - x[..., 1, :] * y[..., 0, :],
    ], dim=-2)


def _cross_abs(x, y):
    return torch.stack([
        x[..., 1] * y[..., 2] + x[..., 2] * y[..., 1],
        x[..., 2] * y[..., 0] + x[..., 0] * y[..., 2],
        x[..., 0] * y[..., 1] + x[..., 1] * y[..., 0],
    ], dim=-1)


def _cross_abs_t(x, y):
    return torch.stack([
        x[..., 1, :] * y[..., 2, :] + x[..., 2, :] * y[..., 1, :],
        x[..., 2, :] * y[..., 0, :] + x[..., 0, :] * y[..., 2, :],
        x[..., 0, :] * y[..., 1, :] + x[..., 1, :] * y[..., 0, :],
    ], dim=-2)


def cross_plain(a: BPZ, b: BPZ, basis: KBasis, slop: float = 0.0) -> BPZ:
    """Plain version of kernel K2: the PZ x PZ 3-vector cross product
    through the pair table (armour_tpu/pz/bpz.py:120-167,481-484)."""
    return bilinear(a, b, _cross_pair, _cross_abs, basis, slop,
                    absprod_t=_cross_abs_t)


def cross(a: BPZ, b: BPZ, basis: KBasis, slop: float = 0.0) -> BPZ:
    """3-vector cross product.  Kernel K2 on CUDA tensors, cross_plain on
    CPU tensors."""
    if not a.coef.is_cuda:
        return cross_plain(a, b, basis, slop)
    from ..kernels import pz as kpz

    return kpz.cross(a, b, basis, slop)


def cross_const(m: torch.Tensor, b: BPZ) -> BPZ:
    """cross(constant vector, PZ vector): exact."""
    def cr(x, y):
        return torch.stack([
            x[..., 1, None] * y[..., 2, :] - x[..., 2, None] * y[..., 1, :],
            x[..., 2, None] * y[..., 0, :] - x[..., 0, None] * y[..., 2, :],
            x[..., 0, None] * y[..., 1, :] - x[..., 1, None] * y[..., 0, :],
        ], dim=-2)

    return BPZ(coef=cr(m, b.coef), egen=cr(m, b.egen),
               rad=_cross_abs(torch.abs(m), b.rad))


def matvec_cvec(a: BPZ, v: torch.Tensor) -> BPZ:
    """PZ matrix [..., n, m, :] times exact constant vector [..., m]."""
    return BPZ(coef=torch.einsum("...ijt,...j->...it", a.coef, v),
               egen=torch.einsum("...ijt,...j->...it", a.egen, v),
               rad=torch.einsum("...ij,...j->...i", a.rad, torch.abs(v)))


def cross_pz_const(a: BPZ, v: torch.Tensor) -> BPZ:
    """cross(PZ vector, constant vector): exact."""
    def cr(x):
        return torch.stack([
            x[..., 1, :] * v[..., 2, None] - x[..., 2, :] * v[..., 1, None],
            x[..., 2, :] * v[..., 0, None] - x[..., 0, :] * v[..., 2, None],
            x[..., 0, :] * v[..., 1, None] - x[..., 1, :] * v[..., 0, None],
        ], dim=-2)

    return BPZ(coef=cr(a.coef), egen=cr(a.egen), rad=_cross_abs(a.rad, torch.abs(v)))


def stack(pzs, *, dim: int = -1) -> BPZ:
    """Stack PZs along a new value axis (dim counts over the value axes,
    -1 = trailing)."""
    return BPZ(coef=torch.stack([p.coef for p in pzs], dim=dim - 1),
               egen=torch.stack([p.egen for p in pzs], dim=dim - 1),
               rad=torch.stack([p.rad for p in pzs], dim=dim))


def reduce_(a: BPZ) -> BPZ:
    """Move every error generator into the independent radius."""
    return BPZ(coef=a.coef, egen=torch.zeros_like(a.egen),
               rad=a.rad + torch.sum(torch.abs(a.egen), dim=-1))


def to_interval(a: BPZ):
    """(center, radius) interval hull."""
    radius = (torch.sum(torch.abs(a.coef[..., 1:]), dim=-1)
              + torch.sum(torch.abs(a.egen), dim=-1) + a.rad)
    return a.coef[..., 0], radius

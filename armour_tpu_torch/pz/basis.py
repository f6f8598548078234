"""Static monomial basis over the trajectory parameters k (counterpart of
armour_tpu/pz/basis.py).

The tables (degree vectors, the product pair table, the degree<=1
shift-gather table) are numpy, built once per (nf, max_degree).  phi/dphi
evaluate the monomials in torch on k's device; the integer tables they need
are copied to that device once and kept on the basis.  kernel_args keeps
each kernel's copy of the tables it reads from its parameters: K1's
shift-gather table, K2's pair segments, and the [B, nf] degree table from
which K7 and K8 form phi(k) and dphi/dk in shared memory (degree_table()).
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass(frozen=True)
class KBasis:
    nf: int                       # number of trajectory factors (joints)
    max_degree: int               # total-degree cap
    degs: np.ndarray              # [B, nf] degree vectors; index 0 = constant
    index: dict = field(repr=False)   # tuple(deg) -> basis index
    pair_i: np.ndarray            # [P] product pair table
    pair_j: np.ndarray            # [P]
    pair_m: np.ndarray            # [P]
    _dev: dict = field(default_factory=dict, repr=False, compare=False)
    kernel_args: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def size(self) -> int:
        return self.degs.shape[0]

    @property
    def lin_idx(self) -> np.ndarray:
        """Basis index of the linear monomial k_i, for each factor i."""
        eye = np.eye(self.nf, dtype=np.int64)
        return np.array([self.index[tuple(row)] for row in eye])

    def degree_table(self) -> np.ndarray:
        """The degree vectors as uint8 [B, nf]: monomial b is
        prod_i k_i ** degs[b, i]."""
        return self.degs.astype(np.uint8)

    def device_tables(self, device) -> dict:
        """Integer tables on `device`, copied once per device."""
        key = str(device)
        if key not in self._dev:
            degs = torch.as_tensor(self.degs, dtype=torch.int64)
            self._dev[key] = {
                "degs": degs.to(device),
                "dm1": (degs - 1).clamp(min=0).to(device),
                "fidx": torch.arange(self.nf).to(device),
                "pair_i": torch.as_tensor(self.pair_i, dtype=torch.int64).to(device),
                "pair_j": torch.as_tensor(self.pair_j, dtype=torch.int64).to(device),
                "pair_m": torch.as_tensor(self.pair_m, dtype=torch.int64).to(device),
                "lin": torch.as_tensor(self.lin_idx, dtype=torch.int64).to(device),
            }
        return self._dev[key]

    def _pows(self, k):
        maxd = int(self.degs.max())
        pows = [torch.ones_like(k)]
        for _ in range(maxd):
            pows.append(pows[-1] * k)
        return torch.stack(pows, dim=-1)                  # [..., nf, D]

    def phi(self, k: torch.Tensor) -> torch.Tensor:
        """All basis monomials at k: [..., nf] -> [..., B]."""
        tab = self.device_tables(k.device)
        take = self._pows(k)[..., tab["fidx"], tab["degs"]]   # [..., B, nf]
        return torch.prod(take, dim=-1)

    def dphi(self, k: torch.Tensor) -> torch.Tensor:
        """Jacobian of phi: [..., nf] -> [..., B, nf]."""
        tab = self.device_tables(k.device)
        pows = self._pows(k)
        take = pows[..., tab["fidx"], tab["degs"]]           # k_i^{d_mi}
        take_dm1 = pows[..., tab["fidx"], tab["dm1"]]        # k_i^{d_mi - 1}
        dcol = tab["degs"].to(k.dtype) * take_dm1
        out = []
        for j in range(self.nf):
            others = torch.prod(
                torch.cat([take[..., :, :j], take[..., :, j + 1:]], dim=-1), dim=-1)
            out.append(dcol[..., j] * others)
        return torch.stack(out, dim=-1)


@functools.lru_cache(maxsize=8)
def make_basis(nf: int = 7, max_degree: int = 3) -> KBasis:
    degs = []
    for total in range(max_degree + 1):
        for c in itertools.combinations_with_replacement(range(nf), total):
            d = [0] * nf
            for i in c:
                d[i] += 1
            degs.append(tuple(d))
    degs = sorted(set(degs), key=lambda d: (sum(d), d))
    index = {d: m for m, d in enumerate(degs)}
    degs_arr = np.array(degs, dtype=np.int64)

    pi, pj, pm = [], [], []
    for i, di in enumerate(degs):
        for j, dj in enumerate(degs):
            s = tuple(a + b for a, b in zip(di, dj))
            if sum(s) <= max_degree:
                pi.append(i)
                pj.append(j)
                pm.append(index[s])
    return KBasis(
        nf=nf, max_degree=max_degree, degs=degs_arr, index=index,
        pair_i=np.array(pi, dtype=np.int32), pair_j=np.array(pj, dtype=np.int32),
        pair_m=np.array(pm, dtype=np.int32),
    )


def error_layout(nf: int = 7):
    """Slot layout of the linear error-generator block (size 5*nf + 3):
    qde, qdae, qddae, cosqe, sinqe (nf each) and 3 link-shape slots."""
    return {
        "qde": slice(0 * nf, 1 * nf),
        "qdae": slice(1 * nf, 2 * nf),
        "qddae": slice(2 * nf, 3 * nf),
        "cosqe": slice(3 * nf, 4 * nf),
        "sinqe": slice(4 * nf, 5 * nf),
        "shape": slice(5 * nf, 5 * nf + 3),
        "size": 5 * nf + 3,
    }


@functools.lru_cache(maxsize=8)
def linear_tables(nf: int = 7, max_degree: int = 3):
    """Tables for products with a degree<=1 operand:
      src[i, m]: basis index s with mono(m) = k_i * mono(s), or B (the zero
                 sentinel) when degs[m][i] == 0;
      ovf[m]:    True when k_i * mono(m) leaves the basis for every i."""
    basis = make_basis(nf, max_degree)
    B = basis.size
    src = np.full((nf, B), B, dtype=np.int32)
    for m, d in enumerate(map(tuple, basis.degs)):
        for i in range(nf):
            if d[i] >= 1:
                d2 = list(d)
                d2[i] -= 1
                src[i, m] = basis.index[tuple(d2)]
    ovf = (basis.degs.sum(axis=1) == max_degree)
    return src, ovf


@functools.lru_cache(maxsize=8)
def pair_segments(nf: int = 7, max_degree: int = 3):
    """The pair table sorted by output monomial, as segments: pairs
    order[seg[m]:seg[m+1]] all land on monomial m.  A product kernel sums
    each segment in one thread, in this fixed order, without atomics."""
    basis = make_basis(nf, max_degree)
    order = np.argsort(basis.pair_m, kind="stable")
    counts = np.bincount(basis.pair_m, minlength=basis.size)
    seg = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return basis.pair_i[order], basis.pair_j[order], seg

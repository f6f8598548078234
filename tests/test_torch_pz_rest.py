"""The rest of the port's pz/ against the JAX package, float64 on the CPU:
the interval functions make / neg / square and the BPZ ops add_const,
matmul, matvec, matvec_const, axis_embed and slice_at on seeded random
inputs within 1e-12, and slice_at / matmul against the port's own sparse
oracle (as tests/test_bpz.py holds the JAX ones against the JAX oracle)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu.pz import basis as jbasis_mod
from armour_tpu.pz import bpz as jbpz
from armour_tpu.pz import interval as jiv
from armour_tpu_torch.pz import basis as tbasis_mod
from armour_tpu_torch.pz import bpz as tbpz
from armour_tpu_torch.pz import interval as tiv
from armour_tpu_torch.pz.oracle import SparsePZ

NF = 7
JB = jbasis_mod.make_basis(NF, 3)
TB = tbasis_mod.make_basis(NF, 3)
B = TB.size
LAY = tbasis_mod.error_layout(NF)
E = LAY["size"]
TOL = 1e-12
SLOP = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small: one torch thread each, so that the
    six workers of a full run do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(t, j):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)


def close_bpz(tp, jp):
    close(tp.coef, jp.coef)
    close(tp.egen, jp.egen)
    close(tp.rad, jp.rad)


def rand_fields(rng, shape):
    return (rng.normal(size=(*shape, B)), 0.1 * rng.normal(size=(*shape, E)),
            0.05 * np.abs(rng.normal(size=shape)))


def both(fields):
    coef, egen, rad = fields
    return (jbpz.BPZ(coef=jnp.asarray(coef), egen=jnp.asarray(egen), rad=jnp.asarray(rad)),
            tbpz.BPZ(coef=torch.as_tensor(coef), egen=torch.as_tensor(egen),
                     rad=torch.as_tensor(rad)))


@pytest.mark.parametrize("op", ["make", "neg", "square"])
def test_interval_ops_match_jax(op):
    rng = np.random.default_rng(1)
    lo = rng.normal(size=64)
    hi = lo + np.abs(rng.normal(size=64))
    hi[:8] = -np.abs(hi[:8]) - 0.1       # wholly negative
    lo[8:16] = np.abs(lo[8:16])          # wholly positive
    hi[8:16] = lo[8:16] + 0.3
    j, t = (jnp.asarray(lo), jnp.asarray(hi)), (torch.as_tensor(lo), torch.as_tensor(hi))
    if op == "make":
        got, want = tiv.make(lo, hi), jiv.make(lo, hi)
    else:
        got, want = getattr(tiv, op)(t), getattr(jiv, op)(j)
    for g, w in zip(got, want):
        close(g, w)


def _bpz_case(op, rng):
    if op == "add_const":
        ja, ta = both(rand_fields(rng, (4, 3)))
        x = rng.normal(size=(4, 3))
        return tbpz.add_const(ta, torch.as_tensor(x)), jbpz.add_const(ja, jnp.asarray(x))
    if op == "matmul":
        (ja, ta), (jb, tb) = both(rand_fields(rng, (4, 3, 3))), both(rand_fields(rng, (4, 3, 2)))
        return tbpz.matmul(ta, tb, TB, SLOP), jbpz.matmul(ja, jb, JB, SLOP)
    if op == "matvec":
        (ja, ta), (jv, tv) = both(rand_fields(rng, (4, 3, 3))), both(rand_fields(rng, (4, 3)))
        return tbpz.matvec(ta, tv, TB, SLOP), jbpz.matvec(ja, jv, JB, SLOP)
    if op == "matvec_const":
        jb, tb = both(rand_fields(rng, (4, 3)))
        m = rng.normal(size=(4, 3, 3))
        return tbpz.matvec_const(torch.as_tensor(m), tb), jbpz.matvec_const(jnp.asarray(m), jb)
    if op == "axis_embed":
        ja, ta = both(rand_fields(rng, (4,)))
        return tbpz.axis_embed(ta, 1), jbpz.axis_embed(ja, 1)
    raise ValueError(op)


@pytest.mark.parametrize("op", ["add_const", "matmul", "matvec", "matvec_const", "axis_embed"])
def test_bpz_op_matches_jax(op):
    got, want = _bpz_case(op, np.random.default_rng(2))
    close_bpz(got, want)


def test_slice_at_matches_jax():
    rng = np.random.default_rng(3)
    ja, ta = both(rand_fields(rng, (5, 3)))
    k = rng.uniform(-1, 1, NF)
    c, r = tbpz.slice_at(ta, TB.phi(torch.as_tensor(k)))
    jc, jr = jbpz.slice_at(ja, JB.phi(jnp.asarray(k)))
    close(c, jc)
    close(r, jr)


def _random_pair(rng):
    """A random scalar PZ in both the dense and the sparse representation
    (tests/test_bpz.py:random_pair)."""
    center = rng.normal()
    terms = []
    coef = np.zeros(B)
    coef[0] = center
    for _ in range(4):
        m = int(rng.integers(1, B))
        c = rng.normal()
        coef[m] += c
        terms.append((c, {("k", i): int(d) for i, d in enumerate(TB.degs[m]) if d}))
    egen = np.zeros(E)
    for group in ("qde", "cosqe", "sinqe"):
        i = int(rng.integers(0, NF))
        c = rng.normal() * 0.1
        egen[LAY[group].start + i] += c
        terms.append((c, {(group, i): 1}))
    rad = abs(rng.normal() * 0.05)
    dense = tbpz.BPZ(coef=torch.as_tensor(coef), egen=torch.as_tensor(egen),
                     rad=torch.as_tensor(rad))
    return dense, SparsePZ.from_terms(np.array(center), terms, np.array(rad))


def test_slice_matches_the_ports_oracle():
    """tests/test_bpz.py:105 with the port's BPZ and oracle."""
    rng = np.random.default_rng(0)
    for _ in range(5):
        a_d, a_s = _random_pair(rng)
        kvec = rng.uniform(-1, 1, NF)
        c, r = tbpz.slice_at(a_d, TB.phi(torch.as_tensor(kvec)))
        c_ref, r_ref = a_s.slice_at(kvec)
        np.testing.assert_allclose(float(c), float(c_ref), atol=1e-10)
        np.testing.assert_allclose(float(r), float(r_ref), atol=1e-10)


def test_matmul_matches_the_ports_oracle():
    """tests/test_bpz.py:115 with the port's BPZ and oracle: the centre
    agrees and the dense hull contains the oracle's."""
    rng = np.random.default_rng(7)

    def rand_mat():
        coef = np.zeros((3, 3, B))
        coef[..., 0] = rng.normal(size=(3, 3))
        m = int(rng.integers(1, 8))
        kmat = rng.normal(size=(3, 3))
        coef[..., m] = kmat
        egen = np.zeros((3, 3, E))
        emat = rng.normal(size=(3, 3)) * 0.01
        egen[..., LAY["cosqe"].start + 2] = emat
        rad = np.abs(rng.normal(size=(3, 3))) * 0.01
        dense = tbpz.BPZ(torch.as_tensor(coef), torch.as_tensor(egen), torch.as_tensor(rad))
        degs = {("k", i): int(d) for i, d in enumerate(TB.degs[m]) if d}
        sparse = SparsePZ.from_terms(coef[..., 0], [(kmat, degs), (emat, {("cosqe", 2): 1})],
                                     rad)
        return dense, sparse

    a_d, a_s = rand_mat()
    b_d, b_s = rand_mat()
    out = tbpz.matmul(a_d, b_d, TB)
    ref = a_s * b_s
    np.testing.assert_allclose(out.coef[..., 0].numpy(), ref.center, atol=1e-10)
    oc, orad = ref.to_interval()
    dc, drad = tbpz.to_interval(out)
    np.testing.assert_allclose(dc.numpy(), oc, atol=1e-9)
    assert np.all(drad.numpy() >= orad - 1e-9)

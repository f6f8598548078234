"""Parity of the PyTorch port's BPZ algebra (armour_tpu_torch.pz) with the
JAX package's (armour_tpu.pz), float64 on the CPU: every op of the planning
slice on random BPZs at T = 4, B = 120, within 1e-9 relative.  The CPU
branch of each kernel wrapper is its plain version, so matmul_linear(_right)
and cross here check the plain counterparts of kernels K1 and K2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu.pz import basis as jbasis_mod
from armour_tpu.pz import bpz as jbpz
from armour_tpu_torch.pz import basis as tbasis_mod
from armour_tpu_torch.pz import bpz as tbpz

NF = 7
JB = jbasis_mod.make_basis(NF, 3)
TB = tbasis_mod.make_basis(NF, 3)
B = TB.size
E = tbasis_mod.error_layout(NF)["size"]
T = 4
SLOP = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small: one torch thread each, so that the
    six workers of a full run do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rand_np(rng, shape, degree1=False):
    """Random BPZ fields; degree1 keeps k-coefficients at degree <= 1
    (rotation operands of matmul_linear)."""
    coef = rng.normal(size=(*shape, B))
    if degree1:
        keep = np.zeros(B, bool)
        keep[0] = True
        keep[TB.lin_idx] = True
        coef = coef * keep
    egen = rng.normal(size=(*shape, E)) * 0.1
    rad = np.abs(rng.normal(size=shape)) * 0.05
    return coef, egen, rad


def both(fields):
    coef, egen, rad = fields
    return (jbpz.BPZ(coef=jnp.asarray(coef), egen=jnp.asarray(egen), rad=jnp.asarray(rad)),
            tbpz.BPZ(coef=torch.as_tensor(coef), egen=torch.as_tensor(egen),
                     rad=torch.as_tensor(rad)))


def assert_close(t, j, rtol=1e-9):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    scale = max(1.0, float(np.max(np.abs(j)))) if j.size else 1.0
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * 1e-3 * scale)


def assert_bpz(tp, jp):
    assert_close(tp.coef, jp.coef)
    assert_close(tp.egen, jp.egen)
    assert_close(tp.rad, jp.rad)


def _case(op, rng):
    """(torch result, jax result) of one op on shared random inputs."""
    if op == "add":
        (ja, ta), (jb, tb) = both(rand_np(rng, (T, 3))), both(rand_np(rng, (T, 3)))
        return tbpz.add(ta, tb), jbpz.add(ja, jb)
    if op == "sub":
        (ja, ta), (jb, tb) = both(rand_np(rng, (T, 3))), both(rand_np(rng, (T, 3)))
        return tbpz.sub(ta, tb), jbpz.sub(ja, jb)
    if op == "scale_scalar":
        ja, ta = both(rand_np(rng, (T,)))
        return tbpz.scale(ta, -0.7), jbpz.scale(ja, -0.7)
    if op == "mul_interval":
        jm, tm = both(rand_np(rng, (2,)))
        jc, jr = jbpz.interval_operand(jm)
        tc, tr = tbpz.interval_operand(tm)
        jb, tb = both(rand_np(rng, (T, 3)))
        return (tbpz.mul_interval(tc[:, None, None], tr[:, None, None], tb, SLOP),
                jbpz.mul_interval(jc[:, None, None], jr[:, None, None], jb, SLOP))
    if op == "matmul_linear":
        (ja, ta), (jb, tb) = both(rand_np(rng, (T, 3, 3), True)), both(rand_np(rng, (T, 3, 4)))
        return tbpz.matmul_linear(ta, tb, TB, SLOP), jbpz.matmul_linear(ja, jb, JB, SLOP)
    if op == "matmul_linear_pbcast":
        # rotation [T, 3, 3] against a parameter-set stack [P, T, 3, 2]
        (ja, ta), (jb, tb) = both(rand_np(rng, (T, 3, 3), True)), both(rand_np(rng, (2, T, 3, 2)))
        return tbpz.matmul_linear(ta, tb, TB, SLOP), jbpz.matmul_linear(ja, jb, JB, SLOP)
    if op == "matmul_linear_right":
        (ja, ta), (jb, tb) = both(rand_np(rng, (T, 3, 3))), both(rand_np(rng, (T, 3, 3), True))
        return (tbpz.matmul_linear_right(ta, tb, TB, SLOP),
                jbpz.matmul_linear_right(ja, jb, JB, SLOP))
    if op == "matmul_linear_noslop":
        (ja, ta), (jb, tb) = both(rand_np(rng, (T, 3, 3), True)), both(rand_np(rng, (T, 3, 3)))
        return tbpz.matmul_linear(ta, tb, TB), jbpz.matmul_linear(ja, jb, JB)
    if op == "matvec_const_coef":
        ja, ta = both(rand_np(rng, (T, 3, 3)))
        coef, egen, rad = rand_np(rng, (3,))
        coef[..., 1:] = 0.0
        jb, tb = both((coef, egen, rad))
        return (tbpz.matvec_const_coef(ta, tb, SLOP), jbpz.matvec_const_coef(ja, jb, SLOP))
    if op == "matmul_interval":
        C, R = rng.normal(size=(2, 1, 3, 3)), np.abs(rng.normal(size=(2, 1, 3, 3))) * 0.03
        jb, tb = both(rand_np(rng, (T, 3, 2)))
        return (tbpz.matmul_interval(torch.as_tensor(C), torch.as_tensor(R), tb, SLOP),
                jbpz.matmul_interval(jnp.asarray(C), jnp.asarray(R), jb, SLOP))
    if op == "cross":
        (ja, ta), (jb, tb) = both(rand_np(rng, (T, 3))), both(rand_np(rng, (T, 3)))
        return tbpz.cross(ta, tb, TB, SLOP), jbpz.cross(ja, jb, JB, SLOP)
    if op == "cross_pbcast":
        # kinematics [T, 3] against a parameter-set stack [P, T, 3]
        (ja, ta), (jb, tb) = both(rand_np(rng, (T, 3))), both(rand_np(rng, (2, T, 3)))
        return tbpz.cross(ta, tb, TB, SLOP), jbpz.cross(ja, jb, JB, SLOP)
    if op == "cross_noslop":
        (ja, ta), (jb, tb) = both(rand_np(rng, (2, T, 3))), both(rand_np(rng, (T, 3)))
        return tbpz.cross(ta, tb, TB), jbpz.cross(ja, jb, JB)
    if op == "cross_const":
        m = rng.normal(size=(3,))
        jb, tb = both(rand_np(rng, (T, 3)))
        return tbpz.cross_const(torch.as_tensor(m), tb), jbpz.cross_const(jnp.asarray(m), jb)
    if op == "cross_pz_const":
        v = rng.normal(size=(3,))
        ja, ta = both(rand_np(rng, (T, 3)))
        return tbpz.cross_pz_const(ta, torch.as_tensor(v)), jbpz.cross_pz_const(ja, jnp.asarray(v))
    if op == "matvec_cvec":
        v = rng.normal(size=(3,))
        ja, ta = both(rand_np(rng, (T, 3, 3)))
        return tbpz.matvec_cvec(ta, torch.as_tensor(v)), jbpz.matvec_cvec(ja, jnp.asarray(v))
    if op == "reduce":
        ja, ta = both(rand_np(rng, (T, 3)))
        return tbpz.reduce_(ta), jbpz.reduce_(ja)
    raise ValueError(op)


OPS = ["add", "sub", "scale_scalar", "mul_interval", "matmul_linear",
       "matmul_linear_pbcast", "matmul_linear_right", "matmul_linear_noslop",
       "matvec_const_coef", "matmul_interval", "cross", "cross_pbcast",
       "cross_noslop", "cross_const", "cross_pz_const", "matvec_cvec", "reduce"]


@pytest.mark.parametrize("op", OPS)
def test_op_matches_jax(op):
    rng = np.random.default_rng(OPS.index(op))
    tp, jp = _case(op, rng)
    assert_bpz(tp, jp)


def test_to_interval():
    rng = np.random.default_rng(100)
    ja, ta = both(rand_np(rng, (T, 3)))
    tc, tr = tbpz.to_interval(ta)
    jc, jr = jbpz.to_interval(ja)
    assert_close(tc, jc)
    assert_close(tr, jr)


def test_interval_operand():
    rng = np.random.default_rng(101)
    ja, ta = both(rand_np(rng, (2, 3)))
    for t, j in zip(tbpz.interval_operand(ta), jbpz.interval_operand(ja)):
        assert_close(t, j)


@pytest.mark.parametrize("batch", [(), (5,), (2, 3)])
def test_phi_dphi_match_jax(batch):
    rng = np.random.default_rng(7 + len(batch))
    k = rng.uniform(-1, 1, (*batch, NF))
    # the JAX basis evaluates one k (the JAX package vmaps it)
    kj = jnp.asarray(k.reshape(-1, NF))
    phi_j = np.asarray(jax.vmap(JB.phi)(kj)).reshape(*batch, B)
    dphi_j = np.asarray(jax.vmap(JB.dphi)(kj)).reshape(*batch, B, NF)
    assert_close(TB.phi(torch.as_tensor(k)), phi_j)
    assert_close(TB.dphi(torch.as_tensor(k)), dphi_j)


def test_basis_tables_match_jax():
    assert np.array_equal(TB.degs, JB.degs)
    assert np.array_equal(TB.pair_i, JB.pair_i)
    assert np.array_equal(TB.pair_j, JB.pair_j)
    assert np.array_equal(TB.pair_m, JB.pair_m)
    assert np.array_equal(TB.lin_idx, JB.lin_idx)
    src_t, ovf_t = tbasis_mod.linear_tables(NF, 3)
    src_j, ovf_j = jbasis_mod.linear_tables(NF, 3)
    assert np.array_equal(src_t, src_j) and np.array_equal(ovf_t, ovf_j)


def test_pair_segments_cover_the_pair_table():
    """The kernel's segment table is a permutation of the pair table grouped
    by output monomial."""
    pi, pj, seg = tbasis_mod.pair_segments(NF, 3)
    assert seg[0] == 0 and seg[-1] == len(TB.pair_i) and np.all(np.diff(seg) >= 1)
    got = set()
    for m in range(B):
        for q in range(seg[m], seg[m + 1]):
            got.add((int(pi[q]), int(pj[q]), m))
    want = set(zip(TB.pair_i.tolist(), TB.pair_j.tolist(), TB.pair_m.tolist()))
    assert got == want

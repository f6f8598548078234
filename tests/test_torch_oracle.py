"""The port's sparse oracle (armour_tpu_torch/pz/oracle.py,
oracle_pipeline.py) against the JAX package's, and the port's dense
reach sets against it, float64 on the CPU.

SparsePZ's ops give the JAX oracle's numbers exactly (the same numpy code on
the same inputs).  The port's FK at T = 16 matches oracle_fk as
tests/test_pipeline_reachsets.py:81 holds the JAX FK (k-coefficients to
1e-11, radii conservative and within 5% + 1e-3), and its nominal RNEA
matches oracle_rnea at threshold 1e-5 as :186 does (sliced centres within
1e-4, radii at most 1.2x the oracle's + 1e-6; slow, the sparse RNEA takes
10-24 s)."""

import numpy as np
import pytest
import torch

from armour_tpu.pz.oracle import SparsePZ as JSparsePZ
from armour_tpu_torch import dynamics, kinematics
from armour_tpu_torch.config import ArmourConfig
from armour_tpu_torch.jrs import build_jrs
from armour_tpu_torch.models.kinova import kinova_gen3
from armour_tpu_torch.pz import basis as basis_mod
from armour_tpu_torch.pz import bpz
from armour_tpu_torch.pz.oracle import SparsePZ
from armour_tpu_torch.pz.oracle_pipeline import jrs_to_oracle, oracle_fk, oracle_rnea

ROBOT = kinova_gen3()
CFG = ArmourConfig(num_time_steps=16, dtype=torch.float64)
BASIS = basis_mod.make_basis(7, 3)

Q0 = np.array([0.6543, -0.0876, -0.4837, -1.2278, -1.5735, -1.0720, 0.0])
QD0 = np.array([0.1, -0.2, 0.15, 0.3, -0.1, 0.05, 0.2])
QDD0 = np.array([0.3, 0.1, -0.2, 0.1, 0.2, -0.1, 0.0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small: one torch thread each, so that the
    six workers of a full run do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _terms(rng, shape, groups=("k", "qde", "cosqe")):
    return [(rng.normal(size=shape), {(g, int(rng.integers(0, 7))): int(rng.integers(1, 3))})
            for g in groups]


def _pair(rng, shape):
    """The same random sparse PZ in both packages' classes."""
    center = rng.normal(size=shape)
    terms = _terms(rng, shape) + [(rng.normal(size=shape), {("shape", 1): 1})]
    indep = np.abs(rng.normal(size=shape)) * 0.05
    return (SparsePZ.from_terms(center, terms, indep),
            JSparsePZ.from_terms(center, terms, indep))


def _same(t, j):
    np.testing.assert_array_equal(np.asarray(t.center), np.asarray(j.center))
    np.testing.assert_array_equal(np.asarray(t.indep), np.asarray(j.indep))
    assert list(t.poly) == list(j.poly)
    for key in t.poly:
        np.testing.assert_array_equal(np.asarray(t.poly[key]), np.asarray(j.poly[key]))


OPS = {
    "add": lambda a, b: a + b,
    "add_const": lambda a, b: a + 0.25,
    "neg": lambda a, b: -a,
    "sub": lambda a, b: a - b,
    "scale": lambda a, b: a.scale(-1.5),
    "mul_matrix": lambda a, b: a * b,
    "matvec": lambda a, b: a.matvec(b),
    "transpose": lambda a, b: a.transpose(),
    "simplify": lambda a, b: (a * b).simplify(0.5),
    "reduce": lambda a, b: (a * b).reduce(),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_sparse_ops_match_jax_oracle(op):
    rng = np.random.default_rng(4)
    (ta, ja), (tb, jb) = _pair(rng, (3, 3)), _pair(rng, (3, 3) if op != "matvec" else (3,))
    _same(OPS[op](ta, tb), OPS[op](ja, jb))


def test_sparse_vector_ops_match_jax_oracle():
    """cross, the scalar product, reduce_link_pz, slice_at, to_interval,
    k_poly and sample on 3-vectors."""
    rng = np.random.default_rng(5)
    (ta, ja), (tb, jb) = _pair(rng, (3,)), _pair(rng, (3,))
    _same(ta.cross(tb), ja.cross(jb))
    (ts, js) = _pair(rng, ())
    _same(ts * ta, js * ja)
    tl, jl = ta.copy(), ja.copy()
    np.testing.assert_array_equal(tl.reduce_link_pz(), jl.reduce_link_pz())
    _same(tl, jl)
    k = rng.uniform(-1, 1, 7)
    for got, want in zip(ta.slice_at(k), ja.slice_at(k)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(ta.to_interval(), ja.to_interval()):
        np.testing.assert_array_equal(got, want)
    assert list(ta.k_poly()) == list(ja.k_poly())
    np.testing.assert_array_equal(ta.sample(np.random.default_rng(9), k),
                                  ja.sample(np.random.default_rng(9), k))


@pytest.fixture(scope="module")
def jrs():
    args = [torch.as_tensor(x)[None] for x in (Q0, QD0, QDD0)]
    return build_jrs(*args, ROBOT, CFG, BASIS)


def test_fk_matches_oracle(jrs):
    links = kinematics.forward_occupancy(jrs, ROBOT, CFG, BASIS)
    for t in (0, CFG.num_time_steps // 2, CFG.num_time_steps - 1):
        olinks = oracle_fk(jrs_to_oracle(jrs, ROBOT, BASIS, t), ROBOT, threshold=0.0)
        for i in (0, 3, 6):
            ref = olinks[i]
            got_coef = links.coef[0, t, i].numpy()
            ref_coef = np.zeros_like(got_coef)
            ref_coef[:, 0] = ref.center
            for key, v in ref.k_poly().items():
                d = [0] * 7
                for (g, j), e in key:
                    d[j] = e
                if sum(d) <= 3:
                    ref_coef[:, BASIS.index[tuple(d)]] += v
            np.testing.assert_allclose(got_coef, ref_coef, atol=1e-11)
            _, orad = ref.to_interval()
            _, drad = bpz.to_interval(bpz.BPZ(links.coef[0, t, i], links.egen[0, t, i],
                                              links.rad[0, t, i]))
            assert np.all(drad.numpy() >= orad - 1e-11)
            assert np.all(drad.numpy() <= orad * 1.05 + 1e-3), (drad, orad)


@pytest.mark.slow
def test_rnea_close_to_faithful_oracle(jrs):
    """Slow: the sparse oracle's RNEA at threshold 1e-5 takes ~10 s of
    numpy on one idle CPU core and ~24 s beside a parallel test run."""
    t = CFG.num_time_steps // 2
    otau = oracle_rnea(jrs_to_oracle(jrs, ROBOT, BASIS, t), ROBOT, uncertain=False,
                       threshold=1e-5)
    u_nom = dynamics.rnea_pz(jrs, ROBOT, CFG, BASIS, uncertain=False)
    rng = np.random.default_rng(6)
    for _ in range(5):
        k = rng.uniform(-1, 1, 7)
        phi = BASIS.phi(torch.as_tensor(k))
        for i in range(7):
            oc, orad = otau[i].slice_at(k)
            dc, drad = bpz.slice_at(bpz.BPZ(u_nom.coef[0, t, i], u_nom.egen[0, t, i],
                                            u_nom.rad[0, t, i]), phi)
            assert abs(float(dc) - float(oc)) <= 1e-4, (i, float(dc), float(oc))
            assert float(drad) <= 1.2 * float(orad) + 1e-6, (i, float(drad), float(orad))


def test_jrs_to_oracle_reads_any_world_and_dtype(jrs):
    """A batch of two worlds in float32: world 1's oracle is built from
    world 1's tensors, copied to float64."""
    two = [torch.as_tensor(np.stack([x, -x]), dtype=torch.float32) for x in (Q0, QD0, QDD0)]
    j2 = build_jrs(*two, ROBOT, ArmourConfig(num_time_steps=16, dtype=torch.float32), BASIS)
    oj = jrs_to_oracle(j2, ROBOT, BASIS, 3, world=1)
    assert oj["R"][2].center.dtype == np.float64
    np.testing.assert_array_equal(oj["R"][2].center, j2.R.coef[1, 3, 2, :, :, 0].double().numpy())
    np.testing.assert_array_equal(oj["qd"][4].center, j2.qd.coef[1, 3, 4, 0].double().numpy())

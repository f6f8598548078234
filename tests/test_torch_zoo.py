"""The robot zoo in the PyTorch port on the CPU (float64): the models, the
numeric RNEA, the certified mass-matrix bounds and the per-robot ultimate
bound.

Against the JAX package: every zoo robot's fields (equal), its gravity
torque; interval_link_mass_matrix, certified_m_min / certified_m_max
(1e-9; the branch and bound at a small box budget for the Panda, whose
m_min no armature certifies); mass_eigenvalue_bracket and
derive_ultimate_bound, cached for every robot and at v_max = 5e-4 for the
dumbbell (relative 1e-9).  Then the port's versions of the non-mesh tests of
tests/test_robot_zoo.py, with test_zoo_plan_step_runs as a reduced plain
planning step of every zoo robot."""

import dataclasses
import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu import certify as j_certify, rnea_numeric as j_rn
from armour_tpu.config import derive_ultimate_bound as j_derive_ub
from armour_tpu.models import zoo as j_zoo
from armour_tpu_torch import certify, convert, rnea_numeric
from armour_tpu_torch.collision import pad_obstacles
from armour_tpu_torch.config import ArmourConfig, derive_ultimate_bound
from armour_tpu_torch.models import zoo
from armour_tpu_torch.models.kinova import kinova_gen3
from armour_tpu_torch.planner import make_planner

ALL = zoo.list_robots()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small: one torch thread each, so that the
    six workers of a full run do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lim(r):
    return np.maximum(r.position_limits_lb, -np.pi), np.minimum(r.position_limits_ub, np.pi)


def test_zoo_lists_reference_robots():
    assert ALL == j_zoo.list_robots()
    for name in ["fetch_arm", "kuka_iiwa", "panda", "ur5", "kinova_urdf", "kinova_dumbbell"]:
        assert name in ALL


@pytest.mark.parametrize("name", ALL)
def test_zoo_models_match_jax(name):
    """Every field equal to the JAX package's model (this package reads its
    own copy of zoo_data.json), and the shapes of tests/test_robot_zoo.py."""
    r, jr = zoo.load_zoo_robot(name), j_zoo.load_zoo_robot(name)
    for f in dataclasses.fields(jr):
        a, b = getattr(r, f.name), getattr(jr, f.name)
        assert np.array_equal(np.asarray(a), np.asarray(b)), f.name
    assert convert.robot_from_fields({f.name: getattr(jr, f.name)
                                      for f in dataclasses.fields(jr)}).name == name
    J, F = r.num_joints, r.num_factors
    assert r.axes.shape == (J,) and r.trans.shape == (J + 1, 3)
    assert r.mass.shape == (J,) and r.inertia.shape == (J, 3, 3)
    assert r.torque_limits.shape == (F,)
    assert np.all(r.mass >= 0)
    assert np.all(r.axes[F:] == 0), "fixed joints must trail"
    assert np.allclose(r.inertia, np.swapaxes(r.inertia, 1, 2))


@pytest.mark.parametrize("name", ALL)
def test_zoo_gravity_torque_finite(name):
    """The numeric RNEA at rest: finite gravity torques of a sane magnitude,
    the JAX package's to 1e-9."""
    r = zoo.load_zoo_robot(name)
    q = torch.zeros(r.num_joints, dtype=torch.float64)
    tau = rnea_numeric.rnea(r, q, q, q, q)
    assert bool(torch.isfinite(tau).all())
    assert float(tau.abs().max()) < 5e3
    jq = jnp.zeros(r.num_joints, jnp.float64)
    want = np.asarray(j_rn.rnea(j_zoo.load_zoo_robot(name), jq, jq, jq, jq))
    np.testing.assert_allclose(tau.numpy(), want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", ALL)
def test_zoo_mass_matrix_positive_definite(name):
    """M(q) symmetric positive definite for every zoo robot (catches sign
    errors in the axis projection: the KUKA iiwa has negative axis codes)."""
    r = zoo.load_zoo_robot(name)
    rng = np.random.default_rng(3)
    lo, hi = _lim(r)
    for _ in range(3):
        M = rnea_numeric.mass_matrix(r, torch.as_tensor(rng.uniform(lo, hi))).numpy()
        np.testing.assert_allclose(M, M.T, atol=1e-8)
        assert np.all(np.linalg.eigvalsh(M) > 0), name


def test_kuka_numeric_rnea_matches_pz_center():
    """The numeric RNEA lies in the PZ RNEA's band at the JRS centre state
    for a robot with negative axis codes."""
    from armour_tpu_torch.dynamics import rnea_pz
    from armour_tpu_torch.jrs import build_jrs
    from armour_tpu_torch.pz.basis import make_basis
    from armour_tpu_torch.trajectory import advance_plan, desired_state, initial_plan

    r = zoo.kuka_iiwa()
    assert np.any(r.axes < 0)
    F = r.num_factors
    cfg = ArmourConfig.for_robot(r, num_time_steps=4, dtype=torch.float64)
    basis = make_basis(F, cfg.max_poly_degree)
    q0 = torch.as_tensor(np.linspace(-0.3, 0.3, F))
    z = torch.zeros(F, dtype=torch.float64)
    jrs = build_jrs(q0[None], z[None], z[None], r, cfg, basis)
    u = rnea_pz(jrs, r, cfg, basis, uncertain=False)
    ref = advance_plan(initial_plan(q0, torch.float64), z, q0, z, z, cfg)
    q_d, qd_d, qdd_d = desired_state(ref, 0.5 * cfg.duration / cfg.num_time_steps, cfg)
    tau = rnea_numeric.rnea(r, q_d, qd_d, qd_d, qdd_d)
    c0 = u.coef[0, 0, :, 0]
    rad = u.rad[0, 0] + u.egen[0, 0].abs().sum(-1) + u.coef[0, 0, :, 1:].abs().sum(-1)
    assert bool(((tau - c0).abs() <= rad + 1e-6).all()), (tau, c0, rad)


def test_interval_link_mass_matrix_matches_jax_and_contains_samples():
    """The interval enclosure of M_links over boxes (a batch of three, the
    dumbbell and the flagship) equals the JAX package's and holds every
    sampled M_links(q) in its box."""
    rng = np.random.default_rng(7)
    for r, jr in ((kinova_gen3(), None), (zoo.kinova_dumbbell(), j_zoo.kinova_dumbbell())):
        qc = rng.uniform(-1.5, 1.5, (3, r.num_factors))
        for w in (0.0, 0.05, 0.3):
            qlo, qhi = qc - w, qc + w
            Mlo, Mhi = certify.interval_link_mass_matrix(r, qlo, qhi)
            if jr is not None:
                jlo, jhi = j_certify.interval_link_mass_matrix(jr, qlo, qhi)
                np.testing.assert_allclose(Mlo, jlo, rtol=1e-9, atol=1e-12)
                np.testing.assert_allclose(Mhi, jhi, rtol=1e-9, atol=1e-12)
            qs = rng.uniform(qlo[0], qhi[0], (24, r.num_factors))
            Ms = rnea_numeric.mass_matrix(r, torch.as_tensor(qs), include_armature=False).numpy()
            assert np.all(Ms >= Mlo[0] - 1e-9) and np.all(Ms <= Mhi[0] + 1e-9), w


@pytest.mark.parametrize("name", ["kinova_dumbbell"])
def test_ultimate_bound_derivation_matches_jax(name):
    """derive_ultimate_bound at v_max = 5e-4 (no cache: the sampled bracket
    with its gradient refinement, certified_m_min, certified_m_max) against
    the JAX package, relative 1e-9, its provenance included."""
    ub, prov = derive_ultimate_bound(zoo.load_zoo_robot(name), v_max=5e-4,
                                     return_provenance=True)
    jub, jprov = j_derive_ub(j_zoo.load_zoo_robot(name), v_max=5e-4, return_provenance=True)
    jub = convert.ultimate_bound_from_fields(jub)
    for f in dataclasses.fields(ub):
        assert math.isclose(getattr(ub, f.name), getattr(jub, f.name), rel_tol=1e-9), f.name
    assert prov["certified"] == jprov["certified"]
    for k in ("m_cert", "m_min_sampled", "m_max_cert", "m_max_sampled"):
        assert math.isclose(prov[k], jprov[k], rel_tol=1e-9, abs_tol=1e-15), k


@pytest.mark.parametrize("name", ALL)
def test_cached_ultimate_bound_matches_jax(name):
    """The cached per-robot bounds (this package's ub_cache.json) are the
    JAX package's, with their provenance."""
    ub, prov = derive_ultimate_bound(zoo.load_zoo_robot(name), return_provenance=True)
    jub, jprov = j_derive_ub(j_zoo.load_zoo_robot(name), return_provenance=True)
    assert ub == convert.ultimate_bound_from_fields(jub)
    assert prov == jprov


def test_certified_bounds_match_jax():
    """certified_m_min (the branch and bound at a small box budget) and
    certified_m_max against the JAX package, for an arm without armature
    and for the flagship."""
    for r, jr in ((zoo.panda(), j_zoo.panda()), (zoo.kinova_urdf(), j_zoo.kinova_urdf())):
        assert math.isclose(certify.certified_m_min(r, max_boxes=40),
                            j_certify.certified_m_min(jr, max_boxes=40),
                            rel_tol=1e-9, abs_tol=1e-12)
        assert math.isclose(certify.certified_m_max(r), j_certify.certified_m_max(jr),
                            rel_tol=1e-9)


def test_derived_ultimate_bound_brackets_sampled_eigenvalues():
    """m_min below and m_max above every sampled eigenvalue of M(q)."""
    rng = np.random.default_rng(11)
    for r in (kinova_gen3(), zoo.kuka_iiwa()):
        ub = derive_ultimate_bound(r)
        lo, hi = _lim(r)
        M = rnea_numeric.mass_matrix(r, torch.as_tensor(rng.uniform(lo, hi, (64, r.num_factors))))
        eigs = np.linalg.eigvalsh(M.numpy())
        assert 0.0 < ub.m_min <= eigs.min(), (r.name, ub.m_min, eigs.min())
        assert ub.m_max >= eigs.max(), (r.name, ub.m_max, eigs.max())


def test_certified_m_min_below_sampled_everywhere():
    """certified_m_min is a sound lower bound for every zoo robot; for the
    Kinova the armature bound certifies 8.03 and eps stays within 1.2 x the
    reference's 0.0627."""
    rng = np.random.default_rng(5)
    for name in ALL:
        r = kinova_gen3() if name == "kinova_urdf" else zoo.load_zoo_robot(name)
        cert = certify.certified_m_min(r, max_boxes=60)
        lo, hi = _lim(r)
        M = rnea_numeric.mass_matrix(r, torch.as_tensor(rng.uniform(lo, hi, (32, r.num_factors))))
        sampled_min = float(np.linalg.eigvalsh(M.numpy())[..., 0].min())
        assert 0.0 <= cert <= sampled_min + 1e-9, (name, cert, sampled_min)
    cert = certify.certified_m_min(kinova_gen3())
    assert cert >= 8.0
    assert math.sqrt(2.0 * 1e-2 / cert) <= 1.2 * 0.0627


@pytest.mark.parametrize("name", ALL)
def test_derived_ultimate_bound_leaves_velocity_headroom(name):
    """qde = 2 eps stays at most half of every robot's smallest speed limit."""
    r = zoo.load_zoo_robot(name)
    ub = derive_ultimate_bound(r)
    min_speed = float(np.min(r.speed_limits))
    assert ub.qde <= 0.5 * min_speed + 1e-9, (name, ub.qde, min_speed)


def test_kinova_urdf_matches_header_model():
    a, b = zoo.kinova_urdf(), kinova_gen3()
    assert a.num_factors == b.num_factors == 7
    np.testing.assert_allclose(a.trans[:7], b.trans[:7], atol=2e-3)
    np.testing.assert_allclose(a.mass.sum(), b.mass.sum(), rtol=0.05)


def test_certified_bound_is_used_for_suite_robots():
    """The Kinova variants rest on the certified m_min in this package's
    ub_cache.json; every other zoo robot carries a waiver with flatness
    evidence; the flagship's derivation reports certified."""
    cache = json.loads((Path(zoo.__file__).parent / "ub_cache.json").read_text())
    by_name = {k.split("|")[0]: v for k, v in cache.items()}
    for name in ["kinova_gen3_7dof", "kinova_urdf", "kinova_dumbbell"]:
        assert by_name[name]["provenance"]["certified"] and by_name[name]["m_min"] >= 8.0
    for name in ["fetch_arm", "kuka_iiwa", "panda", "ur5"]:
        prov = by_name[name]["provenance"]
        assert not prov["certified"] and "waiver" in prov and "flatness" in prov
        assert prov["flatness"]["sampled_p05"] <= 3.0 * prov["flatness"]["sampled_min"]
    ub, prov = derive_ultimate_bound(kinova_gen3(), return_provenance=True)
    assert prov["certified"] and ub.m_min >= 8.0


def test_certified_m_max_above_sampled_and_tight_for_flagship():
    rng = np.random.default_rng(17)
    for r in (kinova_gen3(), zoo.kuka_iiwa(), zoo.panda()):
        cert = certify.certified_m_max(r)
        lo, hi = _lim(r)
        M = rnea_numeric.mass_matrix(r, torch.as_tensor(rng.uniform(lo, hi, (48, r.num_factors))))
        assert cert >= float(np.linalg.eigvalsh(M.numpy())[..., -1].max()) - 1e-9
    assert certify.certified_m_max(kinova_gen3()) <= 1.25 * 15.02


@pytest.mark.parametrize("name", ALL)
def test_zoo_plan_step_runs(name):
    """A reduced planning step (T = 8, two obstacle slots, the plain
    versions on the CPU) of every zoo robot returns a feasible k for a tiny
    move away from a far obstacle (input constraints off, as
    tests/test_robot_zoo.py runs the non-flagship robots)."""
    r = zoo.load_zoo_robot(name)
    cfg = ArmourConfig.for_robot(r, num_time_steps=8, dtype=torch.float64, max_obstacles=2,
                                 screen_k=128, solver_outer_iters=3, solver_inner_iters=3,
                                 turn_off_input_constraints=True)
    F = r.num_factors
    lo, hi = _lim(r)
    q0 = torch.as_tensor((lo + hi) / 2.0 + 0.05)
    qd0 = torch.zeros(F, dtype=torch.float64)
    obs = pad_obstacles(np.array([[2.5, 2.5, 2.5]]), np.stack([np.diag([0.05] * 3)]),
                        cfg.max_obstacles, cfg.dtype)
    res = make_planner(r, cfg, device="cpu")(q0, qd0, qd0, q0 + 0.02, obs)
    assert res.cost.shape == ()
    assert math.isfinite(float(res.cost))
    assert bool(res.feasible), f"{name}: expected a feasible plan"
    assert bool(torch.isfinite(res.k).all()) and float(res.k.abs().max()) <= 1.0 + 1e-9

"""The smooth collision mode (cfg.smooth_obstacle_constraints) of the
PyTorch port against the JAX package, float64 on the CPU: the port's mirror
of tests/test_planner_e2e.py::test_smooth_obstacle_mode_sound_and_solves at
the port tests' reduced config (num_time_steps = 16, max_obstacles = 16,
screen_k = 256) on that test's two-obstacle scene.

The smooth rows (screened_constraints with smooth_tau) must match the JAX
package's g and dg/dp at 1e-9, lie on or above the hard rows and at most
tau log(2C) above them, and the smooth planning step must give the JAX
step's verdict and cost, its k certified by the JAX package's exact
full-set check (max_violations stays exact in the smooth mode)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu import collision as jcol, nlp as jnlp
from armour_tpu.config import ArmourConfig as JConfig
from armour_tpu.dynamics import torque_frs
from armour_tpu.jrs import build_jrs
from armour_tpu.kinematics import forward_occupancy, reduce_links
from armour_tpu.models.kinova import kinova_gen3 as j_kinova
from armour_tpu.planner import make_planner as j_make_planner
from armour_tpu.pz.basis import make_basis as j_make_basis
from armour_tpu_torch import collision as tcol, convert
from armour_tpu_torch.planner import make_planner
from armour_tpu_torch.pz.basis import make_basis

J_ROBOT = j_kinova()
J_CFG = JConfig(num_time_steps=16, max_obstacles=16, screen_k=256, dtype=jnp.float64)
J_SMOOTH = dataclasses.replace(J_CFG, smooth_obstacle_constraints=True)
J_BASIS = j_make_basis(7, 3)
T_ROBOT = convert.robot_from_fields({f.name: getattr(J_ROBOT, f.name)
                                     for f in dataclasses.fields(J_ROBOT)})
T_SMOOTH = convert.config_from_fields({f.name: getattr(J_SMOOTH, f.name)
                                       for f in dataclasses.fields(J_SMOOTH)})
T_BASIS = make_basis(7, 3)
TAU = 0.01
TOL = 1e-9

# the two-obstacle scene of tests/test_planner_e2e.py
Q0 = np.array([0.6543, -0.0876, -0.4837, -1.2278, -1.5735, -1.0720, 0.0])
Q_DES = Q0 + 0.04
OBS_C = np.array([[0.5, 0.5, 0.5], [-0.5, -0.5, 0.8]])
OBS_G = np.stack([np.diag([0.05, 0.05, 0.05]), np.diag([0.08, 0.08, 0.08])])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the port's CPU step is many small ops, and the
    test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))[None]
            for f in dataclasses.fields(obj) if f.name != "dims"}


@pytest.fixture(scope="module")
def screened():
    """The scene's screened rows and link polynomials in both packages
    (JAX's, carried into the port through convert.py)."""
    obs = jcol.pad_obstacles(OBS_C, OBS_G, J_CFG.max_obstacles, jnp.float64)
    z = jnp.zeros(7)
    jrs = build_jrs(jnp.asarray(Q0), z, z, J_ROBOT, J_CFG, J_BASIS)
    frs = reduce_links(forward_occupancy(jrs, J_ROBOT, J_CFG, J_BASIS), J_BASIS)
    hyp = jcol.build_hyperplanes(frs, obs)
    sc = jcol.screen_collision(hyp, obs, frs, J_CFG.screen_k)
    return (frs, sc, convert.linkfrs_from_numpy(**_fields(frs)),
            convert.screened_from_numpy(**_fields(sc)))


@pytest.mark.parametrize("kval", [0.3, -0.6])
def test_smooth_rows_match_jax(screened, kval):
    """g and dg/dp of the smooth rows at 1e-9, and the JAX default
    (smooth_tau = 0) is the hard mode in both."""
    frs, sc, t_frs, t_sc = screened
    k = np.full(7, kval)
    p_all = jcol.eval_link_polys(frs, J_BASIS.phi(jnp.asarray(k)))
    t_p = tcol.eval_link_polys(t_frs, T_BASIS.phi(torch.as_tensor(k)[None, None]))
    for tau in (TAU, 0.0):
        jg, jgrad = (np.asarray(x) for x in jcol.screened_constraints(sc, p_all, tau))
        g, grad = tcol.screened_constraints(t_sc, t_p, tau)
        np.testing.assert_allclose(g[0, 0].numpy(), jg, rtol=TOL, atol=1e-12)
        np.testing.assert_allclose(grad[0, 0].numpy(), jgrad, rtol=TOL, atol=1e-12)
    g0, _ = tcol.screened_constraints(t_sc, t_p)
    assert torch.equal(g0, tcol.screened_constraints(t_sc, t_p, 0.0)[0])


@pytest.mark.parametrize("tau", [0.0, TAU], ids=["hard", "smooth"])
def test_rows_at_a_non_finite_point_match_jax(screened, tau):
    """At a link centre that is not finite (a line-search point after a
    failed Cholesky) every real row is NaN in both packages, and the padded
    rows stay at -BIG: the rows kernel K4 must give there too."""
    frs, sc, _, t_sc = screened
    p_all = jcol.eval_link_polys(frs, J_BASIS.phi(jnp.full(7, 0.3)))
    p_all = p_all.at[0].set(jnp.nan)             # x of every cell: [3, T*J]
    t_p = torch.as_tensor(np.array(p_all))[None, None]
    jg = np.asarray(jcol.screened_constraints(sc, p_all, tau)[0])
    g = tcol.screened_constraints(t_sc, t_p, tau)[0][0, 0].numpy()
    real = np.asarray(sc.mask)
    assert real.any() and (~real).any()
    assert np.all(np.isnan(jg[real])) and np.all(np.isnan(g[real]))
    np.testing.assert_array_equal(g[~real], jg[~real])


@pytest.mark.parametrize("kval", [0.3, -0.6])
def test_smooth_rows_over_approximate_the_hard_ones(screened, kval):
    """g_smooth >= g_exact on the real rows (sound) and at most tau log(2C)
    above it (not grossly loose), as the JAX test asks of its own rows."""
    _, _, t_frs, t_sc = screened
    t_p = tcol.eval_link_polys(t_frs, T_BASIS.phi(torch.full((1, 1, 7), kval,
                                                             dtype=torch.float64)))
    g_exact, _ = tcol.screened_constraints(t_sc, t_p)
    g_smooth, _ = tcol.screened_constraints(t_sc, t_p, TAU)
    real = t_sc.mask[:, None].expand_as(g_exact)
    assert bool(real.any())
    gap = (g_smooth - g_exact)[real]
    assert float(gap.min()) >= -1e-12
    assert float(gap.max()) <= TAU * np.log(2 * tcol.N_COMB) + 1e-9
    # the padded rows stay at -BIG in both modes
    assert torch.equal(g_smooth[~real], g_exact[~real])


def test_smooth_shift_rounds_in_the_dtype():
    """tau log(2C) as jnp's tau * log(2.0 * C): the log in the dtype, then
    the product; float32 rounds where float64 does not."""
    s64 = tcol.smooth_shift(TAU, 36, torch.float64)
    s32 = tcol.smooth_shift(TAU, 36, torch.float32)
    assert s64.dtype == torch.float64 and s32.dtype == torch.float32 and s32.dim() == 0
    assert float(s64) == pytest.approx(float(TAU * jnp.log(72.0)), rel=1e-15)
    assert float(s32) == float(np.float32(TAU) * torch.log(torch.tensor(72.0)).numpy())


@pytest.fixture(scope="module")
def plans():
    """The smooth planning step of both packages on the scene, and the JAX
    package's exact full-set check of the port's k."""
    obs = jcol.pad_obstacles(OBS_C, OBS_G, J_CFG.max_obstacles, jnp.float64)
    z = jnp.zeros(7)
    j_res = j_make_planner(J_ROBOT, J_SMOOTH)(jnp.asarray(Q0), z, z, jnp.asarray(Q_DES), obs)
    t_step = make_planner(T_ROBOT, T_SMOOTH, device="cpu")
    t_res = t_step(Q0, np.zeros(7), np.zeros(7), Q_DES,
                   tcol.pad_obstacles(OBS_C, OBS_G, T_SMOOTH.max_obstacles, torch.float64))
    jrs = build_jrs(jnp.asarray(Q0), z, z, J_ROBOT, J_CFG, J_BASIS)
    frs = reduce_links(forward_occupancy(jrs, J_ROBOT, J_CFG, J_BASIS), J_BASIS)
    hyp = jcol.build_hyperplanes(frs, obs)
    prob = jnlp.PlanProblem(traj=jrs.traj, q_des=jnp.asarray(Q_DES),
                            torque=torque_frs(jrs, J_ROBOT, J_CFG, J_BASIS), frs=frs, hyp=hyp,
                            obs=obs, screened=jcol.screen_collision(hyp, obs, frs,
                                                                    J_CFG.screen_k))
    check = None
    if bool(t_res.feasible):
        check = jax.jit(lambda k: jnp.stack(jnlp.max_violations(
            k, prob, J_ROBOT, J_SMOOTH, J_BASIS)))(jnp.asarray(t_res.k.numpy()))
    return j_res, t_res, check


def test_smooth_planner_matches_jax(plans):
    """The same verdict (feasible, as the JAX test asks), the cost within
    the planner tests' 1e-6 + 1e-6 |cost|, k finite inside [-1, 1]."""
    j_res, t_res, _ = plans
    assert bool(t_res.feasible) == bool(j_res.feasible)
    assert bool(t_res.feasible)
    k = t_res.k.numpy()
    assert np.all(np.isfinite(k)) and np.all(np.abs(k) <= 1.0 + 1e-9)
    assert abs(float(t_res.cost) - float(j_res.cost)) <= 1e-6 + 1e-6 * abs(float(j_res.cost))


def test_smooth_plan_passes_the_exact_check(plans):
    """The port's smooth k passes the JAX package's exact full-set check
    (torque, collision, state, grasp thresholds)."""
    _, t_res, check = plans
    v = np.asarray(check)
    thr = (J_SMOOTH.torque_violation_threshold, J_SMOOTH.collision_violation_threshold, 1e-6,
           J_SMOOTH.grasp_violation_threshold)
    assert all(float(x) <= t for x, t in zip(v, thr)), v

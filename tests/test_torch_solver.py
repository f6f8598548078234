"""The ALM solver's row evaluation and the real-time planner of the PyTorch
port against the JAX package, float64 on the CPU (num_time_steps = 16,
max_obstacles = 16, screen_k = 256).

alm_newton_plain and alm_values_plain are the specifications of kernels K7
and K8: their g, H, Cholesky step, merit, feasibility and rows must match
the formulas of armour_tpu/nlp.py:475-516 on the JAX package's
constraint_stack at 1e-9, with multipliers that make rows of every group
active.  One JAX problem is built for the module (no JAX planner compile)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu import nlp as jnlp
from armour_tpu.collision import build_hyperplanes, pad_obstacles as j_pad, screen_collision
from armour_tpu.config import ArmourConfig as JConfig
from armour_tpu.dynamics import torque_frs
from armour_tpu.jrs import build_jrs
from armour_tpu.kinematics import forward_occupancy, reduce_links
from armour_tpu.models.kinova import kinova_gen3 as j_kinova
from armour_tpu.pz.basis import make_basis as j_make_basis
from armour_tpu.worlds import load_world_csv
from armour_tpu_torch import convert, nlp as tnlp
from armour_tpu_torch.collision import pad_obstacles
from armour_tpu_torch.jrs import TrajectoryCoeffs
from armour_tpu_torch.planner import make_realtime_planner, make_rescue_planner
from armour_tpu_torch.pz.basis import make_basis
from armour_tpu_torch.worlds import straight_line_waypoint

J_ROBOT = j_kinova()
J_CFG = JConfig(num_time_steps=16, max_obstacles=16, screen_k=256, dtype=jnp.float64)
J_BASIS = j_make_basis(7, 3)
T_ROBOT = convert.robot_from_fields({f.name: getattr(J_ROBOT, f.name)
                                     for f in dataclasses.fields(J_ROBOT)})
T_CFG = convert.config_from_fields({f.name: getattr(J_CFG, f.name)
                                    for f in dataclasses.fields(J_CFG)})
BASIS = make_basis(7, 3)
TOL = 1e-9

# the two-obstacle scene of tests/test_planner_e2e.py
Q0 = np.array([0.6543, -0.0876, -0.4837, -1.2278, -1.5735, -1.0720, 0.0])
OBS_C = np.array([[0.5, 0.5, 0.5], [-0.5, -0.5, 0.8]])
OBS_G = np.stack([np.diag([0.05, 0.05, 0.05]), np.diag([0.08, 0.08, 0.08])])
CAL_KEYS = {"t_reachsets_s", "budget_s", "outer_iters", "step_s", "fits_budget"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the calibration tests time real CPU steps, and
    several test workers each spinning a full thread pool would make those
    times measure the contention instead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_fields(obj):
    """The array fields of a JAX dataclass as numpy, with a worlds axis."""
    return {f.name: np.array(getattr(obj, f.name))[None]
            for f in dataclasses.fields(obj) if f.name not in ("dims", "family")}


@pytest.fixture(scope="module")
def problem():
    """A saved scene from a moving start: the JAX PlanProblem and the same
    problem carried into the port through convert.py."""
    w = load_world_csv("saved_worlds/random/scene_013_001.csv")
    q_des = straight_line_waypoint(w.start, w.goal, continuous=T_ROBOT.continuous_joints)
    qd0 = np.random.default_rng(5).uniform(-0.3, 0.3, 7)
    obs = j_pad(w.obstacle_centers, w.obstacle_generators, J_CFG.max_obstacles, jnp.float64)

    @jax.jit
    def build(q0, qd0, q_des):
        jrs = build_jrs(q0, qd0, 0.5 * qd0, J_ROBOT, J_CFG, J_BASIS)
        frs = reduce_links(forward_occupancy(jrs, J_ROBOT, J_CFG, J_BASIS), J_BASIS)
        hyp = build_hyperplanes(frs, obs)
        return jnlp.PlanProblem(
            traj=jrs.traj, q_des=q_des, torque=torque_frs(jrs, J_ROBOT, J_CFG, J_BASIS),
            frs=frs, hyp=hyp, obs=obs,
            screened=screen_collision(hyp, obs, frs, J_CFG.screen_k))

    jp = build(jnp.asarray(w.start), jnp.asarray(qd0), jnp.asarray(q_des))
    tp = tnlp.PlanProblem(
        traj=TrajectoryCoeffs(**{k: torch.as_tensor(v) for k, v in _np_fields(jp.traj).items()}),
        q_des=torch.as_tensor(np.asarray(jp.q_des))[None],
        torque=convert.torque_frs_from_numpy(**_np_fields(jp.torque)),
        frs=convert.linkfrs_from_numpy(**_np_fields(jp.frs)),
        hyp=convert.hyperplanes_from_numpy(dims=jp.hyp.dims, **_np_fields(jp.hyp)),
        obs=convert.obstacles_from_numpy(**_np_fields(jp.obs)),
        screened=convert.screened_from_numpy(**_np_fields(jp.screened)),
        limits=tnlp.robot_limits(T_ROBOT, torch.float64, "cpu"))
    return jp, tp


def _groups(tp):
    """Row slices of the stack: torque, collision, state."""
    TF = 2 * tp.torque.u_coef.shape[1] * 7
    K = tp.screened.row.shape[-1]
    return {"torque": slice(0, TF), "collision": slice(TF, TF + K), "state": slice(TF + K, None)}


@pytest.fixture(scope="module")
def jax_side(problem):
    """The JAX package's rows and the formulas of armour_tpu/nlp.py:475-493
    at one (k, lam, rho), in the hard (False) and the smooth (True)
    collision mode; its m0, feasibility and clipped rows are also the value
    pass's merit, feasibility and rows (nlp.py:494-500)."""
    jp, _ = problem
    cost_fn = lambda kk: jnlp.plan_cost(kk, jp.traj, jp.q_des, J_ROBOT, J_CFG)
    thr = jnlp._stack_thresholds(jp, J_ROBOT, J_CFG, jnp.float64)
    Hc = jax.hessian(cost_fn)(jnp.zeros((7,)))

    def penalty(cc, lam, rho):
        return jnp.sum(jnp.where(lam + rho * cc > 0, (lam + rho * cc) ** 2, 0.0)) / (2 * rho)

    def make(cfg):
        @jax.jit
        def newton(k, lam, rho):
            c, Jc = jnlp.constraint_stack(k, jp, J_ROBOT, cfg, J_BASIS, with_grad=True)
            c = jnp.maximum(c, -1e6)
            act = (lam + rho * c) > 0.0
            w = jnp.where(act, rho, 0.0)
            lam_eff = jnp.where(act, lam + rho * c, 0.0)
            g = jax.grad(cost_fn)(k) + Jc.T @ lam_eff
            H = (Jc.T * w) @ Jc + Hc + 1e-3 * jnp.eye(7)
            step = jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(H), g)
            m0 = cost_fn(k) + penalty(c, lam, rho)
            return g, H, step, m0, jnp.all(c <= thr), c, act

        return newton

    return {smooth: make(dataclasses.replace(J_CFG, smooth_obstacle_constraints=smooth))
            for smooth in (False, True)}


def _cfg(smooth):
    return dataclasses.replace(T_CFG, smooth_obstacle_constraints=smooth)


def _state(problem, seed):
    """k [S=2, F] and rho [2] from seed, and lam [2, M] with rows of every
    group active (the torque rows need large multipliers)."""
    jp, tp = problem
    rng = np.random.default_rng(seed)
    k = rng.uniform(-1, 1, (2, 7))
    rho = rng.uniform(5.0, 50.0, 2)
    c0 = np.stack([np.asarray(jnlp.constraint_stack(jnp.asarray(kk), jp, J_ROBOT, J_CFG, J_BASIS,
                                                    with_grad=False)[0]) for kk in k])
    lam = np.where(c0 > -1e5, rng.uniform(0.0, 30.0, c0.shape), 0.0)
    lam[:, _groups(tp)["torque"]] *= 100.0
    return k, lam, rho


@pytest.mark.parametrize("smooth", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("seed", [1, 2])
def test_alm_newton_plain_matches_jax(problem, jax_side, seed, smooth):
    jp, tp = problem
    newton = jax_side[smooth]
    cfg = _cfg(smooth)
    k, lam, rho = _state(problem, seed)
    kt, lt, rt = (torch.as_tensor(x)[None] for x in (k, lam, rho))
    g, H, c = tnlp.alm_newton_system(kt, lt, rt, tp, cfg, BASIS)
    step, m0, feas, cost = tnlp.alm_newton_plain(kt, lt, rt, tp, cfg, BASIS)
    # CPU tensors take the plain version
    for got, want in zip(tnlp.alm_newton(kt, lt, rt, tp, cfg, BASIS), (step, m0, feas, cost)):
        assert torch.equal(got, want)
    for s in range(2):
        jg, jH, jstep, jm0, jfeas, jc, jact = (np.asarray(x) for x in newton(
            jnp.asarray(k[s]), jnp.asarray(lam[s]), jnp.asarray(rho[s])))
        for name, sl in _groups(tp).items():
            assert jact[sl].any(), f"no active {name} row"
        np.testing.assert_allclose(c[0, s].numpy(), jc, rtol=TOL, atol=1e-12)
        np.testing.assert_allclose(g[0, s].numpy(), jg, rtol=TOL, atol=TOL * np.abs(jg).max())
        np.testing.assert_allclose(H[0, s].numpy(), jH, rtol=TOL, atol=TOL * np.abs(jH).max())
        np.testing.assert_allclose(step[0, s].numpy(), jstep, rtol=TOL,
                                   atol=TOL * np.abs(jstep).max())
        np.testing.assert_allclose(float(m0[0, s]), float(jm0), rtol=TOL)
        assert bool(feas[0, s]) == bool(jfeas)


def _newton_case(case: str) -> np.ndarray:
    """A 7x7 H: SPD, or one whose Cholesky fails at a pivot < 0 or = 0, or
    meets a NaN."""
    rng = np.random.default_rng(7)
    J = rng.uniform(-1.0, 1.0, (9, 7))
    H = J.T @ J + 1e-3 * np.eye(7)
    if case == "negative_pivot":
        H[3, 3] = -1.0
    elif case == "zero_pivot":
        # the second pivot 1 - 1 * 1 = 0 exactly, in any order of operations
        H = 2.0 * np.eye(7)
        H[:2, :2] = 1.0
    elif case == "nan":
        H[5, 5] = np.nan
    return H


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["spd", "negative_pivot", "zero_pivot", "nan"])
def test_newton_step_matches_jax_cho_solve(case, dtype):
    """nlp.newton_step (alm_newton_plain's step, and K7's rule) against the
    JAX package's cho_factor / cho_solve (armour_tpu/nlp.py:486-487): the
    step of an SPD H, and NaN in every entry where the factorisation fails,
    in float32 (the card's dtype) and float64.  LAPACK's partial factor
    alone would give a finite step there, which the line search could take
    where the JAX solve keeps its iterate."""
    H = _newton_case(case).astype(dtype)
    g = np.random.default_rng(8).uniform(-1.0, 1.0, 7).astype(dtype)
    want = np.asarray(jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(jnp.asarray(H)),
                                                 jnp.asarray(g)))
    got = tnlp.newton_step(torch.as_tensor(H)[None, None], torch.as_tensor(g)[None, None])
    assert got.shape == (1, 1, 7) and got.dtype == torch.as_tensor(H).dtype
    got = got[0, 0].numpy()
    if case == "spd":
        assert np.all(np.isfinite(want))
        tol = 1e-4 if dtype == "float32" else TOL
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())
    else:
        assert np.all(np.isnan(want)) and np.all(np.isnan(got))


@pytest.mark.parametrize("smooth", [False, True], ids=["off", "on"])
def test_alm_values_plain_matches_jax(problem, jax_side, smooth):
    """Line-search layout: 3 queries per seed, each with its seed's lam/rho."""
    jp, tp = problem
    newton = jax_side[smooth]
    cfg = _cfg(smooth)
    k, lam, rho = _state(problem, 3)
    kq = np.clip(k[:, None] - np.array([1.0, 0.25, 0.5])[:, None] * 0.7, -1.0, 1.0).reshape(6, 7)
    seed_of_q = torch.arange(2).repeat_interleave(3)
    merit, feas, _, c = tnlp.alm_values_plain(torch.as_tensor(kq)[None],
                                              torch.as_tensor(lam)[None],
                                              torch.as_tensor(rho)[None], seed_of_q, tp, cfg,
                                              BASIS, want_c=True)
    for q in range(6):
        s = int(seed_of_q[q])
        jm, jf, jc = (np.asarray(x) for x in newton(jnp.asarray(kq[q]), jnp.asarray(lam[s]),
                                                    jnp.asarray(rho[s]))[3:6])
        np.testing.assert_allclose(float(merit[0, q]), float(jm), rtol=TOL)
        np.testing.assert_allclose(c[0, q].numpy(), jc, rtol=TOL, atol=1e-12)
        assert bool(feas[0, q]) == bool(jf)
    m_cpu, f_cpu, _, c_cpu = tnlp.alm_values(torch.as_tensor(kq)[None], torch.as_tensor(lam)[None],
                                          torch.as_tensor(rho)[None], seed_of_q, tp, cfg,
                                          BASIS)
    assert torch.equal(m_cpu, merit) and torch.equal(f_cpu, feas) and c_cpu is None


def test_is_feasible_matches_jax(problem):
    """Full-set verdicts at k = 0 and 8 random k, with the collision
    threshold set to the median collision violation so that both verdicts
    occur."""
    jp, tp = problem
    ks = np.concatenate([np.zeros((1, 7)), np.random.default_rng(4).uniform(-1, 1, (8, 7))])
    v_col = [float(jnlp.max_violations(jnp.asarray(k), jp, J_ROBOT, J_CFG, J_BASIS)[1])
             for k in ks]
    thr = float(np.median(v_col))
    jcfg = dataclasses.replace(J_CFG, collision_violation_threshold=thr)
    tcfg = dataclasses.replace(T_CFG, collision_violation_threshold=thr)
    got = tnlp.is_feasible(torch.as_tensor(ks)[None], tp, tcfg, BASIS)[0].tolist()
    want = [bool(jnlp.is_feasible(jnp.asarray(k), jp, J_ROBOT, jcfg, J_BASIS)) for k in ks]
    assert got == want
    assert any(want) and not all(want)


def _two_obstacles():
    return (Q0, np.zeros(7), np.zeros(7), Q0 + 0.04,
            pad_obstacles(OBS_C, OBS_G, T_CFG.max_obstacles, torch.float64))


def test_realtime_planner_calibration():
    """make_realtime_planner derives the solver budget from the measured
    reach-set time and returns a working step (test_planner_e2e.py:234-246).
    The horizon is 2 s: the eager reach sets take ~0.2 s on one idle CPU
    core and ~0.7 s under a loaded parallel test run, which a 1 s horizon's
    0.45 s would not leave a positive budget (the card's calibration at the
    flagship size is chip_smoke.py's phase 8)."""
    cfg = dataclasses.replace(T_CFG, duration=2.0)
    step, cal = make_realtime_planner(T_ROBOT, cfg, device="cpu")
    assert set(cal) == CAL_KEYS
    assert cal["budget_s"] > 0, cal
    assert cal["budget_s"] == pytest.approx(0.5 * cfg.duration - cal["t_reachsets_s"] - 0.05)
    assert 2 <= cal["outer_iters"] <= cfg.solver_outer_iters
    assert cal["fits_budget"] == (cal["step_s"] <= cal["t_reachsets_s"] + cal["budget_s"])
    res = step(*_two_obstacles())
    assert bool(res.feasible)


def test_realtime_planner_lowers_to_min_outer():
    """With a time buffer of 1 s the budget is negative: every level (3,
    then 2 outer iterations) misses it and the loop ends at min_outer."""
    cfg = dataclasses.replace(T_CFG, solver_outer_iters=3)
    _, cal = make_realtime_planner(T_ROBOT, cfg, time_buffer=1.0, device="cpu")
    assert cal["budget_s"] < 0
    assert cal["outer_iters"] == 2
    assert cal["fits_budget"] is False


def test_rescue_planner_solves_two_obstacle_scene():
    res = make_rescue_planner(T_ROBOT, T_CFG, device="cpu")(*_two_obstacles())
    assert bool(res.feasible)
    assert np.all(np.abs(res.k.numpy()) <= 1.0)

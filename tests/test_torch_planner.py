"""The PyTorch port's planning step against the JAX planner, float64 on the
CPU (num_time_steps = 16, max_obstacles = 16, screen_k = 256): the two-obstacle
scene and its walled-in infeasible case from test_planner_e2e.py, and three
saved scenes through the batched planner.  Both packages must agree on
feasibility and on the cost (1e-6 + 1e-6 |cost|), and every feasible k of the
port must pass the JAX package's full-set nlp.max_violations thresholds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu import nlp as jnlp
from armour_tpu import rnea_numeric
from armour_tpu.collision import (build_hyperplanes, pad_obstacles as j_pad,
                                  screen_collision)
from armour_tpu.config import ArmourConfig as JConfig
from armour_tpu.dynamics import torque_frs
from armour_tpu.jrs import build_jrs
from armour_tpu.kinematics import forward_occupancy, reduce_links
from armour_tpu.models.kinova import kinova_gen3 as j_kinova
from armour_tpu.planner import make_planner as j_make_planner, strong_config as j_strong
from armour_tpu.pz.basis import make_basis as j_make_basis
from armour_tpu.worlds import load_world_csv
from armour_tpu_torch import convert, nlp as tnlp
from armour_tpu_torch.collision import pad_obstacles, stack_obstacles
from armour_tpu_torch.jrs import TrajectoryCoeffs
from armour_tpu_torch.planner import make_batch_planner, make_planner, strong_config
from armour_tpu_torch.pz.basis import make_basis
from armour_tpu_torch.worlds import straight_line_waypoint

J_ROBOT = j_kinova()
J_CFG = JConfig(num_time_steps=16, max_obstacles=16, screen_k=256, dtype=jnp.float64)
J_BASIS = j_make_basis(7, 3)
T_ROBOT = convert.robot_from_fields({f.name: getattr(J_ROBOT, f.name)
                                     for f in dataclasses.fields(J_ROBOT)})
T_CFG = convert.config_from_fields({f.name: getattr(J_CFG, f.name)
                                    for f in dataclasses.fields(J_CFG)})

Q0 = np.array([0.6543, -0.0876, -0.4837, -1.2278, -1.5735, -1.0720, 0.0])
OBS_C = np.array([[0.5, 0.5, 0.5], [-0.5, -0.5, 0.8]])
OBS_G = np.stack([np.diag([0.05, 0.05, 0.05]), np.diag([0.08, 0.08, 0.08])])
SAVED = ["scene_013_001", "scene_013_002", "scene_013_003"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small: one torch thread each, so that the
    six workers of a full run do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _walled():
    _, _, link_c = rnea_numeric.forward_kinematics(J_ROBOT, jnp.asarray(Q0))
    return np.asarray(link_c)[:7], np.stack([np.diag([0.3, 0.3, 0.3])] * 7)


def _scenes():
    """name -> (q0, q_des, obstacle centres, obstacle generators)."""
    out = {"two_obstacles": (Q0, Q0 + 0.04, OBS_C, OBS_G),
           "walled_in": (Q0, Q0 + 0.04, *_walled())}
    for name in SAVED:
        w = load_world_csv(f"saved_worlds/random/{name}.csv")
        wp = straight_line_waypoint(w.start, w.goal, continuous=T_ROBOT.continuous_joints)
        out[name] = (w.start, wp, w.obstacle_centers, w.obstacle_generators)
    return out


@pytest.fixture(scope="module")
def results():
    scenes = _scenes()
    j_step = j_make_planner(J_ROBOT, J_CFG)

    @jax.jit
    def j_max_violations(q0, q_des, obs, k):
        z = jnp.zeros_like(q0)
        jrs = build_jrs(q0, z, z, J_ROBOT, J_CFG, J_BASIS)
        frs = reduce_links(forward_occupancy(jrs, J_ROBOT, J_CFG, J_BASIS), J_BASIS)
        hyp = build_hyperplanes(frs, obs)
        prob = jnlp.PlanProblem(
            traj=jrs.traj, q_des=q_des, torque=torque_frs(jrs, J_ROBOT, J_CFG, J_BASIS),
            frs=frs, hyp=hyp, obs=obs,
            screened=screen_collision(hyp, obs, frs, J_CFG.screen_k))
        return jnp.stack(jnlp.max_violations(k, prob, J_ROBOT, J_CFG, J_BASIS))

    out = {}
    for name, (q0, q_des, c, g) in scenes.items():
        obs = j_pad(c, g, J_CFG.max_obstacles, jnp.float64)
        z = jnp.zeros(7)
        out[name] = {"jax": j_step(jnp.asarray(q0), z, z, jnp.asarray(q_des), obs)}

    # single-world planner on the e2e scenes
    t_step = make_planner(T_ROBOT, T_CFG, device="cpu")
    for name in ("two_obstacles", "walled_in"):
        q0, q_des, c, g = scenes[name]
        out[name]["torch"] = t_step(q0, np.zeros(7), np.zeros(7), q_des,
                                    pad_obstacles(c, g, T_CFG.max_obstacles, torch.float64))
    # batched planner over the saved scenes (W = 3)
    b_step = make_batch_planner(T_ROBOT, T_CFG, device="cpu")
    q0 = np.stack([scenes[n][0] for n in SAVED])
    q_des = np.stack([scenes[n][1] for n in SAVED])
    obs = stack_obstacles([pad_obstacles(scenes[n][2], scenes[n][3], T_CFG.max_obstacles,
                                         torch.float64) for n in SAVED])
    res = b_step(q0, np.zeros_like(q0), np.zeros_like(q0), q_des, obs)
    for w, name in enumerate(SAVED):
        out[name]["torch"] = jnlp.SolveResult(k=res.k[w], feasible=res.feasible[w],
                                              cost=res.cost[w], viol=res.viol[w])

    for name, (q0, q_des, c, g) in scenes.items():
        r = out[name]["torch"]
        if bool(r.feasible):
            obs = j_pad(c, g, J_CFG.max_obstacles, jnp.float64)
            out[name]["jax_check"] = np.asarray(j_max_violations(
                jnp.asarray(q0), jnp.asarray(q_des), obs, jnp.asarray(r.k.numpy())))
    return out


NAMES = ["two_obstacles", "walled_in", *SAVED]


@pytest.mark.parametrize("name", NAMES)
def test_feasibility_agrees(results, name):
    r = results[name]
    assert bool(r["torch"].feasible) == bool(r["jax"].feasible)


@pytest.mark.parametrize("name", NAMES)
def test_cost_agrees(results, name):
    r = results[name]
    c_t, c_j = float(r["torch"].cost), float(r["jax"].cost)
    assert abs(c_t - c_j) <= 1e-6 + 1e-6 * abs(c_j), (c_t, c_j)


@pytest.mark.parametrize("name", NAMES)
def test_feasible_k_certified_by_jax(results, name):
    r = results[name]
    if not bool(r["torch"].feasible):
        assert np.all(np.isnan(r["torch"].k.numpy()))
        return
    k = r["torch"].k.numpy()
    assert np.all(np.isfinite(k)) and np.all(np.abs(k) <= 1.0 + 1e-9)
    v_torque, v_col, v_state, v_grasp = r["jax_check"]
    assert v_torque <= J_CFG.torque_violation_threshold
    assert v_col <= J_CFG.collision_violation_threshold
    assert v_state <= 1e-6
    assert v_grasp <= J_CFG.grasp_violation_threshold


def test_scenes_cover_both_verdicts(results):
    assert bool(results["two_obstacles"]["torch"].feasible)
    assert not bool(results["walled_in"]["torch"].feasible)


def test_strong_config_matches_jax():
    t = strong_config(T_CFG)
    j = j_strong(J_CFG)
    for f in dataclasses.fields(j):
        if f.name not in ("dtype", "ub"):
            assert getattr(t, f.name) == getattr(j, f.name), f.name


def _np_fields(obj):
    """The array fields of a JAX dataclass as numpy, with a worlds axis."""
    return {f.name: np.array(getattr(obj, f.name))[None]
            for f in dataclasses.fields(obj) if f.name not in ("dims", "family")}


@pytest.fixture(scope="module")
def problem():
    """One saved scene's JAX PlanProblem, and the same problem carried into
    the port through convert.py (so the NLP is tested on its own)."""
    q0, q_des, c, g = _scenes()["scene_013_002"]
    obs = j_pad(c, g, J_CFG.max_obstacles, jnp.float64)

    @jax.jit
    def build(q0, q_des):
        z = jnp.zeros_like(q0)
        jrs = build_jrs(q0, z, z, J_ROBOT, J_CFG, J_BASIS)
        frs = reduce_links(forward_occupancy(jrs, J_ROBOT, J_CFG, J_BASIS), J_BASIS)
        hyp = build_hyperplanes(frs, obs)
        return jnlp.PlanProblem(
            traj=jrs.traj, q_des=q_des, torque=torque_frs(jrs, J_ROBOT, J_CFG, J_BASIS),
            frs=frs, hyp=hyp, obs=obs,
            screened=screen_collision(hyp, obs, frs, J_CFG.screen_k))

    jp = build(jnp.asarray(q0), jnp.asarray(q_des))
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


@pytest.mark.parametrize("smooth", [False, True], ids=["off", "on"])
def test_constraint_stack_matches_jax(problem, smooth):
    """Rows, Jacobian, thresholds and full-set violations at three k, in the
    hard and the smooth collision mode (the full-set check exact in both)."""
    jp, tp = problem
    j_cfg = dataclasses.replace(J_CFG, smooth_obstacle_constraints=smooth)
    t_cfg = dataclasses.replace(T_CFG, smooth_obstacle_constraints=smooth)
    ks = np.random.default_rng(11).uniform(-1, 1, (3, 7))
    basis = make_basis(7, 3)
    c, J = tnlp.constraint_stack(torch.as_tensor(ks)[None], tp, t_cfg, basis)
    v = tnlp.max_violations(torch.as_tensor(ks)[None], tp, t_cfg, basis)
    for q, k in enumerate(ks):
        jc, jJ = jnlp.constraint_stack(jnp.asarray(k), jp, J_ROBOT, j_cfg, J_BASIS)
        np.testing.assert_allclose(c[0, q].numpy(), np.asarray(jc), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(J[0, q].numpy(), np.asarray(jJ), rtol=1e-9, atol=1e-12)
        jv = jnlp.max_violations(jnp.asarray(k), jp, J_ROBOT, j_cfg, J_BASIS)
        for t, j in zip(v, jv):
            np.testing.assert_allclose(t[0, q].numpy(), np.asarray(j), rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(
        tnlp._stack_thresholds(tp, t_cfg).numpy(),
        np.asarray(jnlp._stack_thresholds(jp, J_ROBOT, j_cfg, jnp.float64)))


def test_cost_gradient_and_hessian_match_jax(problem):
    """The closed-form cost derivatives against jax.grad / jax.hessian."""
    jp, tp = problem
    ks = np.random.default_rng(12).uniform(-1, 1, (2, 7))
    kt = torch.as_tensor(ks)[None]
    cont = tp.limits.continuous
    cost = tnlp.plan_cost(kt, tp.traj, tp.q_des, cont, T_CFG)
    grad = tnlp.plan_cost_grad(kt, tp.traj, tp.q_des, cont, T_CFG)
    hess = tnlp.plan_cost_hessian(tp.traj, T_CFG)
    for q, k in enumerate(ks):
        fn = lambda kk: jnlp.plan_cost(kk, jp.traj, jp.q_des, J_ROBOT, J_CFG)
        np.testing.assert_allclose(float(cost[0, q]), float(fn(jnp.asarray(k))), rtol=1e-12)
        np.testing.assert_allclose(grad[0, q].numpy(), np.asarray(jax.grad(fn)(jnp.asarray(k))),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(hess[0, 0].numpy(), np.asarray(jax.hessian(fn)(jnp.asarray(k))),
                                   rtol=1e-9, atol=1e-12)


"""The port's reference file interface and solvability oracle against the
JAX package, float64 on the CPU.

plan_from_armour_in: the same armour.in through both packages at the config
of test_reference_fixture.py (T = 8, O = 4, screen_k = 256, 3 x 3 solver
iterations, two obstacles): the same feasibility, k within 1e-6, and every
dump file read back at 1e-9, the collision block link-major.  The rest-FRS
checker: the port's margins against the JAX pipeline evaluated as
armour_tpu/solvability.py:117-128 does, at the same small config, 1e-9.
The verdict ladder and the open / blocked-start cases of
test_solvability.py at the small config."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from armour_tpu import armour_io as j_io
from armour_tpu import nlp as jnlp
from armour_tpu.collision import build_hyperplanes, pad_obstacles as j_pad, screen_collision
from armour_tpu.config import ArmourConfig as JConfig
from armour_tpu.dynamics import torque_frs
from armour_tpu.jrs import build_jrs
from armour_tpu.kinematics import forward_occupancy, reduce_links
from armour_tpu.models.kinova import kinova_gen3 as j_kinova
from armour_tpu.pz.basis import make_basis as j_make_basis
from armour_tpu_torch import armour_io, convert
from armour_tpu_torch import solvability as sv
from armour_tpu_torch.hlp import _fk_points_batch
from armour_tpu_torch.worlds import World, load_world_csv

J_ROBOT = j_kinova()
J_CFG = JConfig(num_time_steps=8, dtype=jnp.float64, max_obstacles=4, screen_k=256,
                solver_outer_iters=3, solver_inner_iters=3)
J_BASIS = j_make_basis(7, 3)
T_ROBOT = convert.robot_from_fields({f.name: getattr(J_ROBOT, f.name)
                                     for f in dataclasses.fields(J_ROBOT)})
T_CFG = convert.config_from_fields({f.name: getattr(J_CFG, f.name)
                                    for f in dataclasses.fields(J_CFG)})

Q0 = np.array([0.6543, -0.0876, -0.4837, -1.2278, -1.5735, -1.0720, 0.0])
DUMPS = ("armour_joint_position_center.out", "armour_joint_position_radius.out",
         "armour_control_input_radius.out", "armour_constraints.out")


@pytest.fixture(scope="module")
def io_runs(tmp_path_factory):
    """One armour.in (test_reference_fixture.py's scene) through both
    packages: (JAX result, its dir, port result, its dir)."""
    root = tmp_path_factory.mktemp("armour_io")
    data = armour_io.ArmourIn(
        q0=Q0, qd0=np.zeros(7), qdd0=np.zeros(7), q_des=Q0 + 0.02,
        centers=np.array([[2.5, 2.5, 2.5], [-2.0, 2.0, 1.5]]),
        generators=np.stack([np.diag([0.05, 0.05, 0.05]), np.diag([0.08, 0.04, 0.06])]))
    in_path = str(root / "armour.in")
    armour_io.write_armour_in(in_path, data)
    jdir, tdir = root / "jax", root / "torch"
    jout = j_io.plan_from_armour_in(in_path, str(jdir), J_ROBOT, J_CFG)
    tout = armour_io.plan_from_armour_in(in_path, str(tdir), T_ROBOT, T_CFG, device="cpu")
    return jout, jdir, tout, tdir


def test_plan_from_armour_in_matches_the_jax_package(io_runs):
    jout, jdir, tout, tdir = io_runs
    assert tout["feasible"] == jout["feasible"] and tout["feasible"]
    np.testing.assert_allclose(tout["k"], jout["k"], rtol=0, atol=1e-6)
    k_j, _ = j_io.read_armour_out(str(jdir / "armour.out"))
    k_t, ms = armour_io.read_armour_out(str(tdir / "armour.out"))
    np.testing.assert_allclose(k_t, k_j, rtol=0, atol=1e-6)
    assert ms == pytest.approx(tout["millis"]) and ms > 0
    for name in DUMPS:
        got, want = np.loadtxt(str(tdir / name)), np.loadtxt(str(jdir / name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9, err_msg=name)
    assert set(tout) == set(jout)
    for key in jout:
        if key not in ("k", "feasible", "millis"):
            np.testing.assert_allclose(np.asarray(tout[key]), np.asarray(jout[key]),
                                       rtol=0, atol=1e-9, err_msg=key)


def test_constraint_dump_is_link_major(io_runs):
    """armour_constraints.out: T*F torque rows time-major, J*T*O collision
    rows link-major ((link*T + t)*O + o), then the 4F state rows."""
    _, _, tout, tdir = io_runs
    T, J, O = tout["constraint_collision"].shape
    F = T_ROBOT.num_factors
    g = np.loadtxt(str(tdir / "armour_constraints.out"))
    assert g.shape == (T * F + J * T * O + 4 * F,) and O == 2
    np.testing.assert_allclose(g[:T * F], tout["constraint_torque"].reshape(-1), atol=1e-5)
    np.testing.assert_allclose(
        g[T * F:T * F + J * T * O],
        np.transpose(tout["constraint_collision"], (1, 0, 2)).reshape(-1), atol=1e-5)
    np.testing.assert_allclose(g[T * F + J * T * O:], tout["constraint_state"], atol=1e-5)
    assert np.all(g[T * F:T * F + J * T * O] <= 1e-4)


def test_armour_in_out_roundtrip(tmp_path):
    """armour.in / armour.out byte formats: parse(write(x)) == x, and the
    port's files read back through the JAX readers."""
    rng = np.random.default_rng(0)
    gens = np.stack([np.diag(rng.uniform(0.01, 0.3, 3)) for _ in range(3)])
    data = armour_io.ArmourIn(
        q0=rng.uniform(-1, 1, 7), qd0=rng.uniform(-1, 1, 7), qdd0=rng.uniform(-1, 1, 7),
        q_des=rng.uniform(-1, 1, 7), centers=rng.uniform(-1, 1, (3, 3)), generators=gens)
    p = str(tmp_path / "armour.in")
    armour_io.write_armour_in(p, data)
    for back in (armour_io.read_armour_in(p), j_io.read_armour_in(p)):
        for f in ("q0", "qd0", "qdd0", "q_des", "centers", "generators"):
            np.testing.assert_allclose(getattr(back, f), getattr(data, f), atol=1e-9)
    po = str(tmp_path / "armour.out")
    armour_io.write_armour_out(po, np.array([0.1, -0.2, 0.3, 0, 0.5, -0.6, 0.7]), 123.4)
    for read in (armour_io.read_armour_out, j_io.read_armour_out):
        k, ms = read(po)
        np.testing.assert_allclose(k, [0.1, -0.2, 0.3, 0, 0.5, -0.6, 0.7])
        assert ms == pytest.approx(123.4)
    armour_io.write_armour_out(po, None, 55.0)
    k, ms = armour_io.read_armour_out(po)
    assert k is None and ms == pytest.approx(55.0)


def _world(centers, sides, start=None, goal=None):
    centers = np.asarray(centers, float).reshape(-1, 3)
    gens = np.stack([np.diag(np.asarray(s, float) / 2.0) for s in sides])
    return World(start=np.zeros(7) if start is None else np.asarray(start, float),
                 goal=np.array([0.5, -0.3, 0.4, -0.6, 0.2, 0.3, -0.2]) if goal is None
                 else np.asarray(goal, float),
                 obstacle_centers=centers, obstacle_generators=gens)


def _open_world():
    return _world([[2.5, 2.5, 2.5]], [[0.1, 0.1, 0.1]])


def _blocked_start_world():
    """A box centred on the start configuration's elbow."""
    pts = _fk_points_batch(T_ROBOT, np.zeros((1, 7)))[0]
    return _world([pts[3]], [[0.3, 0.3, 0.3]])


@jax.jit
def _j_margin(q, obs):
    """armour_tpu/solvability.py:117-128 at J_CFG."""
    q0 = jnp.asarray(q, J_CFG.dtype)
    z = jnp.zeros_like(q0)
    jrs = build_jrs(q0, z, z, J_ROBOT, J_CFG, J_BASIS)
    frs = reduce_links(forward_occupancy(jrs, J_ROBOT, J_CFG, J_BASIS), J_BASIS)
    tq = torque_frs(jrs, J_ROBOT, J_CFG, J_BASIS)
    hyp = build_hyperplanes(frs, obs)
    scr = screen_collision(hyp, obs, frs, J_CFG.screen_k, J_CFG.screen_obstacle_quota)
    prob = jnlp.PlanProblem(traj=jrs.traj, q_des=q0, torque=tq, frs=frs, hyp=hyp, obs=obs,
                            screened=scr)
    return jnlp.max_violations(jnp.zeros_like(q0), prob, J_ROBOT, J_CFG, J_BASIS)[1]


def test_rest_frs_checker_matches_the_jax_pipeline():
    rest = sv.make_rest_frs_checker(T_ROBOT, cfg=T_CFG, device="cpu")
    assert sv.make_rest_frs_checker(T_ROBOT, cfg=T_CFG, device="cpu") is rest
    saved = load_world_csv("saved_worlds/random/scene_013_001.csv")
    saved = dataclasses.replace(saved, obstacle_centers=saved.obstacle_centers[:4],
                                obstacle_generators=saved.obstacle_generators[:4])
    signs = []
    for w in (_open_world(), _blocked_start_world(), saved):
        obs = j_pad(w.obstacle_centers, w.obstacle_generators, J_CFG.max_obstacles,
                    J_CFG.dtype)
        for q in (w.start, w.goal):
            want = float(_j_margin(jnp.asarray(q), obs))
            got = rest(q, w)
            assert abs(got - want) <= 1e-9, (got, want)
            signs.append(got > 0)
    assert signs[:3] == [False, False, True]


def test_verdict_mapping(monkeypatch):
    """planner_failure / padding_blocked / no_path_found from the search
    outcomes (mocked)."""
    w = _open_world()
    monkeypatch.setattr(sv, "_connects", lambda world, robot, buffer, *a, **k: buffer == 0.0)
    v = sv.classify_world(w, T_ROBOT, frs_check=False)
    assert v["verdict"] == "padding_blocked" and v["path_unpadded"] and not v["path_padded"]
    monkeypatch.setattr(sv, "_connects", lambda *a, **k: False)
    assert sv.classify_world(w, T_ROBOT, frs_check=False)["verdict"] == "no_path_found"
    monkeypatch.setattr(sv, "_connects", lambda *a, **k: True)
    assert sv.classify_world(w, T_ROBOT, frs_check=False)["verdict"] == "planner_failure"


def test_goal_inside_obstacle_is_static_blocked():
    goal = np.array([0.5, -0.3, 0.4, -0.6, 0.2, 0.3, -0.2])
    pts = _fk_points_batch(T_ROBOT, goal[None])[0]
    w = _world([pts[3]], [[0.25, 0.25, 0.25]], goal=goal)
    v = sv.classify_world(w, T_ROBOT, max_nodes=400, frs_check=False)
    assert v["verdict"] == "static_blocked" and not v["goal_free"]


def test_rest_frs_verdicts_at_the_small_config():
    """An open world is a planner failure (rest margins negative at start
    and goal); a box on the start's elbow is the proof class
    frs_blocked_start."""
    w_open = _open_world()
    v = sv.classify_world(w_open, T_ROBOT, max_nodes=800, cfg=T_CFG, device="cpu")
    assert v["verdict"] == "planner_failure"
    v = sv.classify_world(_blocked_start_world(), T_ROBOT, cfg=T_CFG, device="cpu")
    assert v["verdict"] == "frs_blocked_start" and v["rest_frs_start"] > 0.0

"""The ARMTD (constant-acceleration) family of the PyTorch port against the
JAX package, float64 on the CPU at num_time_steps = 16 unless a test says
otherwise: build_jrs_armtd (every field within 1e-9, in the three regimes of
g_k), the float32 sub-interval that starts at t_plan, both state extrema with
their gradients, the cost with its gradient and Hessian, advance_plan /
desired_state, plan_step_armtd on tests/test_armtd.py's problem, the
containment of sampled trajectories in the port's sets, and the armtd mode
of the experiment harness (the closed loop is
tests/test_torch_closed_loop_armtd.py; K11 and K7 / K8's ARMTD branch are
held against their plain versions on the card in
tests/test_torch_kernel_geometry.py)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu import armtd as j_armtd
from armour_tpu import nlp as j_nlp
from armour_tpu import trajectory as j_traj
from armour_tpu.collision import pad_obstacles as j_pad
from armour_tpu.config import ArmourConfig as JConfig
from armour_tpu.models.kinova import kinova_gen3 as j_kinova
from armour_tpu.pz.basis import make_basis as j_make_basis
from armour_tpu_torch import armtd, convert, nlp, trajectory
from armour_tpu_torch.collision import pad_obstacles, stack_obstacles
from armour_tpu_torch.config import ArmourConfig
from armour_tpu_torch.jrs import TrajectoryCoeffs
from armour_tpu_torch.planner import make_batch_planner, make_planner, plan_problem
from armour_tpu_torch.pz.basis import make_basis

J_ROBOT = j_kinova()
J_CFG = JConfig(num_time_steps=16, dtype=jnp.float64, max_obstacles=4)
J_BASIS = j_make_basis(7, 3)
T_ROBOT = convert.robot_from_fields({f.name: getattr(J_ROBOT, f.name)
                                     for f in dataclasses.fields(J_ROBOT)})
T_CFG = convert.config_from_fields({f.name: getattr(J_CFG, f.name)
                                    for f in dataclasses.fields(J_CFG)})
T_BASIS = make_basis(7, 3)
F64 = torch.float64

# tests/test_armtd.py's state
Q0 = np.array([0.3, -0.2, 0.4, -1.0, 0.2, -0.5, 0.1])
QD0 = np.array([0.3, -0.4, 0.2, 0.5, -0.3, 0.1, 0.4])

# |qd0| / 3 below pi/24 (the floor), between pi/24 and pi/3, above pi/3 (the cap)
REGIMES = {"floor": np.array([0.3, -0.2, 0.1, 0.0, -0.35, 0.05, 0.25]),
           "adaptive": np.array([0.6, -1.2, 2.0, -2.9, 0.45, 1.5, -0.8]),
           "cap": np.array([3.3, -4.0, 5.5, -3.2, 6.0, -3.5, 4.2])}


def close(t, j, rtol=1e-9):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    scale = max(1.0, float(np.max(np.abs(j)))) if j.size else 1.0
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * 1e-3 * scale)


def _t(x, dtype=F64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _jtraj(tr: TrajectoryCoeffs, w: int):
    """World w of the port's trajectory scalars as the JAX package's."""
    from armour_tpu.jrs import TrajectoryCoeffs as JTraj

    return JTraj(**{n: jnp.asarray(getattr(tr, n)[w].numpy())
                    for n in ("q0", "qd0", "qdd0", "Tqd0", "TTqdd0", "k_scale")},
                 family=tr.family)


_J_JRS = jax.jit(lambda q, qd: j_armtd.build_jrs_armtd(q, qd, J_ROBOT, J_CFG, J_BASIS))


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The port's CPU path is many small tensor ops: one intra-op thread
    runs them faster than a thread pool that the test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_build_jrs_armtd_matches_jax(regime):
    qd0 = REGIMES[regime]
    gk = np.abs(qd0) / 3.0
    if regime == "floor":
        assert np.all(gk < math.pi / 24)
    elif regime == "adaptive":
        assert np.all((gk > math.pi / 24) & (gk < math.pi / 3))
    else:
        assert np.all(gk > math.pi / 3)
    got = armtd.build_jrs_armtd(_t(Q0)[None], _t(qd0)[None], T_ROBOT, T_CFG, T_BASIS)
    want = _J_JRS(jnp.asarray(Q0), jnp.asarray(qd0))
    for f in ("R", "Rt", "qd", "qda", "qdda"):
        for g in ("coef", "egen", "rad"):
            close(getattr(getattr(got, f), g)[0], getattr(getattr(want, f), g))
    for n in ("q0", "qd0", "qdd0", "Tqd0", "TTqdd0", "k_scale"):
        close(getattr(got.traj, n)[0], getattr(want.traj, n))
    assert got.traj.family == want.traj.family == "armtd"


def test_qdda_at_t_plan_covers_both_phases_in_float32():
    """The sub-interval that starts at t_plan: its lower end t_plan + 1e-9
    rounds to t_plan in float32, so both packages' qdda sets hold the
    phase-1 acceleration k g_k as well as the braking one."""
    j_cfg = dataclasses.replace(J_CFG, dtype=jnp.float32)
    t_cfg = dataclasses.replace(T_CFG, dtype=torch.float32)
    i = t_cfg.num_time_steps // 2
    assert np.float32(i * t_cfg.duration / t_cfg.num_time_steps) == np.float32(t_cfg.t_plan)
    rng = np.random.default_rng(3)
    qd0 = np.stack([QD0, REGIMES["adaptive"], -REGIMES["cap"]])
    q0 = np.stack([Q0] * 3)
    port = armtd.build_jrs_armtd(_t(q0, torch.float32), _t(qd0, torch.float32), T_ROBOT, t_cfg,
                                 T_BASIS)
    jax_jrs = jax.jit(lambda q, qd: j_armtd.build_jrs_armtd(q, qd, J_ROBOT, j_cfg, J_BASIS))
    tp, ts = t_cfg.t_plan, t_cfg.duration
    for w in range(3):
        jax_j = jax_jrs(jnp.asarray(q0[w], jnp.float32), jnp.asarray(qd0[w], jnp.float32))
        gk = np.minimum(np.maximum(math.pi / 24, np.abs(qd0[w]) / 3), math.pi / 3)
        ks = np.concatenate([rng.uniform(-1, 1, (30, 7)), np.ones((1, 7)), -np.ones((1, 7))])
        for coef, egen, rad in ((port.qdda.coef[w, i].double().numpy(),
                                 port.qdda.egen[w, i].double().numpy(),
                                 port.qdda.rad[w, i].double().numpy()),
                                (np.asarray(jax_j.qdda.coef[i], np.float64),
                                 np.asarray(jax_j.qdda.egen[i], np.float64),
                                 np.asarray(jax_j.qdda.rad[i], np.float64))):
            for k in ks:
                c = coef @ T_BASIS.phi(_t(k)).numpy()
                r = np.abs(egen).sum(-1) + rad
                acc1 = k * gk                                   # phase 1, t -> t_plan
                acc2 = -(qd0[w] + k * gk * tp) / (ts - tp)      # braking from t_plan on
                for acc in (acc1, acc2):
                    assert np.all(np.abs(acc - c) <= r + 1e-5), (w, k, acc - c, r)


def _extrema_case():
    """Three worlds' trajectories and k [3, Q, 7]: k = 0 exactly, |k_act| <
    1e-12, and a slow world whose phase-1 vertex t* = -qd0 / k_act falls
    inside (0, t_plan) for some k and outside for others."""
    qd0 = np.stack([QD0, REGIMES["cap"], np.array([0.02, -0.03, 0.05, -0.01, 0.0, 0.04, -0.06])])
    jrs = armtd.build_jrs_armtd(_t(np.stack([Q0] * 3)), _t(qd0), T_ROBOT, T_CFG, T_BASIS)
    rng = np.random.default_rng(7)
    k = rng.uniform(-1, 1, (3, 40, 7))
    k[:, 0] = 0.0
    k[:, 1] = 1e-14
    k[:, 2] = -1e-13
    return jrs.traj, _t(k)


@pytest.mark.parametrize("kind", ["position", "velocity"])
def test_extrema_match_jax(kind):
    traj, k = _extrema_case()
    port_fn = armtd.armtd_position_extrema if kind == "position" else armtd.armtd_velocity_extrema
    jax_fn = j_armtd.armtd_position_extrema if kind == "position" else j_armtd.armtd_velocity_extrema
    got = port_fn(k, traj, T_CFG)
    # nlp dispatches on the family
    via = (nlp.joint_position_extrema if kind == "position" else nlp.joint_velocity_extrema)(
        k, traj, T_CFG)
    for g, v in zip(got, via):
        assert torch.equal(g, v)
    jax_batch = jax.jit(jax.vmap(lambda kk, jt: jax_fn(kk, jt, J_CFG), in_axes=(0, None)))
    for w in range(3):
        want = jax_batch(jnp.asarray(k[w].numpy()), _jtraj(traj, w))
        for g, x in zip(got, want):
            close(g[w], x, 1e-12)
    if kind == "position":
        k_act = k * traj.k_scale[:, None]
        tstar = -traj.qd0[:, None] / k_act
        inside = (tstar > 0) & (tstar < T_CFG.t_plan) & (k_act.abs() > 1e-12)
        assert bool(inside.any()) and bool((~inside & (k_act.abs() > 1e-12)).any())


def test_plan_cost_gradient_and_hessian_match_jax():
    traj, k = _extrema_case()
    rng = np.random.default_rng(11)
    q_des = _t(traj.q0.numpy() + rng.uniform(-3.5, 3.5, (3, 7)))   # the wrap of continuous joints
    cont = torch.as_tensor(T_ROBOT.continuous_joints)
    cost = nlp.plan_cost(k, traj, q_des, cont, T_CFG)
    grad = nlp.plan_cost_grad(k, traj, q_des, cont, T_CFG)
    hess = nlp.plan_cost_hessian(traj, T_CFG)

    def f(kk, jt, qd):
        return j_nlp.plan_cost(kk, jt, qd, J_ROBOT, J_CFG)

    both = (0, None, None)
    j_cost, j_grad = (jax.jit(jax.vmap(g, in_axes=both)) for g in (f, jax.grad(f)))
    j_hess = jax.jit(jax.hessian(f))
    for w in range(3):
        jt, qd = _jtraj(traj, w), jnp.asarray(q_des[w].numpy())
        kw = jnp.asarray(k[w].numpy())
        close(cost[w], j_cost(kw, jt, qd), 1e-12)
        close(grad[w], j_grad(kw, jt, qd), 1e-12)
        close(hess[w, 0], j_hess(kw[3], jt, qd), 1e-12)


def _refs():
    """Port and JAX plan references: a feasible plan, a braking replay of a
    moving predecessor (NaN k) and a hold at rest (NaN k, qd0 = 0)."""
    rng = np.random.default_rng(4)
    q0, qd0 = Q0, QD0 * 0.5
    k_prev, k1 = rng.uniform(-1, 1, 7), rng.uniform(-1, 1, 7)
    out = {}
    for name, k_new, qd in (("feasible", k1, qd0), ("brake", np.full(7, np.nan), qd0),
                            ("hold", np.full(7, np.nan), np.zeros(7))):
        jref = j_traj.initial_plan(jnp.asarray(q0 - 0.1), jnp.float64)
        tref = trajectory.initial_plan(q0 - 0.1, F64)
        for k, a, b in ((k_prev, q0 - 0.1, qd * 0.8), (k_new, q0, qd)):
            jref = j_traj.advance_plan(jref, jnp.asarray(k), jnp.asarray(a), jnp.asarray(b),
                                       jnp.zeros(7), J_CFG)
            tref = trajectory.advance_plan(tref, _t(k), a, b, np.zeros(7), T_CFG)
        out[name] = (jref, tref)
    return out


TIMES = [0.0, 0.1, 0.25, 0.5, 0.6, 0.75, 1.0, 1.3]


@pytest.mark.parametrize("branch", ["feasible", "brake", "hold"])
def test_desired_state_matches_jax(branch):
    jref, tref = _refs()[branch]
    for f in dataclasses.fields(tref):
        close(getattr(tref, f.name), getattr(jref, f.name), 1e-12)
    vec = trajectory.desired_state(tref, torch.tensor(TIMES, dtype=F64), T_CFG)
    for i, t in enumerate(TIMES):
        want = j_traj.desired_state(jref, t, J_CFG)
        got = trajectory.desired_state(tref, t, T_CFG)
        for g, v, x in zip(got, vec, want):
            close(g, x, 1e-12)
            assert torch.equal(v[i], g)
    if branch == "feasible":
        # the plan ends at rest at t_stop, and holds there
        assert float(trajectory.desired_state(tref, 1.3, T_CFG)[1].abs().max()) < 1e-12


def _jax_problem():
    obs = j_pad(np.array([[0.7, 0.7, 0.5]]), np.diag([0.05] * 3)[None], J_CFG.max_obstacles,
                J_CFG.dtype)
    q0 = jnp.asarray(Q0)
    return q0, jnp.asarray(QD0) * 0.2, q0 + 0.05, obs


def test_plan_step_armtd_matches_jax():
    """tests/test_armtd.py's planning problem: the same feasibility, a cost
    equal or better within 1e-9, the k certified by the port's full-set
    check; make_planner routes cfg.traj_family = "armtd" to the same step."""
    q0, qd0, q_des, obs = _jax_problem()
    want = jax.jit(lambda a, b, d, o: j_armtd.plan_step_armtd(a, b, d, o, J_ROBOT, J_CFG,
                                                              J_BASIS))(q0, qd0, q_des, obs)
    t_obs = stack_obstacles([pad_obstacles(np.array([[0.7, 0.7, 0.5]]), np.diag([0.05] * 3)[None],
                                           T_CFG.max_obstacles, F64)])
    args = [_t(np.asarray(x))[None] for x in (q0, qd0, q_des)]
    got = armtd.plan_step_armtd(*args, t_obs, T_ROBOT, T_CFG, T_BASIS)
    assert bool(got.feasible[0]) == bool(want.feasible) is True
    assert float(got.cost[0]) <= float(want.cost) + 1e-9
    cfg_a = dataclasses.replace(T_CFG, traj_family="armtd")
    prob = plan_problem(args[0], args[1], torch.zeros_like(args[0]), args[2], t_obs, T_ROBOT,
                        cfg_a, T_BASIS)
    assert bool(nlp.is_feasible(got.k[:, None], prob, cfg_a, T_BASIS)[0, 0])
    one = make_planner(T_ROBOT, cfg_a, device="cpu")(
        Q0, np.asarray(qd0), np.full(7, 9.0), np.asarray(q_des),
        pad_obstacles(np.array([[0.7, 0.7, 0.5]]), np.diag([0.05] * 3)[None],
                      T_CFG.max_obstacles, F64))
    assert torch.equal(one.k, got.k[0]) and torch.equal(one.cost, got.cost[0])


def test_unknown_family_raises():
    cfg = dataclasses.replace(T_CFG, traj_family="spline")
    step = make_batch_planner(T_ROBOT, cfg, device="cpu")
    z = np.zeros((1, 7))
    obs = stack_obstacles([pad_obstacles(np.array([[2.5, 2.5, 2.5]]), np.diag([0.05] * 3)[None],
                                         cfg.max_obstacles, F64)])
    with pytest.raises(NotImplementedError, match="spline"):
        step(z, z, z, z, obs)


def _trajectory(k_act, t, q0=Q0, qd0=QD0):
    tp, ts = T_CFG.t_plan, T_CFG.duration
    qd_pk = qd0 + k_act * tp
    brk = -qd_pk / (ts - tp)
    if t <= tp:
        return q0 + qd0 * t + 0.5 * k_act * t * t, qd0 + k_act * t, k_act
    tau = t - tp
    q_pk = q0 + qd0 * tp + 0.5 * k_act * tp * tp
    return q_pk + qd_pk * tau + 0.5 * brk * tau * tau, qd_pk + brk * tau, brk


def test_containment_on_the_port_sets():
    """tests/test_armtd.py's containment on the port's sets: 100 sampled (t,
    k); the true qd and qdd inside the sliced velocity / acceleration sets,
    the true joint-1 rotation inside the sliced R."""
    jrs = armtd.build_jrs_armtd(_t(Q0)[None], _t(QD0)[None], T_ROBOT, T_CFG, T_BASIS)
    gk = armtd.g_k_adaptive(_t(QD0)).numpy()
    rng = np.random.default_rng(0)
    T = T_CFG.num_time_steps
    step = T_CFG.duration / T

    def sliced(p, i, phi):
        return p.coef[0, i].numpy() @ phi, np.abs(p.egen[0, i].numpy()).sum(-1) + p.rad[0, i].numpy()

    for _ in range(100):
        i = int(rng.integers(0, T))
        t = rng.uniform(i * step, (i + 1) * step)
        k = rng.uniform(-1, 1, 7)
        q, qd, qdd = _trajectory(k * gk, t)
        phi = T_BASIS.phi(_t(k)).numpy()
        for p, truth in ((jrs.qd, qd), (jrs.qdda, qdd)):
            c, r = sliced(p, i, phi)
            assert np.all(np.abs(truth - c) <= r + 1e-12), (i, t, truth - c, r)
        c = jrs.R.coef[0, i, 0].numpy() @ phi
        r = np.abs(jrs.R.egen[0, i, 0].numpy()).sum(-1) + jrs.R.rad[0, i, 0].numpy()
        R_true = T_ROBOT.rot_mats[0] @ np.array([[np.cos(q[0]), -np.sin(q[0]), 0],
                                                 [np.sin(q[0]), np.cos(q[0]), 0], [0, 0, 1]])
        assert np.all(np.abs(R_true - c) <= r + 1e-12)


def test_armtd_comparison_mode_writes_both_families(tmp_path):
    """experiments' armtd mode: both families on the same worlds, per family
    the summary, the buckets and the batch_stats; the JAX package's record
    is never written."""
    import json

    from armour_tpu_torch.experiments import run_armtd_comparison

    cfg = ArmourConfig(num_time_steps=8, dtype=F64, max_obstacles=16, screen_k=128,
                       solver_outer_iters=2, solver_inner_iters=2)
    paths = ["saved_worlds/random/scene_013_001.csv"]
    with pytest.raises(ValueError, match="JAX package"):
        run_armtd_comparison(paths, T_ROBOT, cfg, str(tmp_path / "results_armtd_comparison.json"),
                             max_iterations=0, device="cpu")
    out = tmp_path / "armtd.json"
    run_armtd_comparison(paths, T_ROBOT, cfg, str(out), max_iterations=0, device="cpu")
    doc = json.loads(out.read_text())
    assert doc["n_worlds"] == 1 and sorted(doc["families"]) == ["armtd", "bernstein"]
    for fam in doc["families"].values():
        assert fam["summary"]["n_trials"] == 1
        assert list(fam["buckets"]) == ["scene_013_001.csv"]
        assert "rescue_rate" in fam["batch_stats"] and fam["batch_stats"]["guidance"] == "straight"
    assert "provenance" in doc
    for family in ("bernstein", "armtd"):
        full = json.loads((tmp_path / f"armtd.{family}.json").read_text())
        assert [r["world"] for r in full["results"]] == ["scene_013_001.csv"]

"""The PyTorch port's closed loop against the JAX package, float64 on the CPU:
numeric RNEA / FK (1e-10), the reference trajectory on its three branches
(1e-12), the three controllers (1e-10), the tracking rollout in both move
modes (integrate 1e-9, direct exact), the OBB separating-axis test and the
safety oracles (identical booleans), and the RRT* guidance (bit-identical
waypoints).  The CPU branch of the K5/K6 wrappers is the plain version, so
this holds the kernels' references against the JAX package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu import controller as jctl
from armour_tpu import hlp as jhlp
from armour_tpu import rnea_numeric as jrn
from armour_tpu import simulator as jsim
from armour_tpu import trajectory as jtraj
from armour_tpu.collision import pad_obstacles as j_pad
from armour_tpu.config import ArmourConfig as JConfig
from armour_tpu.models.kinova import kinova_gen3 as j_kinova
from armour_tpu.worlds import load_world_csv as j_load
from armour_tpu_torch import controller as tctl
from armour_tpu_torch import convert
from armour_tpu_torch import hlp as thlp
from armour_tpu_torch import rnea_numeric as trn
from armour_tpu_torch import simulator as tsim
from armour_tpu_torch import trajectory as ttraj
from armour_tpu_torch.collision import pad_obstacles, stack_obstacles
from armour_tpu_torch.worlds import load_world_csv

J_ROBOT = j_kinova()
J_CFG = JConfig(num_time_steps=32, dtype=jnp.float64, max_obstacles=8)
T_ROBOT = convert.robot_from_fields({f.name: getattr(J_ROBOT, f.name)
                                     for f in dataclasses.fields(J_ROBOT)})
T_CFG = convert.config_from_fields({f.name: getattr(J_CFG, f.name)
                                    for f in dataclasses.fields(J_CFG)})
Q0 = np.array([0.0, -0.3, 0.0, -1.2, 0.0, -0.8, 0.0])
B = 5


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _states(seed, n=B):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-2.0, 2.0, (n, 7)) for _ in range(4)]


def _params(seed, n=B):
    """Per-state perturbed inertials within the robot's uncertainty (the
    com too, so that the override is exercised)."""
    rng = np.random.default_rng(seed)
    mass = J_ROBOT.mass * (1 + 0.03 * rng.uniform(-1, 1, (n, 7)))
    inertia = J_ROBOT.inertia * (1 + 0.03 * rng.uniform(-1, 1, (n, 7)))[..., None, None]
    com = J_ROBOT.com * (1 + 0.05 * rng.uniform(-1, 1, (n, 7)))[..., None]
    return mass, inertia, com


# ---------------------------------------------------------------------------
# numeric RNEA and FK
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("perturbed", [False, True], ids=["nominal", "perturbed"])
def test_rnea_mass_matrix_bias_match_jax(perturbed):
    q, qd, qa, qdd = _states(1)
    kw_j, kw_t = {}, {}
    if perturbed:
        m, inert, com = _params(2)
        kw_j = dict(mass=jnp.asarray(m), inertia=jnp.asarray(inert), com=jnp.asarray(com))
        kw_t = dict(mass=_t(m), inertia=_t(inert), com=_t(com))
    for grav in (True, False):
        for arm in (True, False):
            want = jrn.rnea(J_ROBOT, *map(jnp.asarray, (q, qd, qa, qdd)), set_gravity=grav,
                            include_armature=arm, **kw_j)
            got = trn.rnea(T_ROBOT, *map(_t, (q, qd, qa, qdd)), set_gravity=grav,
                           include_armature=arm, **kw_t)
            _close(got, want, 1e-10)

    # the JAX mass matrix takes one world's overrides: vmap it
    def j_mm(qq, *p):
        return jrn.mass_matrix(J_ROBOT, qq, **dict(zip(("mass", "inertia", "com"), p)))

    def j_cg(qq, qqd, *p):
        return jrn.coriolis_gravity(J_ROBOT, qq, qqd,
                                    **dict(zip(("mass", "inertia", "com"), p)))

    pj = tuple(kw_j[k] for k in ("mass", "inertia", "com")) if perturbed else ()
    _close(trn.mass_matrix(T_ROBOT, _t(q), **kw_t),
           jax.vmap(j_mm)(jnp.asarray(q), *pj), 1e-10)
    _close(trn.coriolis_gravity(T_ROBOT, _t(q), _t(qd), **kw_t),
           jax.vmap(j_cg)(jnp.asarray(q), jnp.asarray(qd), *pj), 1e-10)


def test_forward_kinematics_matches_jax():
    q = _states(3)[0]
    for got, want in zip(trn.forward_kinematics(T_ROBOT, _t(q)),
                         jrn.forward_kinematics(J_ROBOT, jnp.asarray(q))):
        _close(got, want, 1e-10)


def test_wrench_at_is_not_ported():
    """rnea(wrench_at=) was refused until the grasp path was ported; it now
    returns (tau, f, n) with the wrench after that joint, the JAX package's
    to 1e-10 (the flagship, joint 3, perturbed masses)."""
    q, qd, qa, qdd = _states(1)
    m = _params(2)[0]
    want = jrn.rnea(J_ROBOT, *map(jnp.asarray, (q, qd, qa, qdd)), mass=jnp.asarray(m),
                    wrench_at=3)
    got = trn.rnea(T_ROBOT, *map(_t, (q, qd, qa, qdd)), mass=_t(m), wrench_at=3)
    assert len(got) == 3
    for g, w in zip(got, want):
        _close(g, w, 1e-10)


# ---------------------------------------------------------------------------
# reference trajectory
# ---------------------------------------------------------------------------


def _refs():
    """The feasible, braking and hold branches of one anchor."""
    rng = np.random.default_rng(4)
    q0 = rng.uniform(-1, 1, 7)
    qd0 = rng.uniform(-0.5, 0.5, 7)
    qdd0 = rng.uniform(-0.5, 0.5, 7)
    k = rng.uniform(-1, 1, 7)
    z = np.zeros(7)
    j0 = jtraj.advance_plan(jtraj.initial_plan(q0, jnp.float64), jnp.asarray(k),
                            jnp.asarray(q0), jnp.asarray(qd0), jnp.asarray(qdd0), J_CFG)
    q1, qd1, qdd1 = jtraj.desired_state(j0, J_CFG.t_plan, J_CFG)
    nan = jnp.full(7, jnp.nan)
    return {
        "feasible": j0,
        "brake": jtraj.advance_plan(j0, nan, q1, qd1, qdd1, J_CFG),
        "hold": jtraj.advance_plan(jtraj.initial_plan(q0, jnp.float64), nan,
                                   jnp.asarray(q0), jnp.asarray(z), jnp.asarray(z), J_CFG),
    }


def _to_port(jref):
    return convert.planref_from_numpy(**{f.name: np.asarray(getattr(jref, f.name))
                                         for f in dataclasses.fields(jref)})


TIMES = [0.0, 0.1, 0.25, 0.5, 0.75, 1.0, 1.3]


@pytest.mark.parametrize("branch", ["feasible", "brake", "hold"])
def test_desired_state_matches_jax(branch):
    jref = _refs()[branch]
    tref = _to_port(jref)
    vec = ttraj.desired_state(tref, torch.tensor(TIMES, dtype=torch.float64), T_CFG)
    for i, t in enumerate(TIMES):
        want = jtraj.desired_state(jref, t, J_CFG)
        got = ttraj.desired_state(tref, t, T_CFG)
        for g, v, w in zip(got, vec, want):
            _close(g, w, 1e-12)
            assert torch.equal(v[i], g)
    if branch != "feasible":
        # braking ends at rest; holding never moves
        assert float(ttraj.desired_state(tref, T_CFG.t_plan, T_CFG)[1].abs().max()) < 1e-9


def test_advance_plan_scales_k():
    ref = ttraj.initial_plan(np.zeros(7), torch.float64)
    k = torch.linspace(-1, 1, 7, dtype=torch.float64)
    new = ttraj.advance_plan(ref, k, ref.q0, ref.qd0, ref.qdd0, T_CFG)
    assert torch.equal(new.k_act, k * torch.tensor(T_CFG.k_range, dtype=torch.float64))
    assert torch.equal(new.prev_k_act, ref.k_act)


# ---------------------------------------------------------------------------
# controllers
# ---------------------------------------------------------------------------


def _ctrl_inputs():
    rng = np.random.default_rng(5)
    q_des = rng.uniform(-1.5, 1.5, (B, 7))
    qd_des = rng.uniform(-0.5, 0.5, (B, 7))
    qdd_des = rng.uniform(-0.5, 0.5, (B, 7))
    q = q_des + rng.normal(0, 0.01, (B, 7))
    qd = qd_des + rng.normal(0, 0.02, (B, 7))
    return q, qd, q_des, qd_des, qdd_des


def test_robust_and_nominal_control_match_jax():
    x = _ctrl_inputs()
    want = jax.vmap(lambda *a: jctl.robust_control(J_ROBOT, J_CFG, *a))(*map(jnp.asarray, x))
    got = tctl.robust_control(T_ROBOT, T_CFG, *map(_t, x))
    for g, w in zip(got, want):
        _close(g, w, 1e-10)
    want = jax.vmap(lambda *a: jctl.nominal_passivity_control(J_ROBOT, J_CFG, *a))(
        *map(jnp.asarray, x))
    _close(tctl.nominal_passivity_control(T_ROBOT, T_CFG, *map(_t, x)), want, 1e-10)
    # the perturbation sensitivities keep the JAX layout [2J, ..., F]
    q, qd, q_des, qd_des, qdd_des = x
    pert = tctl._perturbation_taus(T_ROBOT, *map(_t, (q, qd, qd_des, qdd_des)))
    want = jax.vmap(lambda *a: jctl._perturbation_taus(J_ROBOT, *a), out_axes=1)(
        *map(jnp.asarray, (q, qd, qd_des, qdd_des)))
    _close(pert, want, 1e-10)


def test_althoff_control_matches_jax():
    x = _ctrl_inputs()
    e_acc = np.array([0.0, 1e-3, 0.02, 0.5, 0.0])
    want = jax.vmap(lambda *a: jctl.althoff_control(J_ROBOT, J_CFG, *a[:5], a[5], 2e-3))(
        *map(jnp.asarray, x), jnp.asarray(e_acc))
    got = tctl.althoff_control(T_ROBOT, T_CFG, *map(_t, x), _t(e_acc), 2e-3)
    for g, w in zip(got, want):
        _close(g, w, 1e-10)


# ---------------------------------------------------------------------------
# rollout
# ---------------------------------------------------------------------------


def _plans(ks):
    """One feasible plan per k from Q0 at rest (the JAX refs and the port's
    stacked PlanRef)."""
    jrefs = [jtraj.advance_plan(jtraj.initial_plan(Q0, jnp.float64), jnp.full(7, k),
                                jnp.asarray(Q0), jnp.zeros(7), jnp.zeros(7), J_CFG)
             for k in ks]
    fields = [f.name for f in dataclasses.fields(jrefs[0])]
    tref = convert.planref_from_numpy(**{n: np.stack([np.asarray(getattr(r, n))
                                                      for r in jrefs]) for n in fields})
    return jrefs, tref


def _true_params(n):
    tp = jsim.sample_true_params(J_ROBOT, np.random.default_rng(0), scale=1.0)
    return tp, convert.true_params_from_numpy(
        *(np.broadcast_to(np.asarray(getattr(tp, f)), (n,) + np.shape(getattr(tp, f)))
          for f in ("mass", "inertia", "com")))


@pytest.mark.parametrize("controller", ["robust", "althoff"])
def test_rollout_integrate_matches_jax(controller):
    ks = (0.5, -0.7)
    jrefs, tref = _plans(ks)
    jtp, ttp = _true_params(len(ks))
    jroll = jsim.make_rollout(J_ROBOT, J_CFG, control_dt=2e-3, controller=controller)
    troll = tsim.make_rollout(T_ROBOT, T_CFG, control_dt=2e-3, controller=controller,
                              device="cpu")
    q0 = np.stack([Q0, Q0])
    q, qd, logs = troll(q0, np.zeros_like(q0), tref, ttp)
    assert logs["q"].shape == (2, 250, 7)
    for w, jref in enumerate(jrefs):
        jq, jqd, jlogs = jroll(jnp.asarray(Q0), jnp.zeros(7), jref, jtp)
        _close(q[w], jq, 1e-9)
        _close(qd[w], jqd, 1e-9)
        for name in ("q", "qd", "u", "q_des", "qd_des"):
            _close(logs[name][w], jlogs[name], 1e-9)
    if controller == "robust":
        # worst-case model error stays inside the ultimate bound
        assert float((logs["q"] - logs["q_des"]).abs().max()) <= T_CFG.ub.qe
        assert float((logs["qd"] - logs["qd_des"]).abs().max()) <= T_CFG.ub.qde


def test_rollout_direct_matches_jax():
    """Direct mode moves exactly along the reference with zero input.  The
    port's logs equal its own desired_state bit for bit; against the JAX
    package they agree to the last ulp or two (XLA folds the Bezier's
    constant divisions into other roundings), so that comparison is at
    1e-15."""
    jrefs, tref = _plans((0.4,))
    jtp, ttp = _true_params(1)
    jq, jqd, jlogs = jsim.make_rollout(J_ROBOT, J_CFG, control_dt=5e-3, move_mode="direct")(
        jnp.asarray(Q0), jnp.zeros(7), jrefs[0], jtp)
    q, qd, logs = tsim.make_rollout(T_ROBOT, T_CFG, control_dt=5e-3, move_mode="direct",
                                    device="cpu")(Q0[None], np.zeros((1, 7)), tref, ttp)
    _close(q[0], jq, 1e-15)
    _close(qd[0], jqd, 1e-15)
    for name in ("q", "qd", "u", "q_des", "qd_des"):
        _close(logs[name][0], jlogs[name], 1e-15)
    assert torch.equal(logs["q"], logs["q_des"]) and torch.equal(logs["qd"], logs["qd_des"])
    assert not bool(logs["u"].any())
    times = torch.arange(1, 101, dtype=torch.float64) * 5e-3
    want = ttraj.desired_state(tref, times, T_CFG)
    assert torch.equal(logs["q"], want[0]) and torch.equal(logs["qd"], want[1])
    q_end, qd_end, _ = ttraj.desired_state(tref, T_CFG.t_plan, T_CFG)
    assert torch.equal(q, q_end) and torch.equal(qd, qd_end)


def test_measurement_noise_keeps_ultimate_bound():
    """1e-4 encoder-scale noise on the measured state (drawn from the
    port's own generator) keeps the robust controller inside the bound."""
    _, tref = _plans((0.5,))
    _, ttp = _true_params(1)
    roll = tsim.make_rollout(T_ROBOT, T_CFG, control_dt=2e-3, measurement_noise=1e-4,
                             device="cpu")
    _, _, logs = roll(Q0[None], np.zeros((1, 7)), tref, ttp)
    _, _, clean = tsim.make_rollout(T_ROBOT, T_CFG, control_dt=2e-3, device="cpu")(
        Q0[None], np.zeros((1, 7)), tref, ttp)
    assert not torch.equal(logs["u"], clean["u"])
    assert float((logs["q"] - logs["q_des"]).abs().max()) <= T_CFG.ub.qe
    assert float((logs["qd"] - logs["qd_des"]).abs().max()) <= T_CFG.ub.qde


def test_sample_true_params_matches_jax():
    for scale in (None, 1.0, -0.5):
        j = jsim.sample_true_params(J_ROBOT, np.random.default_rng(3), scale=scale)
        t = tsim.sample_true_params(T_ROBOT, np.random.default_rng(3), scale=scale)
        for f in ("mass", "inertia", "com"):
            np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))


# ---------------------------------------------------------------------------
# safety oracles
# ---------------------------------------------------------------------------


def _random_boxes(rng, n):
    def rot():
        a = rng.normal(size=(n, 3, 3))
        qm, _ = np.linalg.qr(a)
        return qm
    ca = rng.uniform(-0.5, 0.5, (n, 3))
    cb = rng.uniform(-0.5, 0.5, (n, 3))
    ha = rng.uniform(0.01, 0.3, (n, 3))
    hb = rng.uniform(0.01, 0.3, (n, 3))
    ra, rb = rot(), rot()
    # a few axis-aligned pairs: parallel edges make the cross axes degenerate
    ra[: n // 8] = np.eye(3)
    rb[: n // 8] = np.eye(3)
    return ca, ra, ha, cb, rb, hb


def test_obb_obb_separated_matches_jax():
    boxes = _random_boxes(np.random.default_rng(6), 4000)
    want = np.asarray(jsim.obb_obb_separated(*map(jnp.asarray, boxes)))
    got = tsim.obb_obb_separated(*map(_t, boxes)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.1 < want.mean() < 0.9
    # the margin decides the same way
    margin = tsim.sat_margin(*map(_t, boxes)).numpy()
    np.testing.assert_array_equal(margin > 0, want)


def test_obstacle_axes_halves_matches_jax():
    rng = np.random.default_rng(7)
    g = rng.normal(size=(6, 3, 3))
    g[2, :, 1] = 0.0                      # a degenerate generator
    for got, want in zip(tsim.obstacle_axes_halves(_t(g)),
                         jsim.obstacle_axes_halves(jnp.asarray(g))):
        _close(got, want, 1e-12)


def _logs_near(rng, n_steps=12):
    """Logged states around Q0 (one world per row of a [W, n, F] batch),
    some beyond the limits and bounds so that every flag fires somewhere."""
    W = 4
    q = Q0 + rng.normal(0, 0.2, (W, n_steps, 7))
    logs = {"q": q, "qd": rng.normal(0, 0.3, (W, n_steps, 7)),
            "u": rng.normal(0, 10.0, (W, n_steps, 7)),
            "q_des": q + rng.normal(0, 0.004, (W, n_steps, 7)),
            "qd_des": rng.normal(0, 0.3, (W, n_steps, 7))}
    logs["qd_des"] = logs["qd"] + rng.normal(0, 0.02, (W, n_steps, 7))
    logs["u"][1, 3, 4] = 40.0              # over world 1's torque limit
    logs["q"][2, 5, 1] = 2.5               # past world 2's joint limit
    logs["q_des"][3] = logs["q"][3]        # world 3 inside the bound
    logs["qd_des"][3] = logs["qd"][3]
    return logs


def test_oracles_match_jax():
    rng = np.random.default_rng(8)
    logs = _logs_near(rng)
    W = logs["q"].shape[0]
    _, _, link_c = jrn.forward_kinematics(J_ROBOT, jnp.asarray(Q0))
    link_c = np.asarray(link_c)
    obs_j, obs_t = [], []
    for w in range(W):
        th = rng.uniform(0, np.pi)
        R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
        centers = np.concatenate([link_c[[w + 1]] + rng.normal(0, 0.1, (1, 3)),
                                  rng.uniform(-1, 1, (3, 3))])
        gens = np.stack([R @ np.diag(rng.uniform(0.02, 0.1, 3)) for _ in range(4)])
        obs_j.append(j_pad(centers, gens, J_CFG.max_obstacles, jnp.float64))
        obs_t.append(pad_obstacles(centers, gens, T_CFG.max_obstacles, torch.float64))
    j_check = jsim.make_oracles(J_ROBOT, J_CFG)
    t_flags, t_overlaps = tsim.oracle_check_plain(
        T_ROBOT, T_CFG, {k: _t(v) for k, v in logs.items()}, stack_obstacles(obs_t))
    t_dict = tsim.make_oracles(T_ROBOT, T_CFG, device="cpu")(logs, stack_obstacles(obs_t))
    for w in range(W):
        want = j_check({k: jnp.asarray(v[w]) for k, v in logs.items()}, obs_j[w])
        for j, name in enumerate(tsim.ORACLE_FLAGS):
            assert bool(t_flags[w, j]) == bool(want[name]), (w, name)
            assert bool(t_dict[name][w]) == bool(want[name]), (w, name)
        # the overlap count against the JAX separating-axis test
        R_w, _, centers = jrn.forward_kinematics(J_ROBOT, jnp.asarray(logs["q"][w]))
        axes, half = jsim.obstacle_axes_halves(obs_j[w].generators)
        sep = jsim.obb_obb_separated(
            centers[:, :, None], R_w[:, :, None],
            jnp.broadcast_to(jnp.asarray(J_ROBOT.link_generators)[None, :, None],
                             centers[:, :, None].shape),
            obs_j[w].centers[None, None], axes[None, None], half[None, None])
        assert int(t_overlaps[w]) == int(np.sum(~np.asarray(sep) & np.asarray(obs_j[w].mask)))
    assert t_flags.any(0).all(), "every flag fires on some world"
    assert int(t_overlaps.sum()) > 0


def test_oracles_match_jax_on_degenerate_axes():
    """The two branches of the separating-axis test that kernel K6 keeps:
    obstacles with a zero generator (its axis becomes the coordinate axis,
    half extent 0) and link axes parallel to obstacle axes (link frames at
    q = 0 are axis-aligned, as are these boxes), where a cross-product axis
    has norm <= 1e-9 and is skipped.  Flags and overlap counts equal the
    JAX oracles'."""
    rng = np.random.default_rng(11)
    W, n = 3, 6
    q = np.zeros((W, n, 7))
    q[:, n // 2:] = Q0 + rng.normal(0, 0.1, (W, n - n // 2, 7))
    zeros = np.zeros_like(q)
    logs = {"q": q, "qd": zeros, "u": zeros, "q_des": q.copy(), "qd_des": zeros}
    _, _, link_c = jrn.forward_kinematics(J_ROBOT, jnp.zeros(7))
    link_c = np.asarray(link_c)
    obs_j, obs_t = [], []
    for w in range(W):
        h = rng.uniform(0.03, 0.1, (4, 3))
        h[:, w] = 0.0                                   # a zero generator: axis w
        gens = np.stack([np.diag(x) for x in h])
        offsets = np.array([[0.0, 0.0, 0.0], [0.02 * (w + 1), 0.0, 0.0], [0.0, 0.3, 0.0],
                            [0.6, 0.6, 0.6]])
        centers = link_c[2 * w + 1] + offsets
        obs_j.append(j_pad(centers, gens, J_CFG.max_obstacles, jnp.float64))
        obs_t.append(pad_obstacles(centers, gens, T_CFG.max_obstacles, torch.float64))
    obs = stack_obstacles(obs_t)
    # a cross axis of norm <= 1e-9 occurs: link axis x obstacle axis at q = 0
    R_w, _, _ = trn.forward_kinematics(T_ROBOT, _t(q[:, 0]))
    axes, half = tsim.obstacle_axes_halves(obs.generators)
    link_axes = R_w.transpose(-1, -2)[:, :, None, :, None, :]      # [W, J, 1, 3, 1, 3]
    obs_axes = axes.transpose(-1, -2)[:, None, :, None, :, :]      # [W, 1, O, 1, 3, 3]
    cross = torch.linalg.cross(*torch.broadcast_tensors(link_axes, obs_axes), dim=-1)
    assert float(torch.linalg.vector_norm(cross[:, :, :4], dim=-1).min()) <= 1e-9
    assert bool((half[:, :4] == 0).any(-1).all())
    t_flags, t_overlaps = tsim.oracle_check_plain(
        T_ROBOT, T_CFG, {k: _t(v) for k, v in logs.items()}, obs)
    j_check = jsim.make_oracles(J_ROBOT, J_CFG)
    for w in range(W):
        want = j_check({k: jnp.asarray(v[w]) for k, v in logs.items()}, obs_j[w])
        for j, name in enumerate(tsim.ORACLE_FLAGS):
            assert bool(t_flags[w, j]) == bool(want[name]), (w, name)
        R_j, _, centers = jrn.forward_kinematics(J_ROBOT, jnp.asarray(q[w]))
        axes_j, half_j = jsim.obstacle_axes_halves(obs_j[w].generators)
        sep = jsim.obb_obb_separated(
            centers[:, :, None], R_j[:, :, None],
            jnp.broadcast_to(jnp.asarray(J_ROBOT.link_generators)[None, :, None],
                             centers[:, :, None].shape),
            obs_j[w].centers[None, None], axes_j[None, None], half_j[None, None])
        assert int(t_overlaps[w]) == int(np.sum(~np.asarray(sep) & np.asarray(obs_j[w].mask)))
    assert 0 < int(t_overlaps.sum()) < W * n * 7 * 4
    assert bool(t_flags[:, 0].all())


def test_oracle_detects_rotated_obstacle_collision():
    """A rotated slab that overlaps a link only through its off-diagonal
    generators is a collision; the same slab far away is not."""
    q = torch.as_tensor(Q0)
    _, _, centers = trn.forward_kinematics(T_ROBOT, q)
    c_link = centers[3].numpy()
    th = np.pi / 4
    R = np.array([[np.cos(th), -np.sin(th), 0.0], [np.sin(th), np.cos(th), 0.0],
                  [0.0, 0.0, 1.0]])
    G = R @ np.diag([0.4, 0.01, 0.01])
    center = c_link + R @ np.array([0.35, 0.0, 0.0])
    check = tsim.make_oracles(T_ROBOT, T_CFG, device="cpu")
    z = torch.zeros(1, 1, 7, dtype=torch.float64)
    logs = {"q": q[None, None], "qd": z, "u": z, "q_des": q[None, None], "qd_des": z}
    near = stack_obstacles([pad_obstacles(center[None], G[None], 8, torch.float64)])
    far = stack_obstacles([pad_obstacles((center + 5.0)[None], G[None], 8, torch.float64)])
    assert bool(check(logs, near)["collision"][0])
    assert not bool(check(logs, far)["collision"][0])


# ---------------------------------------------------------------------------
# guidance
# ---------------------------------------------------------------------------


SCENE = "saved_worlds/random/scene_040_003.csv"


def _walk(j_hlp, t_hlp, qs):
    for q in qs:
        np.testing.assert_array_equal(t_hlp.get_waypoint(q), j_hlp.get_waypoint(q))


def test_config_rrt_star_waypoints_bit_identical():
    jw, tw = j_load(SCENE), load_world_csv(SCENE)
    j_hlp = jhlp.ConfigRRTStarHLP(jw, J_ROBOT, seed=7919, max_nodes=300)
    t_hlp = thlp.ConfigRRTStarHLP(tw, T_ROBOT, seed=7919, max_nodes=300)
    qs = [jw.start + 0.05 * i * (jw.goal - jw.start) for i in range(4)]
    _walk(j_hlp, t_hlp, qs)
    np.testing.assert_array_equal(t_hlp._path, j_hlp._path)


def test_end_effector_rrt_star_waypoints_bit_identical():
    jw, tw = j_load(SCENE), load_world_csv(SCENE)
    j_hlp = jhlp.EndEffectorRRTStarHLP(jw, J_ROBOT, lookahead=0.1, seed=3, max_nodes=150)
    t_hlp = thlp.EndEffectorRRTStarHLP(tw, T_ROBOT, lookahead=0.1, seed=3, max_nodes=150)
    qs = [jw.start + 0.03 * i * (jw.goal - jw.start) for i in range(3)]
    _walk(j_hlp, t_hlp, qs)
    np.testing.assert_array_equal(thlp.ee_position(T_ROBOT, qs[1]),
                                  jhlp.ee_position(J_ROBOT, qs[1]))

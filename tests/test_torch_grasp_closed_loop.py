"""The grasp path's closed loop: the Kinova with the dumbbell payload (J = 9
bodies, F = 7 factors, the last two bodies on fixed joints) planning with
its contact rows, the waiter's-tray trial of tests/test_grasp.py:194-227.

CPU, float64: the port's run_trial against the JAX package's on the tray
world and the same worst-case true parameters for 2 iterations, each move
cut to 50 control steps of 10 ms, one RK4 step each, under the nominal
controller (every summary field but the host's planning times exact, the
goal distances and the state after each move at 1e-9); the whole
8-iteration trial at 1 kHz under the robust controller through the
port alone (slow), which must reach the goal with no safety flag.  JAX is
imported inside the CPU tests only, so that the card can run this file
(python3 -m pytest --noconftest tests/test_torch_grasp_closed_loop.py -m cuda).

Card: K5 (rollout) and K6 (oracle_check) at (J, F) = (9, 7) against their
plain versions (they skip where there is no card)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from armour_tpu_torch import simulator as tsim
from armour_tpu_torch.collision import ObstacleSet, pad_obstacles
from armour_tpu_torch.config import ArmourConfig, derive_ultimate_bound
from armour_tpu_torch.controller import ALTHOFF_DEFAULT
from armour_tpu_torch.kernels import sim as ksim
from armour_tpu_torch.models import zoo
from armour_tpu_torch.planner import make_planner
from armour_tpu_torch.worlds import World

ROBOT = zoo.kinova_dumbbell()
F, J = ROBOT.num_factors, ROBOT.num_joints
START = np.linspace(-0.3, 0.3, F)
# the tray trial's configuration (tests/test_grasp.py:203-209)
TRAY = dict(num_time_steps=16, max_obstacles=8, screen_k=256, grasp_constraints=True,
            grasp_mu=1.5, grasp_support_radius=0.5)
OBS_C = np.array([[2.0, 2.0, 2.0]])
OBS_G = np.stack([np.diag([0.05] * 3)])
# the parity case's moves: 50 control steps of 10 ms, one RK4 step each,
# under the nominal controller (the robust one at J = 9 is held against the
# JAX package's in tests/test_torch_closed_loop.py)
PARITY_MOVE = dict(control_dt=1e-2, substeps=1, controller="nominal")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small: one torch thread each, so that the
    six workers of a full run do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _ub():
    """The tray trial's ultimate bound: V_max 5e-4 (tests/test_grasp.py:206)."""
    return derive_ultimate_bound(ROBOT, v_max=5e-4)


def _tray_world(cls):
    return cls(start=START, goal=START + 0.12, obstacle_centers=OBS_C,
               obstacle_generators=OBS_G)


class _Recorded:
    """A rollout that keeps the state after each move (numpy, no worlds
    axis)."""

    def __init__(self, rollout):
        self.rollout, self.states = rollout, []

    def __call__(self, q, qd, ref, tp):
        q, qd, logs = self.rollout(q, qd, ref, tp)
        self.states.append((np.asarray(q).reshape(-1), np.asarray(qd).reshape(-1)))
        return q, qd, logs


def test_tray_trial_matches_jax():
    """Two iterations of the tray trial in both packages on the CPU, from
    one JAX configuration (the port's ultimate bound handed to both), with
    PARITY_MOVE's moves: the JAX planner's compile (~35 s on one core) and
    its rollout's (~9 s; ~25 s with the robust controller and two RK4
    steps) set the test's time."""
    import jax.numpy as jnp

    from armour_tpu import simulator as jsim
    from armour_tpu.collision import pad_obstacles as j_pad
    from armour_tpu.config import ArmourConfig as JConfig, UltimateBound as JUltimateBound
    from armour_tpu.models import zoo as j_zoo
    from armour_tpu.planner import make_planner as j_make_planner
    from armour_tpu.worlds import World as JWorld
    from armour_tpu_torch import convert

    jr = j_zoo.load_zoo_robot("kinova_dumbbell")
    jcfg = JConfig.for_robot(jr, derive_ub=False,
                             ub=JUltimateBound(**dataclasses.asdict(_ub())),
                             dtype=jnp.float64, **TRAY)
    cfg = convert.config_from_fields({f.name: getattr(jcfg, f.name)
                                      for f in dataclasses.fields(jcfg)})
    assert cfg.grasp_constraints and cfg.ub == _ub() and cfg.dtype == torch.float64
    tp_j = jsim.sample_true_params(jr, np.random.default_rng(0), scale=1.0)
    tp_t = tsim.sample_true_params(ROBOT, np.random.default_rng(0), scale=1.0)

    j_roll = _Recorded(jsim.make_rollout(jr, jcfg, **PARITY_MOVE))
    j_obs = j_pad(OBS_C, OBS_G, jcfg.max_obstacles, jcfg.dtype)
    want = jsim.run_trial(_tray_world(JWorld), jr, jcfg, j_make_planner(jr, jcfg), j_obs, tp_j,
                          max_iterations=2, rollout=j_roll)
    t_roll = _Recorded(tsim.make_rollout(ROBOT, cfg, device="cpu", **PARITY_MOVE))
    obs = pad_obstacles(OBS_C, OBS_G, cfg.max_obstacles, cfg.dtype)
    got = tsim.run_trial(_tray_world(World), ROBOT, cfg, make_planner(ROBOT, cfg, device="cpu"),
                         obs, tp_t, max_iterations=2, rollout=t_roll, device="cpu")

    for f in dataclasses.fields(tsim.TrialSummary):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if f.name == "planning_times":
            assert len(b) == len(a) == got.iterations
        elif f.name.startswith("goal_distance"):
            assert abs(b - a) <= 1e-9, (f.name, a, b)
        else:
            assert b == a, (f.name, a, b)
    assert got.iterations == 2 and not got.infeasible_plans
    assert len(t_roll.states) == len(j_roll.states) == 2
    for (q, qd), (jq, jqd) in zip(t_roll.states, j_roll.states):
        np.testing.assert_allclose(q, jq, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(qd, jqd, rtol=1e-9, atol=1e-9)


@pytest.mark.slow
def test_tray_trial_reaches_the_goal():
    """The port's tests/test_grasp.py:test_grasp_closed_loop_tray_trial: 8
    iterations from the tray world's start, no safety oracle fires and the
    goal is reached."""
    cfg = ArmourConfig.for_robot(ROBOT, derive_ub=False, ub=_ub(), dtype=torch.float64, **TRAY)
    obs = pad_obstacles(OBS_C, OBS_G, cfg.max_obstacles, cfg.dtype)
    tp = tsim.sample_true_params(ROBOT, np.random.default_rng(0), scale=1.0)
    summary = tsim.run_trial(_tray_world(World), ROBOT, cfg,
                             make_planner(ROBOT, cfg, device="cpu"), obs, tp,
                             max_iterations=8, device="cpu")
    assert not summary.collision
    assert not summary.torque_exceeded
    assert not summary.ultimate_bound_exceeded
    assert not summary.joint_limit_exceeded
    assert summary.goal_reached, summary


# ---------------------------------------------------------------------------
# K5 / K6 at (J, F) = (9, 7) on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels are built with nvcc there)")
    return torch.device("cuda")


def _f32(x, dev):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev).contiguous()


@pytest.mark.cuda
def test_k5_matches_its_plain_version_at_nine_joints():
    """A 60-step move of three worlds of the dumbbell under each controller
    (and the robust one with measurement noise): |dq| <= 1e-4 rad, |dqd| <=
    1e-3 rad/s, |du| <= 1e-4 (|u| + 1), and the same bits on a second call."""
    dev = _card()
    cfg = ArmourConfig.for_robot(ROBOT, derive_ub=False, ub=_ub(), dtype=torch.float32)
    rng = np.random.default_rng(0)
    Wn, n = 3, 60
    q = _f32(START + rng.uniform(-0.3, 0.3, (Wn, F)), dev)
    qd = _f32(rng.uniform(-0.1, 0.1, (Wn, F)), dev)
    t = np.arange(n) * 1e-3
    amp = [rng.uniform(-1, 1, (Wn, 1, F)) for _ in range(3)]
    q_des = _f32(q.cpu().numpy()[:, None] + 0.05 * np.sin(3 * t)[None, :, None] * amp[0], dev)
    qd_des = _f32(0.15 * np.cos(3 * t)[None, :, None] * amp[1], dev)
    qdd_des = _f32(-0.45 * np.sin(3 * t)[None, :, None] * amp[2], dev)
    tps = [tsim.sample_true_params(ROBOT, rng, scale=1.0) for _ in range(Wn)]
    tp = tsim.TrueParams(*(_f32(np.stack([getattr(x, a).numpy() for x in tps]), dev)
                           for a in ("mass", "inertia", "com")))
    noise = _f32(1e-4 * rng.standard_normal((Wn, n, 2, F)), dev)
    assert ksim.k5_geometry(J, F) == 64
    for controller, nz in (("robust", None), ("althoff", None), ("nominal", None),
                           ("robust", noise)):
        a = (ROBOT, cfg, q, qd, q_des, qd_des, qdd_des, tp, 1e-3, 2, controller, nz,
             ALTHOFF_DEFAULT)
        got, again = ksim.rollout(*a), ksim.rollout(*a)
        ref = tsim.rollout_plain(*a)
        assert all(torch.equal(x, y) for x, y in zip(got, again)), controller
        assert all(bool(torch.isfinite(x).all()) for x in got), controller
        assert float((got[2] - ref[2]).abs().max()) <= 1e-4, controller
        assert float((got[3] - ref[3]).abs().max()) <= 1e-3, controller
        assert ((got[4] - ref[4]).abs() <= 1e-4 * (ref[4].abs() + 1.0)).all(), controller


@pytest.mark.cuda
def test_k6_matches_its_plain_version_at_nine_joints():
    """Logged dumbbell states with obstacles around every body's logged box
    centre (the two after the fixed joints included) and planted torque,
    bound and joint-limit faults: flags identical to oracle_check_plain's,
    overlap counts equal up to the triples whose deciding margin lies
    within 1e-5 m, overlaps on the bodies after the fixed joints, and the
    same bits under other grid splits."""
    dev = _card()
    cfg = ArmourConfig.for_robot(ROBOT, derive_ub=False, ub=_ub(), dtype=torch.float32)
    rng = np.random.default_rng(5)
    Wn, N, O = 4, 70, 12
    q = START + rng.uniform(-0.3, 0.3, (Wn, 1, F)) \
        + 0.3 * np.linspace(0, 1, N)[None, :, None] * rng.uniform(-1, 1, (Wn, 1, F))
    qd = 0.3 * rng.uniform(-1, 1, (Wn, N, F))
    logs = dict(q=_f32(q, dev), qd=_f32(qd, dev), u=_f32(5 * rng.uniform(-1, 1, (Wn, N, F)), dev),
                q_des=_f32(q + 1e-4 * rng.standard_normal((Wn, N, F)), dev),
                qd_des=_f32(qd + 1e-3 * rng.standard_normal((Wn, N, F)), dev))
    # inside the tray bound (qe 2.2e-3 rad, qde 2.2e-2 rad/s) where no fault is planted
    R_w, link_c, link_h = tsim._link_boxes(ROBOT, logs["q"])
    assert link_c.shape[2] == J
    centers, gens = np.zeros((Wn, O, 3)), np.zeros((Wn, O, 3, 3))
    for w in range(Wn):
        for o in range(O):
            centers[w, o] = link_c[w, rng.integers(0, N), o % J].cpu().numpy() \
                + rng.uniform(-0.1, 0.1, 3)
            A = np.eye(3) if o % 3 == 0 else np.linalg.qr(rng.standard_normal((3, 3)))[0]
            gens[w, o] = A * rng.uniform(0.02, 0.1, 3)[None, :]
    centers, gens = _f32(centers, dev), _f32(gens, dev)
    mask = torch.as_tensor(rng.uniform(size=(Wn, O)) > 0.2).to(dev)
    lim = torch.as_tensor(ROBOT.torque_limits, dtype=torch.float32, device=dev)
    ub = torch.as_tensor(ROBOT.position_limits_ub, dtype=torch.float32, device=dev)
    copies = [(None, logs)]
    for flag in (1, 2, 3):
        x = {k: v.clone() for k, v in logs.items()}
        if flag == 1:
            x["u"][1] *= 1.01 / float((x["u"][1].abs() / lim).max())
        elif flag == 2:
            x["q_des"][1, N // 2, 3] += 1.5 * cfg.ub.qe
        else:
            x["q"][1, N // 3, int(torch.argmin(ub))] = ub.min() + 0.01
        copies.append((flag, x))
    default = ksim.k6_geometry
    obs = ObstacleSet(centers=centers, generators=gens, mask=mask)
    for flag, x in copies:
        args = (ROBOT, cfg, x["q"], x["qd"], x["u"], x["q_des"], x["qd_des"], centers, gens,
                mask)
        got = ksim.oracle_check(*args)
        fp, op = tsim.oracle_check_plain(ROBOT, cfg, x, obs)
        R_w, lc, lh = tsim._link_boxes(ROBOT, x["q"])
        axes, half = tsim.obstacle_axes_halves(gens)
        margin = tsim.sat_margin(lc[:, :, :, None], R_w[:, :, :, None], lh[:, None],
                                 centers[:, None, None], axes[:, None, None],
                                 half[:, None, None])
        amb = ((margin.abs() <= 1e-5) & mask[:, None, None]).flatten(1).sum(-1)
        assert torch.equal(got[0], fp), flag
        assert bool(((got[1] - op).abs() <= amb).all()), flag
        overlap = (margin <= 0) & mask[:, None, None]                  # [W, N, J, O]
        assert bool(overlap[:, :, F:].any()), "no overlap on the bodies past the fixed joints"
        if flag is not None:
            assert bool(fp[1, flag]) and not bool(fp[0, flag])
        try:
            for splits in (1, 3, ksim.K6_MAXSPLIT):
                geo = default(Wn, N)
                ksim.k6_geometry = lambda *a, g=dataclasses.replace(
                    geo, splits=splits, grid=Wn * geo.chunks * splits), **k: g
                again = ksim.oracle_check(*args)
                assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1]), splits
        finally:
            ksim.k6_geometry = default

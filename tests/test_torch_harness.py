"""The rest of the port's harness against the JAX package, on the CPU:
world generation (byte for byte), LazyPRM (the same waypoints and paths),
the controller sweep's bookkeeping, the serial world suite with its resume
and replay traces, and the batched suite's resume and second pass.

The serial suite runs once per module, at test_torch_batch_sim.py's config
(num_time_steps 16, four obstacle slots, three iterations, worst-case true
parameters, float64) on that file's two worlds, and one traced trial of
its first world; the resume and trace tests read those runs.  The runs that compile a JAX planner or rollout (the serial
suite, a traced trial and the sweep against the JAX package's) are marked
slow."""

import dataclasses
import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu import experiments as jexp
from armour_tpu import hlp as jhlp
from armour_tpu import simulator as jsim
from armour_tpu.config import ArmourConfig as JConfig
from armour_tpu.models.kinova import kinova_gen3 as j_kinova
from armour_tpu.worlds import World as JWorld
from armour_tpu_torch import batch_sim as tbs
from armour_tpu_torch import convert
from armour_tpu_torch import experiments as texp
from armour_tpu_torch import hlp as thlp
from armour_tpu_torch import planner as tplanner
from armour_tpu_torch import simulator as tsim
from armour_tpu_torch import worlds as tworlds
from armour_tpu_torch.config import ArmourConfig
from armour_tpu_torch.simulator import TrialSummary

J_ROBOT = j_kinova()
J_CFG = JConfig(num_time_steps=16, dtype=jnp.float64, max_obstacles=4,
                screen_k=512, solver_outer_iters=4, solver_inner_iters=4)
T_ROBOT = convert.robot_from_fields({f.name: getattr(J_ROBOT, f.name)
                                     for f in dataclasses.fields(J_ROBOT)})
T_CFG = convert.config_from_fields({f.name: getattr(J_CFG, f.name)
                                    for f in dataclasses.fields(J_CFG)})
Q0 = np.array([0.0, -0.3, 0.0, -1.2, 0.0, -0.8, 0.0])
ITERS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _worlds(cls):
    """test_torch_batch_sim.py's two worlds."""
    far = np.array([[0.9, 0.9, 0.5]])
    g = np.diag([0.05, 0.05, 0.05])[None]
    return [cls(start=Q0, goal=Q0 + 0.1, obstacle_centers=far, obstacle_generators=g),
            cls(start=Q0 + 0.05, goal=Q0 - 0.08, obstacle_centers=far + 0.2,
                obstacle_generators=g)]


def _write_worlds(d):
    os.makedirs(d, exist_ok=True)
    paths = []
    for i, w in enumerate(_worlds(tworlds.World)):
        paths.append(os.path.join(d, f"w{i}.csv"))
        tworlds.save_world_csv(w, paths[-1])
    return paths


# ---------------------------------------------------------------------------
# world generation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_generated_suite_is_the_jax_files(tmp_path, seed):
    """generate_world_suite for counts (13, 40), two worlds a count: the
    port's files are the JAX package's, byte for byte."""
    jp = jexp.generate_world_suite(str(tmp_path / "j"), J_ROBOT, counts=(13, 40),
                                   per_count=2, seed=seed)
    tp = texp.generate_world_suite(str(tmp_path / "t"), T_ROBOT, counts=(13, 40),
                                   per_count=2, seed=seed)
    assert [os.path.basename(p) for p in tp] == [os.path.basename(p) for p in jp]
    assert len(tp) == 4
    for a, b in zip(jp, tp):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fb.read() == fa.read(), b


def test_random_world_round_trips_through_its_csv(tmp_path):
    w = tworlds.random_world(np.random.default_rng(5), T_ROBOT, 13)
    assert w.num_obstacles == 13
    path = str(tmp_path / "w.csv")
    tworlds.save_world_csv(w, path)
    back = tworlds.load_world_csv(path)
    for f in ("start", "goal", "obstacle_centers", "obstacle_generators"):
        np.testing.assert_allclose(getattr(back, f), getattr(w, f), rtol=1e-5, atol=1e-6)
    tworlds.save_world_csv(back, str(tmp_path / "again.csv"))
    assert (tmp_path / "again.csv").read_bytes() == (tmp_path / "w.csv").read_bytes()


def test_random_world_keeps_its_clearance():
    """Every obstacle clears every link centre of start and goal by more
    than min_clearance (the rejection rule), as in the JAX package."""
    w = tworlds.random_world(np.random.default_rng(1), T_ROBOT, 20)
    jw = jexp.random_world(np.random.default_rng(1), J_ROBOT, 20)
    np.testing.assert_array_equal(w.obstacle_centers, jw.obstacle_centers)
    pts = np.concatenate([tworlds._arm_sphere_centers(T_ROBOT, w.start),
                          tworlds._arm_sphere_centers(T_ROBOT, w.goal)])
    sides = 2.0 * np.stack([np.diag(g) for g in w.obstacle_generators])
    for p in pts:
        assert np.all(tworlds._aabb_clearance(p, w.obstacle_centers, sides) > 0.15)


# ---------------------------------------------------------------------------
# LazyPRM
# ---------------------------------------------------------------------------


def _hlp_world(cls, robot_ee, kind):
    """The worlds of tests/test_hlp.py's three LazyPRM tests."""
    start = np.zeros(7)
    if kind == "open_space":
        return cls(start=start, goal=np.full(7, 0.4), obstacle_centers=np.zeros((0, 3)),
                   obstacle_generators=np.zeros((0, 3, 3))), 0.15, 3
    goal = np.array([1.2, 0.4, 0.0, 0.4, 0.0, 0.3, 0.0])
    if kind == "lookahead":
        return cls(start=start, goal=goal, obstacle_centers=np.zeros((0, 3)),
                   obstacle_generators=np.zeros((0, 3, 3))), 0.1, 6
    mid = 0.5 * (robot_ee(start) + robot_ee(goal))
    return cls(start=start, goal=goal, obstacle_centers=mid[None],
               obstacle_generators=np.diag([0.05, 0.05, 0.05])[None]), 0.15, 2


@pytest.mark.parametrize("kind", ["lookahead", "obstacle", "open_space"])
def test_lazy_prm_matches_jax(kind):
    """The same roadmap path and the same waypoints along a short walk."""
    jw, look, seed = _hlp_world(JWorld, lambda q: jhlp.ee_position(J_ROBOT, q), kind)
    tw, _, _ = _hlp_world(tworlds.World, lambda q: thlp.ee_position(T_ROBOT, q), kind)
    jp = jhlp.LazyPRMHLP(jw, J_ROBOT, lookahead=look, seed=seed)
    tp = thlp.LazyPRMHLP(tw, T_ROBOT, lookahead=look, seed=seed)
    q = np.zeros(7)
    for _ in range(3):
        wj, wt = jp.get_waypoint(q), tp.get_waypoint(q)
        np.testing.assert_array_equal(wt, wj)
        q = wt
    np.testing.assert_array_equal(tp._path, jp._path)


# ---------------------------------------------------------------------------
# the controller sweep
# ---------------------------------------------------------------------------

# a 50-step move keeps the CPU rollout short
SWEEP_CFG = ArmourConfig(dtype=torch.float64, t_plan=0.05)


def test_sweep_bookkeeping_matches_a_hand_assembled_rollout(tmp_path):
    """One level, one controller, two samples: the sweep's numbers are the
    maxima and mean of one make_rollout call on the same draws."""
    from armour_tpu_torch.trajectory import advance_plan, initial_plan

    path = tmp_path / "sweep.json"
    out = texp.robust_controller_sweep(T_ROBOT, SWEEP_CFG, (0.1,), ("nominal",), 2, seed=4,
                                       results_path=str(path), device="cpu")
    rng = np.random.default_rng(4)
    F, J = 7, T_ROBOT.num_joints
    qa, qda = rng.uniform(-np.pi / 2, np.pi / 2, (2, F)), rng.uniform(-0.3, 0.3, (2, F))
    dq = rng.normal(size=(2, F))
    dq = 0.025 * np.pi * dq / np.linalg.norm(dq, axis=1, keepdims=True)
    dqd = rng.normal(size=(2, F))
    dqd = 0.05 * np.pi * dqd / np.linalg.norm(dqd, axis=1, keepdims=True)
    ks = rng.uniform(-1, 1, (2, F))
    t = torch.as_tensor
    refs = advance_plan(initial_plan(t(qa), torch.float64), t(ks), t(qa), t(qda),
                        torch.zeros(2, F, dtype=torch.float64), SWEEP_CFG)
    robot_u = dataclasses.replace(T_ROBOT, mass_uncertainty=0.1, inertia_uncertainty=0.1)
    tp = tsim.TrueParams(mass=t(np.tile(T_ROBOT.mass * 1.1, (2, 1))),
                         inertia=t(np.tile(T_ROBOT.inertia * 1.1, (2, 1, 1, 1))),
                         com=t(np.tile(T_ROBOT.com, (2, 1, 1))))
    roll = tsim.make_rollout(robot_u, SWEEP_CFG, controller="nominal", device="cpu")
    _, _, logs = roll(t(qa + dq), t(qda + dqd), refs, tp)
    assert logs["q"].shape == (2, 50, F)
    rec = out["controllers"]["nominal"]
    assert rec == {"max_pos_err": [float((logs["q"] - logs["q_des"]).abs().max())],
                   "max_vel_err": [float((logs["qd"] - logs["qd_des"]).abs().max())],
                   "mean_abs_u": [float(logs["u"].abs().mean())]}
    doc = json.loads(path.read_text())
    assert doc["uncertainties"] == [0.1] and doc["n_samples"] == 2
    assert doc["controllers"] == out["controllers"] and "provenance" in doc
    with open("results_controller_sweep.json") as f:
        assert set(json.load(f)) <= set(doc)
    with pytest.raises(ValueError, match="JAX package's record"):
        texp.robust_controller_sweep(T_ROBOT, SWEEP_CFG, (0.1,), ("nominal",), 2,
                                     results_path="results_controller_sweep.json",
                                     device="cpu")


# ---------------------------------------------------------------------------
# the serial suite, its resume and its traces
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def serial(tmp_path_factory):
    d = tmp_path_factory.mktemp("serial")
    paths = _write_worlds(str(d / "worlds"))
    res_path = str(d / "results.json")
    stats = {}
    results = texp.run_world_suite(paths, T_ROBOT, T_CFG, ITERS, 1.0, 0, False, res_path,
                                   device="cpu", stats=stats)
    return paths, res_path, results, stats


@pytest.fixture(scope="module")
def traced(serial, tmp_path_factory):
    """run_trial(trace_path=) on world 0 with the suite's planners, true
    parameters (default_rng((0, 0))) and iteration cap: (summary, path)."""
    from armour_tpu_torch.collision import pad_obstacles

    paths = serial[0]
    w = tworlds.load_world_csv(paths[0])
    obs = pad_obstacles(w.obstacle_centers, w.obstacle_generators, T_CFG.max_obstacles,
                        T_CFG.dtype)
    tp = tsim.sample_true_params(T_ROBOT, np.random.default_rng((0, 0)), scale=1.0)
    path = str(tmp_path_factory.mktemp("trace") / "w0.npz")
    s = tsim.run_trial(w, T_ROBOT, T_CFG, tplanner.make_planner(T_ROBOT, T_CFG, device="cpu"),
                       obs, tp, ITERS,
                       rescue_step=tplanner.make_rescue_planner(T_ROBOT, T_CFG, device="cpu"),
                       trace_path=path, device="cpu")
    return s, path


def test_serial_suite_writes_every_world(serial):
    paths, res_path, results, stats = serial
    assert [r.world for r in results] == ["w0.csv", "w1.csv"]
    with open(res_path) as f:
        doc = json.load(f)
    assert [d["world"] for d in doc["results"]] == ["w0.csv", "w1.csv"]
    assert [d["bucket"] for d in doc["results"]] == [r.bucket() for r in results]
    for r in results:
        s = r.summary
        assert 1 <= s.iterations <= ITERS and len(s.planning_times) == s.iterations
        rec = stats[r.world]
        assert len(rec["iterations"]) == s.iterations
        assert all(x["move_s"] > 0 and x["oracles_s"] > 0 for x in rec["iterations"])
        assert rec["wall_s"] >= sum(x["plan_s"] + x["move_s"] for x in rec["iterations"])


def test_fully_resumed_serial_call_never_plans(serial, monkeypatch):
    paths, res_path, results, _ = serial

    def boom(*a, **k):
        raise AssertionError("a fully resumed suite built or ran a planner")

    for mod, name in ((tplanner, "make_planner"), (tplanner, "make_rescue_planner"),
                      (tsim, "run_trial"), (tsim, "make_rollout")):
        monkeypatch.setattr(mod, name, boom)
    again = texp.run_world_suite(paths, T_ROBOT, T_CFG, ITERS, 1.0, 0, False, res_path,
                                 resume=True, device="cpu")
    assert [r.world for r in again] == [r.world for r in results]
    for a, b in zip(again, results):
        assert a.summary == b.summary


def test_partial_serial_resume_gives_the_fresh_run(serial, tmp_path):
    """World 0 dropped from the results file: the resumed call runs it
    alone (with world 0's true parameters, default_rng((seed, 0))) and gives
    the fresh run's record."""
    paths, res_path, results, _ = serial
    with open(res_path) as f:
        doc = json.load(f)
    doc["results"] = [d for d in doc["results"] if d["world"] != "w0.csv"]
    part = tmp_path / "part.json"
    part.write_text(json.dumps(doc))
    stats = {}
    resumed = texp.run_world_suite(paths, T_ROBOT, T_CFG, ITERS, 1.0, 0, False, str(part),
                                   resume=True, device="cpu", stats=stats)
    assert list(stats) == ["w0.csv"]
    assert [r.world for r in resumed] == [r.world for r in results]
    for a, b in zip(resumed, results):
        assert a.bucket() == b.bucket()
        assert a.summary.iterations == b.summary.iterations
        assert a.summary.infeasible_plans == b.summary.infeasible_plans
        assert a.summary.goal_distance_final == b.summary.goal_distance_final


def _jax_writer_trace(path, iterations, robot_name):
    """The JAX package's writer (armour_tpu.simulator.run_trial) driven by
    stand-in planner, rollout and oracles for `iterations` iterations: its
    keys, dtypes and shapes, with no JAX planner compiled."""
    w = _worlds(JWorld)[0]
    n = int(round(J_CFG.t_plan / 1e-3))

    class Res:
        k = jnp.zeros(7)
        viol = jnp.zeros(4)

    def step(*a):
        return Res()

    def rollout(q, qd, ref, tp):
        z = jnp.zeros((n, 7))
        return q, qd, {"q": z + q, "qd": z, "u": z, "q_des": z, "qd_des": z}

    def oracles(logs, obs):
        return {k: False for k in ("collision", "torque_exceeded", "ultimate_bound_exceeded",
                                   "joint_limit_exceeded")}

    robot = dataclasses.replace(J_ROBOT, name=robot_name)
    jsim.run_trial(w, robot, J_CFG, step, None, None, max_iterations=iterations,
                   rollout=rollout, oracles=oracles, trace_path=path)
    return np.load(path)


def test_trace_has_the_jax_layout(traced, tmp_path):
    s, path = traced
    tr = np.load(path)
    jt = _jax_writer_trace(str(tmp_path / "j.npz"), s.iterations, T_ROBOT.name)
    assert sorted(tr.files) == sorted(jt.files)
    for key in jt.files:
        assert tr[key].dtype == jt[key].dtype, key
        assert tr[key].shape == jt[key].shape, key
    assert tr["k"].shape[0] == s.iterations
    assert tr["q"].shape == (s.iterations, 50, 7)
    assert tr["trace_dt"] == jt["trace_dt"] and str(tr["robot_name"]) == T_ROBOT.name


def test_traced_trial_is_the_serial_suites_and_agrees_with_its_trace(serial, traced):
    """The traced trial gives the serial suite's record of world 0 (the
    same planners, true parameters and cap), and its trace agrees with
    that summary."""
    paths, _, results, _ = serial
    s, path = traced
    assert dataclasses.replace(s, planning_times=results[0].summary.planning_times) \
        == results[0].summary
    tr = np.load(path)
    assert tr["feasible"].shape == (s.iterations,)
    assert int((~tr["feasible"]).sum()) == s.infeasible_plans
    assert tr["flags"].tolist() == [s.collision, s.torque_exceeded, s.ultimate_bound_exceeded,
                                    s.joint_limit_exceeded, s.goal_reached, s.stuck]
    w = tworlds.load_world_csv(paths[0])
    np.testing.assert_array_equal(tr["start"], w.start)
    np.testing.assert_array_equal(tr["obstacle_centers"], w.obstacle_centers)
    assert np.all(np.isfinite(tr["q"])) and np.all(np.isfinite(tr["u"]))


# ---------------------------------------------------------------------------
# the batched suite's resume and second pass (run_trials_batched stood in)
# ---------------------------------------------------------------------------


def _summary(goal, stuck=False, collision=False, it=3):
    return TrialSummary(goal_reached=goal, collision=collision, torque_exceeded=False,
                        ultimate_bound_exceeded=False, joint_limit_exceeded=False,
                        infeasible_plans=0, iterations=it, planning_times=[0.1] * it,
                        stuck=stuck)


def test_batched_resume_and_second_pass_take_jax_positions(tmp_path, monkeypatch):
    """resume is the 12th positional parameter and second_pass the 13th:
    a partial resume runs the missing world as a sub-batch with the full
    run's true-parameter indices; the second pass retries only the stuck
    worlds and swaps in only a safe goal-reaching retry."""
    paths = _write_worlds(str(tmp_path / "worlds")) + [str(tmp_path / "worlds/w2.csv")]
    tworlds.save_world_csv(_worlds(tworlds.World)[1], paths[2])
    res_path = str(tmp_path / "r.json")
    texp.save_results([texp.SuiteResult("w1.csv", _summary(True))], res_path)
    calls = []

    def fake(worlds, robot, cfg, **kw):
        calls.append(kw)
        if len(calls) == 1:          # the main run: w0 and w2, both stuck
            return [_summary(False, stuck=True), _summary(False, stuck=True)]
        return [_summary(True, it=5), _summary(True, collision=True)]   # the retry

    monkeypatch.setattr(tbs, "run_trials_batched", fake)
    out = texp.run_world_suite_batched(paths, T_ROBOT, T_CFG, 3, 1.0, 0, False, res_path,
                                       None, True, "straight", True,
                                       {"stall_window": 5}, device="cpu")
    assert calls[0]["tp_indices"] == [0, 2] and calls[0]["tp_total"] == 3
    assert calls[1]["tp_indices"] == [0, 2] and calls[1]["tp_total"] == 3
    assert calls[1]["stall_window"] == 5
    assert [r.bucket() for r in out] == ["goal", "goal", "stuck"]
    assert out[0].summary.iterations == 5
    doc = json.loads(open(res_path).read())
    sp = doc["batch_stats"]["second_pass"]
    assert sp["attempted"] == 2 and sp["recovered"] == ["w0.csv"]
    assert doc["batch_stats"]["resumed_worlds"] == 1
    # every world done: nothing runs
    calls.clear()
    again = texp.run_world_suite_batched(paths, T_ROBOT, T_CFG, 3, 1.0, 0, False, res_path,
                                         None, True, "straight", True, device="cpu")
    assert calls == [] and [r.bucket() for r in again] == ["goal", "goal", "stuck"]


def test_command_line_serial_sweep_and_generate(tmp_path, monkeypatch):
    seen = {}

    def fake_suite(paths, robot, cfg, **kw):
        seen["serial"] = (len(paths), kw)
        return [texp.SuiteResult(os.path.basename(p), _summary(True)) for p in paths]

    def fake_sweep(robot, cfg, **kw):
        seen["sweep"] = kw
        return {"controllers": {}}

    monkeypatch.setattr(texp, "run_world_suite", fake_suite)
    monkeypatch.setattr(texp, "robust_controller_sweep", fake_sweep)
    texp.main(["saved_worlds/random", "2", str(tmp_path / "s.json"), "serial", "--resume",
               "--device", "cpu"])
    n, kw = seen["serial"]
    assert n == 2 and kw["resume"] and kw["device"] == "cpu"
    texp.main(["-", "0", str(tmp_path / "sw.json"), "sweep", "--device", "cpu"])
    assert seen["sweep"]["results_path"] == str(tmp_path / "sw.json")
    texp.main([str(tmp_path / "gen"), "0", "-", "generate", "--seed", "3"])
    files = sorted(glob.glob(str(tmp_path / "gen" / "*.csv")))
    assert len(files) == 100 and os.path.basename(files[0]) == "scene_013_001.csv"


# ---------------------------------------------------------------------------
# against the JAX package's own runs (slow: they compile a JAX planner or
# rollout)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_serial_suite_matches_jax(serial):
    """armour_tpu.experiments.run_world_suite on the same worlds and
    config: every summary field but the host-clock planning times, the goal
    distances to 1e-9."""
    paths, _, results, _ = serial
    jr = jexp.run_world_suite(paths, J_ROBOT, J_CFG, ITERS, 1.0, 0, False)
    for a, b in zip(jr, results):
        for f in dataclasses.fields(TrialSummary):
            x, y = getattr(a.summary, f.name), getattr(b.summary, f.name)
            if f.name == "planning_times":
                continue
            if f.name.startswith("goal_distance"):
                assert abs(x - y) <= 1e-9, f.name
            else:
                assert x == y, f.name


@pytest.mark.slow
def test_trace_matches_jax_run_trial(traced, tmp_path):
    """JAX run_trial(trace_path=) on world 0 with the suite's true
    parameters: every array of the two traces to 1e-9."""
    from armour_tpu.collision import pad_obstacles
    from armour_tpu.planner import make_planner, make_rescue_planner

    w = _worlds(JWorld)[0]
    obs = pad_obstacles(w.obstacle_centers, w.obstacle_generators, J_CFG.max_obstacles,
                        J_CFG.dtype)
    tp = jsim.sample_true_params(J_ROBOT, np.random.default_rng((0, 0)), scale=1.0)
    path = str(tmp_path / "j.npz")
    jsim.run_trial(w, J_ROBOT, J_CFG, make_planner(J_ROBOT, J_CFG), obs, tp,
                   max_iterations=ITERS, rescue_step=make_rescue_planner(J_ROBOT, J_CFG),
                   trace_path=path)
    jt, tr = np.load(path), np.load(traced[1])
    for key in jt.files:
        if jt[key].dtype.kind == "f":
            np.testing.assert_allclose(tr[key], jt[key], rtol=1e-9, atol=1e-9, err_msg=key)
        else:
            np.testing.assert_array_equal(tr[key], jt[key], err_msg=key)


@pytest.mark.slow
def test_sweep_matches_jax_at_one_level():
    """The JAX package's sweep at one level, all three controllers, four
    samples, float64: every number to 1e-9 relative."""
    jcfg = JConfig(dtype=jnp.float64, t_plan=0.05)
    jo = jexp.robust_controller_sweep(J_ROBOT, jcfg, (0.15,), n_samples=4, seed=2)
    to = texp.robust_controller_sweep(T_ROBOT, SWEEP_CFG, (0.15,), n_samples=4, seed=2,
                                      device="cpu")
    for c in ("robust", "althoff", "nominal"):
        for key, v in jo["controllers"][c].items():
            np.testing.assert_allclose(to["controllers"][c][key], v, rtol=1e-9, err_msg=key)


@pytest.mark.slow
def test_replay_script_renders_a_port_trace(traced, tmp_path):
    """scripts/replay_trial.py reads only the file: it renders the port's
    trace as it renders the JAX package's (slow: a subprocess that imports
    JAX and draws with matplotlib)."""
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "scripts/replay_trial.py", traced[1],
                          str(tmp_path / "w0"), "4"],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert (tmp_path / "w0_replay.png").exists() and (tmp_path / "w0_errors.png").exists()

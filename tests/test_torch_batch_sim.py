"""The port's lockstep closed loop against the JAX package, float64 on the
CPU: run_trials_batched on test_batch_sim.py's two worlds and config
(num_time_steps = 16, max_obstacles = 4, three iterations, straight-line
guidance with the rescue solver, worst-case true parameters), one run per
package.  Every TrialSummary field agrees except planning_times (host
clock); the two goal distances, computed from the rolled-out state, to
1e-9.  The batch economics, the suite buckets and the serial run_trial
agree too; the port's per-world trace agrees with its summaries."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu import batch_sim as jbs
from armour_tpu import experiments as jexp
from armour_tpu.config import ArmourConfig as JConfig
from armour_tpu.models.kinova import kinova_gen3 as j_kinova
from armour_tpu.worlds import World as JWorld
from armour_tpu_torch import batch_sim as tbs
from armour_tpu_torch import convert
from armour_tpu_torch import experiments as texp
from armour_tpu_torch.collision import pad_obstacles
from armour_tpu_torch.planner import make_planner
from armour_tpu_torch.simulator import TrialSummary, run_trial, sample_true_params
from armour_tpu_torch.worlds import World as TWorld

J_ROBOT = j_kinova()
J_CFG = JConfig(num_time_steps=16, dtype=jnp.float64, max_obstacles=4,
                screen_k=512, solver_outer_iters=4, solver_inner_iters=4)
T_ROBOT = convert.robot_from_fields({f.name: getattr(J_ROBOT, f.name)
                                     for f in dataclasses.fields(J_ROBOT)})
T_CFG = convert.config_from_fields({f.name: getattr(J_CFG, f.name)
                                    for f in dataclasses.fields(J_CFG)})
Q0 = np.array([0.0, -0.3, 0.0, -1.2, 0.0, -0.8, 0.0])
ITERS = 3


def _worlds(cls):
    far = np.array([[0.9, 0.9, 0.5]])
    g = np.diag([0.05, 0.05, 0.05])[None]
    return [cls(start=Q0, goal=Q0 + 0.1, obstacle_centers=far, obstacle_generators=g),
            cls(start=Q0 + 0.05, goal=Q0 - 0.08, obstacle_centers=far + 0.2,
                obstacle_generators=g)]


@pytest.fixture(scope="module")
def runs():
    j_stats, t_stats = {}, {}
    j = jbs.run_trials_batched(_worlds(JWorld), J_ROBOT, J_CFG, max_iterations=ITERS,
                               true_param_scale=1.0, seed=0, stats=j_stats)
    t = tbs.run_trials_batched(_worlds(TWorld), T_ROBOT, T_CFG, max_iterations=ITERS,
                               true_param_scale=1.0, seed=0, stats=t_stats, device="cpu")
    return j, t, j_stats, t_stats


@pytest.fixture(scope="module")
def traced():
    """The port's run again with both worlds traced."""
    stats = {}
    t = tbs.run_trials_batched(_worlds(TWorld), T_ROBOT, T_CFG, max_iterations=ITERS,
                               true_param_scale=1.0, seed=0, stats=stats, device="cpu",
                               trace=(0, 1))
    return t, stats


EXACT = [f.name for f in dataclasses.fields(TrialSummary)
         if f.name not in ("planning_times", "goal_distance_final", "goal_distance_min")]


@pytest.mark.parametrize("field", EXACT)
def test_summary_field_matches_jax(runs, field):
    j, t, _, _ = runs
    for a, b in zip(j, t):
        assert getattr(b, field) == getattr(a, field), (field, a, b)


@pytest.mark.parametrize("field", ["goal_distance_final", "goal_distance_min"])
def test_goal_distances_match_jax(runs, field):
    j, t, _, _ = runs
    for a, b in zip(j, t):
        assert abs(getattr(b, field) - getattr(a, field)) <= 1e-9, (field, a, b)


def test_tracing_leaves_the_run_unchanged(runs, traced):
    _, t, _, _ = runs
    for a, b in zip(t, traced[0]):
        assert dataclasses.replace(b, planning_times=a.planning_times) == a


def test_trace_records_every_iteration(traced):
    """The per-world trace agrees with the summaries it explains."""
    t, t_stats = traced
    for i, b in enumerate(t):
        rec = t_stats["trace"][str(i)]
        assert [r["it"] for r in rec] == list(range(b.iterations))
        assert rec[-1]["gd"] == b.goal_distance_final
        assert min(r["gd"] for r in rec) == b.goal_distance_min
        assert sum(not r["feasible"] for r in rec) == b.infeasible_plans
        assert sum(r["rescued"] for r in rec) == b.rescued_plans
        for r in rec:
            assert r["guidance"] in ("straight", "retreat") or r["guidance"].startswith("rrt#")
            assert len(r["k"]) == len(r["q0"]) == len(r["waypoint"]) == len(r["q"]) == 7
            assert r["gd_min"] <= r["gd"] and r["stall_count"] >= 0


def test_planning_times_one_per_iteration(runs):
    _, t, _, _ = runs
    for b in t:
        assert len(b.planning_times) == b.iterations
        assert all(x >= 0 for x in b.planning_times)


def test_batch_economics_match_jax(runs):
    _, _, js, ts = runs
    for key in ("batch_iterations", "rescue_iterations", "rescue_rate", "rescued_rows",
                "recovered_rows", "planning_time_semantics"):
        assert ts[key] == js[key], key
    assert len(ts["iterations"]) == ts["batch_iterations"]
    for rec in ts["iterations"]:
        assert rec["iteration_s"] >= rec["plan_s"] + rec["rollout_s"] + rec["oracles_s"]


def test_suite_summary_matches_jax(runs, tmp_path):
    """summarize and the results file over the same trial summaries."""
    import json

    j, t, _, _ = runs
    jr = [jexp.SuiteResult(world=f"w{i}.csv", summary=s) for i, s in enumerate(j)]
    tr = [texp.SuiteResult(world=f"w{i}.csv", summary=s) for i, s in enumerate(t)]
    assert [r.bucket() for r in tr] == [r.bucket() for r in jr]
    js, ts = jexp.summarize(jr), texp.summarize(tr)
    for key in set(js) | set(ts):
        if "planning_time" not in key:
            assert ts[key] == pytest.approx(js[key], rel=1e-9, abs=1e-9), key
    path = tmp_path / "results.json"
    texp.save_results(tr, str(path), batch_stats={"rescue_solver": True})
    doc = json.loads(path.read_text())
    assert [d["bucket"] for d in doc["results"]] == [r.bucket() for r in jr]
    assert doc["summary"]["n_trials"] == 2 and doc["provenance"]["device"] == "cpu"


def test_suite_command_line_writes_the_results_file(runs, tmp_path, monkeypatch):
    """The module's command line: world directory, world count, results
    path; the suite driver's arguments and the saved batch stats (the
    lockstep run itself is the fixture's)."""
    import json

    from armour_tpu_torch import batch_sim

    _, t, _, t_stats = runs
    seen = {}

    def fake(worlds, robot, cfg, **kw):
        seen.update(kw, n=len(worlds), dtype=cfg.dtype)
        kw["stats"].update(t_stats)
        return t

    monkeypatch.setattr(batch_sim, "run_trials_batched", fake)
    path = tmp_path / "suite.json"
    texp.main(["saved_worlds/random", "2", str(path), "--seed", "3", "--device", "cpu"])
    assert seen["n"] == 2 and seen["dtype"] == torch.float32
    assert (seen["seed"], seen["device"], seen["rescue_solver"], seen["guidance"],
            seen["true_param_scale"]) == (3, "cpu", True, "straight", 1.0)
    doc = json.loads(path.read_text())
    assert [d["world"] for d in doc["results"]] == ["scene_013_001.csv", "scene_013_002.csv"]
    assert doc["batch_stats"]["rescue_solver"] is True
    assert doc["batch_stats"]["guidance"] == "straight"
    assert doc["batch_stats"]["batch_iterations"] == t_stats["batch_iterations"]
    assert doc["batch_stats"]["suite_wall_s"] >= 0


def test_stack_worlds_and_true_params_match_jax():
    js, jg, jo = jbs.stack_worlds(_worlds(JWorld), J_CFG)
    ts, tg, to = tbs.stack_worlds(_worlds(TWorld), T_CFG)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tg, jg)
    for f in ("centers", "generators", "mask"):
        np.testing.assert_array_equal(getattr(to, f).numpy(), np.asarray(getattr(jo, f)))
    for scale in (1.0, None):
        a = jbs._batched_true_params(J_ROBOT, np.random.default_rng(2), 5, scale,
                                     indices=[1, 3], total=5)
        b = tbs._batched_true_params(T_ROBOT, np.random.default_rng(2), 5, scale,
                                     indices=[1, 3], total=5)
        for f in ("mass", "inertia", "com"):
            np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)))


def test_serial_trial_matches_batched(runs):
    """run_trial on world 0 with the same true parameters lands in the
    batched run's bucket, after as many iterations (the batched run never
    needs its rescue solver here, so the serial trial runs without one)."""
    _, t, _, _ = runs
    w = _worlds(TWorld)[0]
    obs = pad_obstacles(w.obstacle_centers, w.obstacle_generators, T_CFG.max_obstacles,
                        torch.float64)
    tp = sample_true_params(T_ROBOT, np.random.default_rng(0), scale=1.0)
    s = run_trial(w, T_ROBOT, T_CFG, make_planner(T_ROBOT, T_CFG, device="cpu"), obs, tp,
                  max_iterations=ITERS, device="cpu")
    assert t[0].rescued_plans == 0
    for field in ("goal_reached", "collision", "torque_exceeded", "ultimate_bound_exceeded",
                  "joint_limit_exceeded", "iterations", "infeasible_plans", "stuck"):
        assert getattr(s, field) == getattr(t[0], field), field
    assert abs(s.goal_distance_final - t[0].goal_distance_final) <= 1e-9

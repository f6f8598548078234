"""The port's stuck-tail lab (armour_tpu_torch.scripts.stuck_lab) against
the JAX script scripts/stuck_lab.py: its variant table and its
run_trials_batched call parsed out of the script, the stuck selection and
suite indices from a results file written here, the STUCK_LAB_VARIANTS
filter, and one real run at a reduced config (T = 16, O = 8, K = 256,
float64, two worlds, 3 iterations, two variants) against the JAX
package's run_trials_batched with the same arguments (its planner compiled
once for both variants: a pure function of the robot and the config)."""

import ast
import dataclasses
import io
import json
import os
import tempfile
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu import batch_sim as j_bs
from armour_tpu.config import ArmourConfig as JConfig
from armour_tpu.models.kinova import kinova_gen3 as j_kinova
from armour_tpu.worlds import load_world_csv as j_load
from armour_tpu_torch import convert
from armour_tpu_torch.config import ArmourConfig
from armour_tpu_torch.models.kinova import kinova_gen3
from armour_tpu_torch.planner import strong_config
from armour_tpu_torch.scripts import stuck_lab
from armour_tpu_torch.worlds import World, load_world_csv, save_world_csv

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "stuck_lab.py"
J_CFG = JConfig(num_time_steps=16, max_obstacles=8, screen_k=256, dtype=jnp.float64)
CFG = convert.config_from_fields({f.name: getattr(J_CFG, f.name)
                                  for f in dataclasses.fields(J_CFG)})
ITERS = 3
# two variants on one config, so that the JAX package compiles its planner
# once for both (strong_primary's config is held by the stubbed call test)
LAB = ("baseline", "seed1000")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small: one torch thread each, so that the
    six workers of a full run do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _script_main():
    return next(n for n in ast.parse(SCRIPT.read_text()).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def _jax_variants() -> dict:
    """The script's variant table, strong_config(cfg) read as strong_config."""
    node = next(n.value for n in ast.walk(_script_main()) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "variants"
                and isinstance(n.value, ast.Dict))

    def value(v):
        if isinstance(v, ast.Call):
            assert v.func.id == "strong_config" and [a.id for a in v.args] == ["cfg"]
            return strong_config
        if isinstance(v, ast.Dict):
            return {ast.literal_eval(k): value(x) for k, x in zip(v.keys, v.values)}
        return ast.literal_eval(v)

    return value(node)


def _jax_call_keywords() -> dict:
    """The script's run_trials_batched call: {keyword: constant or the name
    of the variable it passes}."""
    call = next(n for n in ast.walk(_script_main()) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "run_trials_batched")
    assert [a.id for a in call.args] == ["worlds", "robot", "vcfg"]
    out = {}
    for kw in call.keywords:
        if kw.arg is None:
            out["**"] = kw.value.id
        elif isinstance(kw.value, ast.Constant):
            out[kw.arg] = kw.value.value
        elif isinstance(kw.value, ast.Name):
            out[kw.arg] = kw.value.id
        else:
            out[kw.arg] = ast.unparse(kw.value)
    return out


def test_variant_table_is_the_jax_scripts():
    want = _jax_variants()
    assert list(stuck_lab.VARIANTS) == list(want)
    assert stuck_lab.VARIANTS == want


def _suite(tmp: Path) -> Path:
    """Three saved scenes cut to their first 8 obstacles; the 2nd and 3rd
    marked stuck."""
    names = ["scene_013_001.csv", "scene_016_009.csv", "scene_019_002.csv"]
    for n in names:
        w = load_world_csv(str(ROOT / "saved_worlds" / "random" / n))
        save_world_csv(World(start=w.start, goal=w.goal, obstacle_centers=w.obstacle_centers[:8],
                             obstacle_generators=w.obstacle_generators[:8]), str(tmp / n))
    results = tmp / "results.json"
    results.write_text(json.dumps({"results": [
        {"world": n, "bucket": b} for n, b in zip(names, ("goal", "stuck", "stuck"))]}))
    return results


def _summary(goal, unsafe=False):
    return SimpleNamespace(goal_reached=goal, collision=unsafe, torque_exceeded=False,
                           ultimate_bound_exceeded=False, joint_limit_exceeded=False)


def test_lab_calls_run_trials_batched_as_the_jax_script(tmp_path, monkeypatch):
    results = _suite(tmp_path)
    calls = []

    def fake(worlds, robot, cfg, **kw):
        calls.append((worlds, cfg, kw))
        return [_summary(True), _summary(False, unsafe=len(calls) == 2)]

    monkeypatch.setattr(stuck_lab, "run_trials_batched", fake)
    report = stuck_lab.run_stuck_lab(str(results), str(tmp_path), kinova_gen3(), CFG,
                                     device="cpu")
    jkw = _jax_call_keywords()
    assert jkw == {"seed": "seed", "guidance": "auto", "rescue_solver": False,
                   "verbose": False, "tp_indices": "idxs", "tp_total": "len(all_names)",
                   "**": "kw"}
    assert list(report) == list(stuck_lab.VARIANTS) and len(calls) == len(stuck_lab.VARIANTS)
    for (worlds, cfg, kw), (name, variant) in zip(calls, stuck_lab.VARIANTS.items()):
        variant = dict(variant)
        want_cfg = variant.pop("cfg", lambda c: c)(CFG)
        assert cfg == want_cfg, name
        assert kw.pop("device") == torch.device("cpu")
        assert set(kw.pop("stats")) == {"wall_s"}   # the stub fills none of it
        assert kw == {"seed": variant.pop("seed", 0), "guidance": "auto", "rescue_solver": False,
                      "verbose": False, "tp_indices": [1, 2], "tp_total": 3, **variant}, name
        assert [w.num_obstacles for w in worlds] == [8, 8]
        assert np.array_equal(worlds[0].start, load_world_csv(
            str(tmp_path / "scene_016_009.csv")).start)
    assert report["baseline"] == {"recovered": ["scene_016_009.csv"], "n": 1, "unsafe": []}
    assert report["seed1000"]["unsafe"] == ["scene_019_002.csv"]


def test_variants_filter_and_report_file(tmp_path, monkeypatch):
    results = _suite(tmp_path)
    seen = []
    monkeypatch.setattr(stuck_lab, "run_trials_batched",
                        lambda worlds, robot, cfg, **kw: seen.append(cfg) or
                        [_summary(False), _summary(True)])
    monkeypatch.setattr(stuck_lab, "resolve_device", lambda d=None: torch.device("cpu"))
    monkeypatch.setenv("STUCK_LAB_VARIANTS", "stop_8,strong_primary,no_such_variant")
    out = tmp_path / "lab.json"
    stuck_lab.main([str(results), str(tmp_path), str(out)])
    report = json.loads(out.read_text())
    assert list(report) == ["strong_primary", "stop_8"]
    assert report["stop_8"] == {"recovered": ["scene_019_002.csv"], "n": 1, "unsafe": []}
    assert seen[0] == strong_config(ArmourConfig(dtype=torch.float32))
    assert seen[1] == ArmourConfig(dtype=torch.float32)


def test_main_defaults_are_the_jax_scripts(monkeypatch):
    got = {}
    monkeypatch.setattr(stuck_lab, "run_stuck_lab",
                        lambda results, world_dir, robot, cfg, **kw: got.update(
                            results=results, world_dir=world_dir, cfg=cfg) or {})
    opened = []
    monkeypatch.setattr(stuck_lab, "open", lambda p, *a, **k: opened.append(p) or io.StringIO(),
                        raising=False)
    monkeypatch.delenv("STUCK_LAB_VARIANTS", raising=False)
    stuck_lab.main([])
    assert (got["results"], got["world_dir"]) == ("results_worlds.json", "saved_worlds/random")
    # the JAX script's default file, under the caller's temporary directory
    assert got["cfg"] == ArmourConfig(dtype=torch.float32)
    assert opened == [os.path.join(tempfile.gettempdir(), "stuck_lab.json")]
    text = SCRIPT.read_text()
    for default in ('"results_worlds.json"', '"saved_worlds/random"', '"/tmp/stuck_lab.json"'):
        assert default in text


def test_lab_defaults_to_the_card(tmp_path):
    results = _suite(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            stuck_lab.run_stuck_lab(str(results), str(tmp_path), kinova_gen3(), CFG)


@pytest.fixture(scope="module")
def lab_runs(tmp_path_factory):
    """(port's report, its summaries, JAX's report, its summaries) of the
    two variants at the reduced config."""
    tmp = tmp_path_factory.mktemp("lab")
    results = _suite(tmp)
    summaries = []
    real = stuck_lab.run_trials_batched
    mp = pytest.MonkeyPatch()
    mp.setattr(stuck_lab, "run_trials_batched",
               lambda *a, **k: summaries.append(real(*a, **k)) or summaries[-1])
    try:
        report = stuck_lab.run_stuck_lab(
            str(results), str(tmp), kinova_gen3(), CFG, device="cpu",
            variants={n: {**stuck_lab.VARIANTS[n], "max_iterations": ITERS} for n in LAB})
    finally:
        mp.undo()
    doc = json.loads(results.read_text())
    names = [r["world"] for r in doc["results"] if r["bucket"] == "stuck"]
    worlds = [j_load(str(tmp / n)) for n in names]
    j_report, j_summaries = {}, []
    planners = {}
    make = j_bs.make_batch_planner
    mp.setattr(j_bs, "make_batch_planner",
               lambda robot, cfg: planners.setdefault(cfg, make(robot, cfg)))
    try:
        for name in LAB:
            kw = dict(stuck_lab.VARIANTS[name])
            seed = kw.pop("seed", 0)
            s = j_bs.run_trials_batched(worlds, j_kinova(), J_CFG, seed=seed, guidance="auto",
                                        rescue_solver=False, verbose=False, tp_indices=[1, 2],
                                        tp_total=3, max_iterations=ITERS, **kw)
            j_summaries.append(s)
            j_report[name] = {
                "recovered": [n for n, x in zip(names, s) if x.goal_reached],
                "n": sum(x.goal_reached for x in s),
                "unsafe": [n for n, x in zip(names, s) if x.collision or x.torque_exceeded
                           or x.ultimate_bound_exceeded or x.joint_limit_exceeded]}
    finally:
        mp.undo()
    assert len(planners) == 1
    return report, summaries, j_report, j_summaries


def test_reduced_lab_matches_jax(lab_runs):
    report, summaries, j_report, j_summaries = lab_runs
    assert report == j_report
    for name, s, js in zip(LAB, summaries, j_summaries):
        assert [x.iterations for x in s] == [x.iterations for x in js], name
        assert [x.infeasible_plans for x in s] == [x.infeasible_plans for x in js], name
        # where the report carries no signal (no world reaches its goal in 3
        # iterations) the states reached do: a wrong plan, move or waypoint
        # shows in the goal distances
        assert [x.blocked_counts for x in s] == [x.blocked_counts for x in js], name
        for field in ("goal_distance_final", "goal_distance_min"):
            got = np.array([getattr(x, field) for x in s])
            want = np.array([getattr(x, field) for x in js])
            assert np.all(np.isfinite(want)), (name, field)
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=0, err_msg=f"{name} {field}")
        assert all(x.iterations == ITERS for x in s) or any(x.goal_reached for x in s), name

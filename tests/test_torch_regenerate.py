"""The port's scene regeneration (armour_tpu_torch.scripts.
regenerate_unsolvable) against the JAX script on copies: three saved
scenes and a written results file (two scenes with a verdict that marks
them impossible, one planner_failure) in two temporary directories; the
JAX script's main runs on one copy, the port's function (its rest-FRS test
on the CPU) on the other.  The scene files and REGENERATED.json must be
equal byte for byte, apart from the results path the sidecar records.
Neither ever runs on saved_worlds/."""

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

from armour_tpu_torch.models.kinova import kinova_gen3
from armour_tpu_torch.scripts.regenerate_unsolvable import IMPOSSIBLE, regenerate_unsolvable

ROOT = Path(__file__).resolve().parent.parent
SCENES = ("scene_013_001.csv", "scene_016_009.csv", "scene_019_002.csv")
VERDICTS = ("static_blocked", "planner_failure", "frs_blocked_goal")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small: one torch thread each, so that the
    six workers of a full run do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_regenerate_unsolvable", ROOT / "scripts" / "regenerate_unsolvable.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _suite(tmp: Path) -> Path:
    tmp.mkdir()
    for name in SCENES:
        shutil.copy(ROOT / "saved_worlds" / "random" / name, tmp / name)
    results = tmp / "results.json"
    results.write_text(json.dumps({"results": [
        {"world": n, "bucket": "stuck", "solvability": {"verdict": v}}
        for n, v in zip(SCENES, VERDICTS)] + [
        {"world": "scene_099_000.csv", "bucket": "goal"}]}))
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("regen")
    j_results, t_results = _suite(base / "jax"), _suite(base / "port")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(sys, "argv", ["regenerate_unsolvable.py", str(j_results),
                                 str(j_results.parent)])
        _jax_script().main()
    finally:
        mp.undo()
    replaced = regenerate_unsolvable(str(t_results), str(t_results.parent), kinova_gen3(),
                                     device="cpu")
    return j_results.parent, t_results.parent, replaced


def test_verdict_set_is_the_jax_scripts():
    text = (ROOT / "scripts" / "regenerate_unsolvable.py").read_text()
    for v in IMPOSSIBLE:
        assert f'"{v}"' in text
    assert set(VERDICTS) - set(IMPOSSIBLE) == {"planner_failure"}


@pytest.mark.parametrize("name", SCENES)
def test_scene_files_are_the_jax_scripts_byte_for_byte(runs, name):
    jdir, tdir, _ = runs
    assert (tdir / name).read_bytes() == (jdir / name).read_bytes()
    replaced = name != SCENES[1]
    original = (ROOT / "saved_worlds" / "random" / name).read_bytes()
    assert ((tdir / name).read_bytes() != original) == replaced


def test_sidecar_is_the_jax_scripts_but_for_the_results_path(runs):
    jdir, tdir, replaced = runs
    j_doc = json.loads((jdir / "REGENERATED.json").read_text())
    t_doc = json.loads((tdir / "REGENERATED.json").read_text())
    assert j_doc["source_results"] == str(jdir / "results.json")
    assert t_doc["source_results"] == str(tdir / "results.json")
    j_text = (jdir / "REGENERATED.json").read_text().replace(str(jdir), "DIR")
    t_text = (tdir / "REGENERATED.json").read_text().replace(str(tdir), "DIR")
    assert t_text == j_text
    assert t_doc["replaced"] == replaced
    assert [r["world"] for r in replaced] == [SCENES[0], SCENES[2]]
    assert [r["verdict"] for r in replaced] == [VERDICTS[0], VERDICTS[2]]

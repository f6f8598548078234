"""The port's cache writer (armour_tpu_torch.scripts.derive_ub_cache)
against the committed models/ub_cache.json of the JAX package, read only:
all seven robots, every numeric field at 1e-9 relative, `certified` and the
waiver exactly, the flatness evidence at 1e-9.  The file goes to a
temporary directory; the JAX script (which writes into armour_tpu/) is never
run."""

import ast
import json
import math
from pathlib import Path

import pytest
import torch

from armour_tpu_torch.scripts import derive_ub_cache

ROOT = Path(__file__).resolve().parent.parent
COMMITTED = ROOT / "armour_tpu" / "models" / "ub_cache.json"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small: one torch thread each, so that the
    six workers of a full run do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    out = tmp_path_factory.mktemp("ub") / "ub_cache.json"
    entries = derive_ub_cache.derive_ub_cache(out=out)
    return entries, out


def _numbers_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _numbers_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, bool) or isinstance(want, str):
        assert got == want, path
    elif isinstance(want, int) and not isinstance(want, bool):
        assert got == want and isinstance(got, int), path
    else:
        assert math.isclose(got, want, rel_tol=1e-9, abs_tol=0.0), (path, got, want)


def test_writer_reproduces_the_committed_cache(written):
    entries, out = written
    want = json.loads(COMMITTED.read_text())
    assert sorted(entries) == sorted(want) and len(want) == 7
    _numbers_close(json.loads(out.read_text()), want)


def test_certified_flags_and_waivers_are_exact(written):
    entries, _ = written
    want = json.loads(COMMITTED.read_text())
    for key, entry in want.items():
        prov, got = entry["provenance"], entries[key]["provenance"]
        assert got["certified"] is prov["certified"], key
        assert got.get("waiver") == prov.get("waiver"), key
        assert ("flatness" in got) == ("flatness" in prov), key
        if not prov["certified"]:
            for k, v in prov["flatness"].items():
                assert math.isclose(got["flatness"][k], v, rel_tol=1e-9), (key, k)


def test_file_layout_is_the_jax_scripts(written):
    """indent 1, sorted keys, one final newline: the committed file's own
    layout, so a regenerated file differs from it only in its digits."""
    _, out = written
    text = out.read_text()
    assert text.endswith("}\n") and not text.endswith("\n\n")
    assert text == json.dumps(json.loads(text), indent=1, sort_keys=True) + "\n"
    committed = COMMITTED.read_text()
    assert committed == json.dumps(json.loads(committed), indent=1, sort_keys=True) + "\n"


def test_waiver_text_is_the_jax_scripts():
    tree = ast.parse((ROOT / "scripts" / "derive_ub_cache.py").read_text())
    waiver = next(ast.literal_eval(n.value) for n in tree.body if isinstance(n, ast.Assign)
                  and any(getattr(t, "id", None) == "WAIVER" for t in n.targets))
    assert derive_ub_cache.WAIVER == waiver

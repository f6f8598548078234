"""The port's bench (armour_tpu_torch/bench.py) against the root bench.py:
the same planning instances (scenes at rest, EE-RRT* waypoints, padded
obstacles) bit for bit, and a result line with every key of the root's
(run here on the CPU at a small horizon; on the card the line is measured
there)."""

import ast
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from armour_tpu.config import ArmourConfig as JConfig
from armour_tpu_torch import bench as tbench
from armour_tpu_torch.config import ArmourConfig

ROOT = Path(__file__).resolve().parent.parent


def _root_bench():
    spec = importlib.util.spec_from_file_location("root_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scene_instances_match_the_root_bench(monkeypatch):
    monkeypatch.chdir(ROOT)
    _, (jq0, jqd0, jqdd0, jwp, jobs) = _root_bench()._scene_instances(JConfig(dtype=jnp.float32), 3)
    _, (q0, qd0, qdd0, wp, obs) = tbench._scene_instances(ArmourConfig(dtype=torch.float32), 3)
    for got, want in ((q0, jq0), (qd0, jqd0), (qdd0, jqdd0), (wp, jwp),
                      (obs.centers, jobs.centers), (obs.generators, jobs.generators),
                      (obs.mask, jobs.mask)):
        want = np.asarray(want)
        assert got.shape == want.shape and np.array_equal(got.numpy(), want)
        assert got.numpy().dtype == want.dtype


def test_result_line_has_every_key_of_the_root_bench(monkeypatch):
    """The root's result keys, read from its source, are all in the port's
    line, with peak_mem_gb and the card beside them."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    want = next({k.value for k in n.value.keys} for n in ast.walk(tree)
                if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "result")
    assert {"value", "latency_p99_ms", "reachset_batch1_ms", "budget_ok"} <= want
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(tbench, "ArmourConfig", lambda dtype: ArmourConfig(
        dtype=dtype, num_time_steps=4, screen_k=64, solver_outer_iters=1,
        solver_inner_iters=1))
    line = tbench.run(2, device="cpu")
    assert want <= set(line) and {"peak_mem_gb", "card", "device"} <= set(line)
    assert line["batch"] == 2 and line["device"] == "cpu" and line["peak_mem_gb"] is None
    assert line["value"] > 0 and line["latency_p99_ms"] >= line["latency_p50_ms"] > 0

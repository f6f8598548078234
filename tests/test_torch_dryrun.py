"""The dry runs of the port's sharded planner (armour_tpu_torch/parallel/
dryrun.py) on the CPU: the two-process run (2 x 4 shards, torch.distributed
over gloo on localhost, the reduced shapes of scripts/multihost_dryrun.py)
against one process' summary of the same 16 worlds; the flagship
multichip run wants a card unless asked for the CPU (its CPU run at the
flagship shapes is `slow`, as tests/test_multichip.py's)."""

import numpy as np
import pytest
import torch

from armour_tpu_torch.models.kinova import kinova_gen3
from armour_tpu_torch.parallel import batch as tbatch, dryrun


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as every port test file pins (the workers pin
    their own)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_two_process_dry_run_gives_the_one_process_summary(capsys):
    """dryrun_multihost on the CPU against the sharded planner over the same
    16 worlds in this process (8 shards of the same 2 worlds each); the
    summary is printed as one JSON line."""
    got = dryrun.dryrun_multihost(device="cpu")
    cfg = dryrun.multihost_config()
    mesh = tbatch.make_mesh(["cpu"] * (dryrun.N_PROC * dryrun.DEV_PER_PROC))
    res = tbatch.make_sharded_planner(kinova_gen3(), cfg, mesh)(*dryrun.multihost_inputs(cfg))
    want = tbatch.make_sharded_summary(mesh)(res.feasible, res.cost)
    assert (got["processes"], got["shards"], got["worlds"]) == (2, 8, 16)
    assert got["n_feasible"] == want["n_feasible"] and got["n_total"] == want["n_total"] == 16
    assert abs(got["mean_feasible_cost"] - want["mean_feasible_cost"]) <= (
        1e-12 * abs(want["mean_feasible_cost"]))
    assert np.isfinite(got["mean_feasible_cost"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out and out[-1].startswith('{"dryrun": "multihost"')


def test_multihost_inputs_are_the_scripts():
    """The W = 16 inputs of scripts/multihost_dryrun.py: rng 0 starts in
    +-0.5 (float32), waypoints 0.04 away, two boxes padded to 4 slots."""
    cfg = dryrun.multihost_config()
    q0, qd0, qdd0, wp, obs = dryrun.multihost_inputs(cfg)
    want = np.random.default_rng(0).uniform(-0.5, 0.5, (16, 7)).astype(np.float32)
    assert np.array_equal(q0, want) and np.array_equal(wp, (want + 0.04).astype(np.float32))
    assert not qd0.any() and not qdd0.any()
    assert tuple(obs.centers.shape) == (16, 4, 3) and obs.mask.sum().item() == 32
    assert (cfg.num_time_steps, cfg.max_obstacles, cfg.screen_k, cfg.solver_outer_iters,
            cfg.solver_inner_iters) == (16, 4, 256, 2, 2)


def test_dry_runs_want_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the dry runs run on it (chip_smoke.py phase 17)")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.dryrun_multichip(1, shards=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.dryrun_multihost()
    with pytest.raises(ValueError, match="a card and a shard"):
        dryrun.dryrun_multichip(0)


@pytest.mark.slow
def test_dryrun_multichip_on_the_cpu():
    """The flagship shapes (T = 128, 40 obstacles, production iterations)
    over 4 CPU shards, 8 saved-world scenes with RRT* waypoints."""
    line = dryrun.dryrun_multichip(1, shards=4, device="cpu")
    assert line["n_total"] == 8 and line["devices"] == ["cpu"] * 4

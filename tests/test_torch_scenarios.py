"""The port's hard scenarios (armour_tpu_torch/scenarios.py) against the
JAX package's, world for world and bit for bit, and the wiring of
experiments.py's "hard" mode (scripts/run_hard_scenarios.py's settings)."""

import numpy as np
import pytest

from armour_tpu import scenarios as jsc
from armour_tpu_torch import experiments, scenarios as tsc


@pytest.mark.parametrize("i", range(1, 8))
def test_hard_scenario_matches_jax(i):
    port, ref = tsc.hard_scenario(i), jsc.hard_scenario(i)
    for f in ("start", "goal", "obstacle_centers", "obstacle_generators"):
        assert np.array_equal(getattr(port, f), getattr(ref, f)), f
    assert port.goal_radius == ref.goal_radius and port.goal_type == ref.goal_type
    assert np.array_equal(tsc.all_hard_scenarios()[i - 1].obstacle_centers,
                          ref.obstacle_centers)


@pytest.mark.parametrize("i", [0, 8])
def test_hard_scenario_refuses_other_numbers(i):
    with pytest.raises(ValueError, match="not in 1..7"):
        tsc.hard_scenario(i)


def test_hard_mode_wiring(monkeypatch, tmp_path):
    """mode hard ignores world_dir / n_worlds, writes the results file it is
    given, passes the device on, and refuses the JAX package's file name;
    each world runs as scripts/run_hard_scenarios.py runs it."""
    calls = []
    monkeypatch.setattr(experiments, "run_hard_scenarios",
                        lambda path, device=None: calls.append((path, device)) or [])
    out = str(tmp_path / "h.json")
    experiments.main(["no_such_dir", "3", out, "hard", "--device", "cpu"])
    assert calls == [(out, "cpu")]
    monkeypatch.undo()
    with pytest.raises(ValueError, match="results_hard.json"):
        experiments.main(["-", "0", str(tmp_path / "results_hard.json"), "hard"])

    seen = {}

    def fake_trial(world, robot, cfg, step, obs, tp, max_iterations=100, **kw):
        seen.update(world=world, obs=obs, tp=tp, max_iterations=max_iterations, **kw)
        return "summary"

    from armour_tpu_torch import hlp, simulator

    monkeypatch.setattr(simulator, "run_trial", fake_trial)
    monkeypatch.setattr(hlp, "EndEffectorRRTStarHLP",
                        lambda world, robot, lookahead, seed: ("hlp", lookahead, seed))
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.models.kinova import kinova_gen3

    robot, cfg = kinova_gen3(), ArmourConfig()
    rng = np.random.default_rng(0)
    res = experiments.run_hard_world(7, tsc.hard_scenario(7), robot, cfg, "step", "rescue", rng,
                                     device="cpu")
    assert res.world == "hard_7" and res.summary == "summary"
    assert seen["hlp"] == ("hlp", 0.1, 7) and seen["rescue_step"] == "rescue"
    assert seen["max_iterations"] == 500 and seen["device"] == "cpu"
    assert seen["obs"].centers.shape[0] == cfg.max_obstacles and int(seen["obs"].mask.sum()) == 4
    # worst-case parameters (scale 1.0) take no draws from the shared generator
    assert np.array_equal(rng.random(3), np.random.default_rng(0).random(3))
    np.testing.assert_array_equal(seen["tp"].mass.numpy(),
                                  robot.mass * (1.0 + robot.mass_uncertainty))

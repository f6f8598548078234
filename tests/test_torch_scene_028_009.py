"""The scene_028_009 bifurcation against the JAX package, on the CPU at the
flagship config (Kinova Gen3, T = 128, O = 40, K = 4096), one world.

The reference suite on the card (python3 -m armour_tpu_torch.experiments
saved_worlds/reference ... --trace scene_028_009.csv) loses this world on
the current tree and wins it on an older one; the two runs' plans agree to
1.4e-5 in k for 61 iterations, and at iteration 62 their plan-start states,
differing by at most 1.2e-7 after that rounding-level drift, give plans
1.12 apart in k: cost 9.898 (the arm then stalls) against 8.850 (goal in
84 iterations).  Below are both states as the card recorded them.  In
float64 the port's planner (its plain versions) and the JAX planner return
the same plan at both states, the 9.898 one: the port's algorithm does not
depart from the JAX package's there; which plan a float32 run takes is
decided by rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu.collision import pad_obstacles as j_pad
from armour_tpu.config import ArmourConfig as JConfig
from armour_tpu.models.kinova import kinova_gen3 as j_kinova
from armour_tpu.planner import make_planner as j_make_planner
from armour_tpu.worlds import load_world_csv as j_load
from armour_tpu_torch.collision import pad_obstacles
from armour_tpu_torch.config import ArmourConfig
from armour_tpu_torch.models.kinova import kinova_gen3
from armour_tpu_torch.planner import make_planner
from armour_tpu_torch.worlds import load_world_csv

WORLD = "saved_worlds/reference/scene_028_009.csv"
# iteration 62's plan-start state and waypoint: (q0, qd0, qdd0, waypoint)
STATES = {
    "lost": ([-4.858187675476074, -0.49736058712005615, -0.4078080356121063,
              1.7653472423553467, -2.660590171813965, 0.10644778609275818,
              -1.0889660120010376],
             [-0.01577281951904297, 0.008105039596557617, 0.006799161434173584,
              -0.0021250247955322266, -0.015728473663330078, 0.001438140869140625,
              -0.0026197433471679688],
             [-0.06713676452636719, 0.041365861892700195, 0.03542828559875488,
              -0.014193534851074219, -0.06693744659423828, 0.011167764663696289,
              -0.01131296157836914],
             [-5.509974956512451, -0.5694859623908997, -0.6673193573951721,
              2.225416660308838, -3.1450254917144775, -0.12522292137145996,
              -1.1400796175003052]),
    "won": ([-4.858187675476074, -0.4973606467247009, -0.4078080654144287,
             1.7653473615646362, -2.660590171813965, 0.10644783079624176,
             -1.0889660120010376],
            [-0.01577281951904297, 0.008105039596557617, 0.006799221038818359,
             -0.0021250247955322266, -0.015728473663330078, 0.0014381557703018188,
             -0.0026197433471679688],
            [-0.06713676452636719, 0.0413661003112793, 0.035428762435913086,
             -0.014192581176757812, -0.06693744659423828, 0.01116788387298584,
             -0.01131296157836914],
            [-5.509974956512451, -0.5694859623908997, -0.6673194169998169,
             2.225416660308838, -3.1450254917144775, -0.12522292137145996,
             -1.1400796175003052]),
}
# the plan the current tree took at the "lost" state (k, cost), float32 on
# the card; the older tree took an 8.850 plan at the "won" state
K_LOST = [-0.0625, -0.0625, 0.020013734698295593, 0.0625, -0.0625, 0.12301518768072128,
          0.16671130061149597]
COST_LOST = 9.898250579833984


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small: one torch thread each, so that the
    six workers of a full run do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def plans():
    """{state: (port (k, cost, feasible), JAX (k, cost, feasible))}, float64."""
    j_cfg = JConfig(dtype=jnp.float64)
    jw = j_load(WORLD)
    j_obs = j_pad(jw.obstacle_centers, jw.obstacle_generators, j_cfg.max_obstacles, jnp.float64)
    j_step = j_make_planner(j_kinova(), j_cfg)
    cfg = ArmourConfig(dtype=torch.float64)
    w = load_world_csv(WORLD)
    obs = pad_obstacles(w.obstacle_centers, w.obstacle_generators, cfg.max_obstacles,
                        torch.float64)
    step = make_planner(kinova_gen3(), cfg, device="cpu")
    out = {}
    for name, state in STATES.items():
        r = step(*[torch.as_tensor(x, dtype=torch.float64) for x in state], obs)
        jr = j_step(*[jnp.asarray(x, jnp.float64) for x in state], j_obs)
        out[name] = ((r.k.numpy(), float(r.cost), bool(r.feasible)),
                     (np.asarray(jr.k), float(jr.cost), bool(jr.feasible)))
    return out


@pytest.mark.parametrize("name", sorted(STATES))
def test_plan_matches_jax_in_float64(plans, name):
    (k, cost, feas), (jk, jcost, jfeas) = plans[name]
    assert feas and jfeas
    assert float(np.abs(k - jk).max()) <= 1e-6, (k, jk)
    assert abs(cost - jcost) <= 1e-8 * (1.0 + abs(jcost))


@pytest.mark.parametrize("name", sorted(STATES))
def test_float64_takes_the_stalling_plan_at_both_states(plans, name):
    """The float64 reference resolves both states as the current tree did."""
    (k, cost, _), _ = plans[name]
    assert float(np.abs(k - np.asarray(K_LOST)).max()) <= 1e-4
    assert abs(cost - COST_LOST) <= 1e-5 * COST_LOST

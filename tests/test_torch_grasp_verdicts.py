"""The dumbbell's grasp step, world for world, against the JAX package on
the CPU: the Kinova with the dumbbell payload (J = 9, F = 7), the ultimate
bound derived at V_max 5e-4, float32 at the flagship size (T = 128,
O = 40, K = 4096), the 64 saved scenes of chip_smoke.py's phase 13, under
the permissive contact parameters (mu 1.5, r 0.5), the tight ones (1e-4,
1e-4) and without grasp rows.  Both packages solve in chunks of 8 worlds
(the JAX solve of all 64 at once does not fit a host's memory) and give
every world the same verdict; the recorded verdicts are these runs'.
Their feasible costs agree to 1e-4 relative but on one world, whose
float32 plans fork and whose float64 plans agree.  chip_smoke.py compares
the card's verdicts with the same lists."""

import glob
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu.collision import pad_obstacles as j_pad
from armour_tpu.config import ArmourConfig as JConfig, derive_ultimate_bound as j_dub
from armour_tpu.models import zoo as j_zoo
from armour_tpu.parallel.batch import stack_obstacles as j_stack
from armour_tpu.planner import make_batch_planner as j_make_batch_planner
from armour_tpu_torch.collision import pad_obstacles, stack_obstacles
from armour_tpu_torch.config import ArmourConfig, derive_ultimate_bound
from armour_tpu_torch.models import zoo
from armour_tpu_torch.planner import make_batch_planner
from armour_tpu_torch.worlds import load_world_csv, straight_line_waypoint

ROOT = Path(__file__).resolve().parent.parent
V_MAX = 5e-4
CHUNK = 8
# (grasp rows on, mu, support radius)
SETTINGS = {"permissive": (True, 1.5, 0.5), "tight": (True, 1e-4, 1e-4),
            "without_rows": (False, 1.5, 0.5)}
# the feasible worlds of both packages' float32 runs
FEASIBLE = {"permissive": [1, 10, 16, 18, 30, 33, 34, 38, 39, 57], "tight": [],
            "without_rows": sorted(set(range(64)) - {11, 21, 22, 25, 35, 62})}
# a world feasible under the permissive rows, and one that only the rows
# make infeasible (one of the 48)
TWO = [1, 0]
COST_RTOL = 1e-4   # float32: the two packages' sums round apart
# feasible worlds whose float32 plans fork (the same verdict, another local
# optimum): in float64 both packages return one plan (test_fork_is_float32)
FORKS = {("without_rows", 15)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small: one torch thread each, so that the
    six workers of a full run do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scenes():
    """Phase 13's worlds: the first 64 saved random scenes, each with its
    straight-line waypoint."""
    robot = zoo.kinova_dumbbell()
    paths = sorted(glob.glob(str(ROOT / "saved_worlds" / "random" / "*.csv")))[:64]
    worlds = [load_world_csv(p) for p in paths]
    q0 = np.stack([w.start for w in worlds])
    q_des = np.stack([straight_line_waypoint(w.start, w.goal, continuous=robot.continuous_joints)
                      for w in worlds])
    return worlds, q0, q_des


@pytest.fixture(scope="module")
def scenes():
    return _scenes()


@pytest.fixture(scope="module")
def bounds():
    return (derive_ultimate_bound(zoo.kinova_dumbbell(), v_max=V_MAX),
            j_dub(j_zoo.load_zoo_robot("kinova_dumbbell"), v_max=V_MAX))


def _solve(setting, idx, scenes, bounds, dtype="float32", with_k=False):
    """(port (feasible, cost), JAX (feasible, cost)) per world of idx (with
    k appended where with_k), the worlds solved CHUNK at a time in both
    packages."""
    worlds, q0, q_des = scenes
    on, mu, rr = SETTINGS[setting]
    t_dt, j_dt = getattr(torch, dtype), getattr(jnp, dtype)
    robot, j_robot = zoo.kinova_dumbbell(), j_zoo.load_zoo_robot("kinova_dumbbell")
    cfg = ArmourConfig.for_robot(robot, derive_ub=False, ub=bounds[0], dtype=t_dt,
                                 grasp_constraints=on, grasp_mu=mu, grasp_support_radius=rr)
    j_cfg = JConfig.for_robot(j_robot, derive_ub=False, ub=bounds[1], dtype=j_dt,
                              grasp_constraints=on, grasp_mu=mu, grasp_support_radius=rr)
    assert (cfg.num_time_steps, cfg.max_obstacles, cfg.screen_k) == (128, 40, 4096)
    step, j_step = make_batch_planner(robot, cfg, device="cpu"), j_make_batch_planner(j_robot,
                                                                                      j_cfg)
    port, ref = [], []
    for c in range(0, len(idx), CHUNK):
        ids = idx[c:c + CHUNK]
        z = np.zeros((len(ids), 7))
        obs = stack_obstacles([pad_obstacles(worlds[i].obstacle_centers,
                                             worlds[i].obstacle_generators, cfg.max_obstacles,
                                             t_dt) for i in ids])
        r = step(*(torch.as_tensor(x, dtype=t_dt) for x in (q0[ids], z, z, q_des[ids])), obs)
        port += list(zip(r.feasible.tolist(), r.cost.tolist(), r.k.numpy()))
        j_obs = j_stack([j_pad(worlds[i].obstacle_centers, worlds[i].obstacle_generators,
                               j_cfg.max_obstacles, j_dt) for i in ids])
        jr = j_step(*(jnp.asarray(x, j_dt) for x in (q0[ids], z, z, q_des[ids])), j_obs)
        ref += list(zip(np.asarray(jr.feasible).tolist(), np.asarray(jr.cost).tolist(),
                        np.asarray(jr.k)))
    if not with_k:
        port, ref = [p[:2] for p in port], [p[:2] for p in ref]
    return port, ref


def _check(setting, idx, port, ref):
    assert [f for f, _ in port] == [f for f, _ in ref], setting
    assert [i for i, (f, _) in zip(idx, port) if f] == [i for i in idx if i in FEASIBLE[setting]]
    for i, (f, c), (_, jc) in zip(idx, port, ref):
        if f and (setting, i) not in FORKS:
            assert abs(c - jc) <= COST_RTOL * abs(jc), (setting, i, c, jc)


@pytest.mark.parametrize("setting", ["permissive", "without_rows"])
def test_two_worlds_at_full_size_match_jax(setting, scenes, bounds):
    """World 1 keeps its plan under the permissive grasp rows; world 0,
    feasible without them, loses it: in both packages, at T = 128."""
    port, ref = _solve(setting, TWO, scenes, bounds)
    _check(setting, TWO, port, ref)
    assert [f for f, _ in port] == ([True, False] if setting == "permissive" else [True, True])


@pytest.mark.slow
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_all_64_worlds_match_jax(setting, scenes, bounds):
    idx = list(range(64))
    port, ref = _solve(setting, idx, scenes, bounds)
    _check(setting, idx, port, ref)


@pytest.mark.parametrize("setting, world", sorted(FORKS))
def test_fork_is_float32(setting, world, scenes, bounds):
    """World 15 without grasp rows: the float32 plans of the two packages
    are both feasible and 0.026 apart in k (cost 0.52837 against 0.52907);
    in float64 both packages return the same plan (cost 0.529111), so the
    difference is float32 rounding, not the port."""
    (port,), (ref,) = _solve(setting, [world], scenes, bounds, "float64", with_k=True)
    assert port[0] and ref[0]
    assert float(np.abs(port[2] - ref[2]).max()) <= 1e-9
    assert abs(port[1] - ref[1]) <= 1e-12 * abs(ref[1])


def test_smoke_holds_the_recorded_verdicts():
    """chip_smoke.py's phase 13 compares the card's feasible worlds with
    these lists: its copy must be this file's."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.GRASP_FEASIBLE_CPU == FEASIBLE

"""The port's worlds-sharded planner (armour_tpu_torch/parallel/batch.py)
against the JAX package's on the CPU, float64 (num_time_steps = 16,
max_obstacles = 16, screen_k = 256): the port over a mesh of ["cpu"] * 4,
the JAX planner over 4 of the 8 virtual CPU devices, W = 8 worlds (the
two-obstacle scene, its walled-in infeasible case and six saved scenes,
three of them test_torch_planner.py's).  Per world the same verdict and
the cost within 1e-6 + 1e-6 |cost|; the summary's counts exact and its
mean cost within 1e-9 relative; each shard the bits of make_batch_planner
on its worlds alone; the mesh's refusals.  This file compiles the JAX
sharded planner (~45 s), so the JAX package's certification of each
feasible k is in test_torch_parallel_certified.py and the dry runs in
test_torch_dryrun.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu import rnea_numeric
from armour_tpu.collision import pad_obstacles as j_pad
from armour_tpu.config import ArmourConfig as JConfig
from armour_tpu.models.kinova import kinova_gen3 as j_kinova
from armour_tpu.parallel import batch as jbatch
from armour_tpu.worlds import load_world_csv
from armour_tpu_torch import convert
from armour_tpu_torch.collision import ObstacleSet, pad_obstacles
from armour_tpu_torch.parallel import batch as tbatch
from armour_tpu_torch.planner import make_batch_planner
from armour_tpu_torch.worlds import straight_line_waypoint

J_ROBOT = j_kinova()
J_CFG = JConfig(num_time_steps=16, max_obstacles=16, screen_k=256, dtype=jnp.float64)
T_ROBOT = convert.robot_from_fields({f.name: getattr(J_ROBOT, f.name)
                                     for f in dataclasses.fields(J_ROBOT)})
T_CFG = convert.config_from_fields({f.name: getattr(J_CFG, f.name)
                                    for f in dataclasses.fields(J_CFG)})

Q0 = np.array([0.6543, -0.0876, -0.4837, -1.2278, -1.5735, -1.0720, 0.0])
OBS_C = np.array([[0.5, 0.5, 0.5], [-0.5, -0.5, 0.8]])
OBS_G = np.stack([np.diag([0.05, 0.05, 0.05]), np.diag([0.08, 0.08, 0.08])])
SAVED = ["scene_013_001", "scene_013_002", "scene_013_003", "scene_013_004",
         "scene_013_005", "scene_013_006"]
NAMES = ["two_obstacles", "walled_in", *SAVED]
W, SHARDS = len(NAMES), 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small: one torch thread each, so that the
    six workers of a full run do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scenes():
    """[(q0, q_des, obstacle centres, obstacle generators)] in NAMES order."""
    _, _, link_c = rnea_numeric.forward_kinematics(J_ROBOT, jnp.asarray(Q0))
    walled = (np.asarray(link_c)[:7], np.stack([np.diag([0.3, 0.3, 0.3])] * 7))
    out = [(Q0, Q0 + 0.04, OBS_C, OBS_G), (Q0, Q0 + 0.04, *walled)]
    for name in SAVED:
        w = load_world_csv(f"saved_worlds/random/{name}.csv")
        wp = straight_line_waypoint(w.start, w.goal, continuous=T_ROBOT.continuous_joints)
        out.append((w.start, wp, w.obstacle_centers, w.obstacle_generators))
    return out


def _port_obs(scenes):
    return ObstacleSet(*(torch.stack(xs) for xs in zip(*[
        dataclasses.astuple(pad_obstacles(c, g, T_CFG.max_obstacles, torch.float64))
        for _, _, c, g in scenes])))


@pytest.fixture(scope="module")
def results():
    scenes = _scenes()
    q0 = np.stack([s[0] for s in scenes])
    q_des = np.stack([s[1] for s in scenes])
    zeros = np.zeros_like(q0)

    j_obs = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        j_pad(c, g, J_CFG.max_obstacles, jnp.float64) for _, _, c, g in scenes])
    j_mesh = jbatch.make_mesh(jax.devices()[:SHARDS])
    j_res = jbatch.make_sharded_planner(J_ROBOT, J_CFG, j_mesh)(
        jnp.asarray(q0), jnp.asarray(zeros), jnp.asarray(zeros), jnp.asarray(q_des), j_obs)
    j_sum = jbatch.make_sharded_summary(j_mesh)(j_res.feasible, j_res.cost)

    t_obs = _port_obs(scenes)
    mesh = tbatch.make_mesh(["cpu"] * SHARDS)
    t_res = tbatch.make_sharded_planner(T_ROBOT, T_CFG, mesh)(q0, zeros, zeros, q_des, t_obs)
    t_sum = tbatch.make_sharded_summary(mesh)(t_res.feasible, t_res.cost)

    batch = make_batch_planner(T_ROBOT, T_CFG, device="cpu")
    m = W // SHARDS
    alone = [batch(q0[i * m:(i + 1) * m], zeros[i * m:(i + 1) * m], zeros[i * m:(i + 1) * m],
                   q_des[i * m:(i + 1) * m],
                   ObstacleSet(*(x[i * m:(i + 1) * m] for x in dataclasses.astuple(t_obs))))
             for i in range(SHARDS)]

    return {"jax": j_res, "jax_summary": j_sum, "torch": t_res, "summary": t_sum,
            "alone": alone}


@pytest.mark.parametrize("w", range(W), ids=NAMES)
def test_verdict_agrees_with_jax(results, w):
    assert bool(results["torch"].feasible[w]) == bool(results["jax"].feasible[w])


@pytest.mark.parametrize("w", range(W), ids=NAMES)
def test_cost_agrees_with_jax(results, w):
    c_t, c_j = float(results["torch"].cost[w]), float(results["jax"].cost[w])
    assert abs(c_t - c_j) <= 1e-6 + 1e-6 * abs(c_j), (c_t, c_j)


def test_scenes_cover_both_verdicts(results):
    feas = results["torch"].feasible.tolist()
    assert feas[0] and not feas[1] and sum(feas) >= 4


def test_summary_matches_jax(results):
    got, want = results["summary"], results["jax_summary"]
    assert got["n_feasible"] == int(want["n_feasible"])
    assert got["n_total"] == int(want["n_total"]) == W
    m_t, m_j = got["mean_feasible_cost"], float(want["mean_feasible_cost"])
    assert abs(m_t - m_j) <= 1e-9 * abs(m_j), (m_t, m_j)


@pytest.mark.parametrize("shard", range(SHARDS))
def test_each_shard_is_the_batch_planner_on_its_worlds(results, shard):
    m = W // SHARDS
    res, alone = results["torch"], results["alone"][shard]
    for f in dataclasses.fields(res):
        got = getattr(res, f.name)[shard * m:(shard + 1) * m]
        want = getattr(alone, f.name)
        assert got.dtype == want.dtype and got.shape == want.shape, f.name
        assert torch.equal(got.isnan(), want.isnan()), f.name
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)), f.name


def test_worlds_not_divisible_by_the_mesh_raise():
    mesh = tbatch.make_mesh(["cpu"] * 3)
    step = tbatch.make_sharded_planner(T_ROBOT, T_CFG, mesh)
    q = np.zeros((4, 7))
    obs = _port_obs(_scenes()[:4])
    with pytest.raises(ValueError, match="4 worlds do not split into the mesh's 3 shards"):
        step(q, q, q, q, obs)
    with pytest.raises(ValueError, match="do not split"):
        tbatch.make_sharded_summary(mesh)(torch.ones(4, dtype=torch.bool), torch.zeros(4))


def test_make_mesh_wants_a_card_by_default():
    """Without devices the mesh takes every card, and raises naming CUDA
    where there is none (a CUDA device named explicitly too)."""
    if torch.cuda.is_available():
        assert len(tbatch.make_mesh()) == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tbatch.make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            tbatch.make_mesh(["cuda:0"])
        with pytest.raises(RuntimeError, match="CUDA"):
            tbatch.make_sharded_planner(T_ROBOT, T_CFG, tbatch.Mesh(
                devices=(torch.device("cuda", 0),), axis_names=("worlds",)))


def test_make_mesh_keeps_order_and_repeats_and_refuses_a_missing_card(monkeypatch):
    mesh = tbatch.make_mesh(["cpu", torch.device("cpu")] * 2, axis="worlds")
    assert mesh.devices == (torch.device("cpu"),) * 4 and mesh.size == len(mesh) == 4
    assert mesh.axis_names == ("worlds",)
    with pytest.raises(ValueError, match="axes"):
        tbatch.make_sharded_summary(mesh, axis="batch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    two = tbatch.make_mesh(["cuda:1", "cuda:0", "cuda:1"])
    assert two.devices == (torch.device("cuda", 1), torch.device("cuda", 0),
                           torch.device("cuda", 1))
    with pytest.raises(ValueError, match="2 CUDA device"):
        tbatch.make_mesh(["cuda:0", "cuda:2"])
    with pytest.raises(ValueError, match="at least one"):
        tbatch.make_mesh([])

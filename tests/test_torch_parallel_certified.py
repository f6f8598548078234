"""Every feasible k of the port's sharded planner (["cpu"] * 4, W = 8, the
scenes and float64 config of test_torch_parallel.py) certified by the JAX
package's full-set check, nlp.max_violations (a file of its own: its jit
compiles ~15 s, the JAX sharded planner beside it ~45 s)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu import nlp as jnlp
from armour_tpu.collision import build_hyperplanes, pad_obstacles as j_pad
from armour_tpu.dynamics import torque_frs
from armour_tpu.jrs import build_jrs
from armour_tpu.kinematics import forward_occupancy, reduce_links
from armour_tpu.pz.basis import make_basis as j_make_basis
from armour_tpu_torch.parallel import batch as tbatch
from test_torch_parallel import J_CFG, J_ROBOT, NAMES, SHARDS, T_CFG, T_ROBOT, W, _port_obs, \
    _scenes

J_BASIS = j_make_basis(7, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as every port test file pins."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@jax.jit
def _j_max_violations(q0, q_des, obs, k):
    z = jnp.zeros_like(q0)
    jrs = build_jrs(q0, z, z, J_ROBOT, J_CFG, J_BASIS)
    frs = reduce_links(forward_occupancy(jrs, J_ROBOT, J_CFG, J_BASIS), J_BASIS)
    prob = jnlp.PlanProblem(
        traj=jrs.traj, q_des=q_des, torque=torque_frs(jrs, J_ROBOT, J_CFG, J_BASIS),
        frs=frs, hyp=build_hyperplanes(frs, obs), obs=obs,
        screened=None)        # max_violations reads the full set, not the screen
    return jnp.stack(jnlp.max_violations(k, prob, J_ROBOT, J_CFG, J_BASIS))


@pytest.fixture(scope="module")
def certified():
    scenes = _scenes()
    q0 = np.stack([s[0] for s in scenes])
    q_des = np.stack([s[1] for s in scenes])
    zeros = np.zeros_like(q0)
    res = tbatch.make_sharded_planner(T_ROBOT, T_CFG, tbatch.make_mesh(["cpu"] * SHARDS))(
        q0, zeros, zeros, q_des, _port_obs(scenes))
    checks = {}
    for w, (_, _, c, g) in enumerate(scenes):
        if bool(res.feasible[w]):
            checks[w] = np.asarray(_j_max_violations(
                jnp.asarray(q0[w]), jnp.asarray(q_des[w]),
                j_pad(c, g, J_CFG.max_obstacles, jnp.float64), jnp.asarray(res.k[w].numpy())))
    return res, checks


@pytest.mark.parametrize("w", range(W), ids=NAMES)
def test_feasible_k_certified_by_jax(certified, w):
    res, checks = certified
    if not bool(res.feasible[w]):
        assert bool(torch.isnan(res.k[w]).all())
        return
    k = res.k[w].numpy()
    assert np.all(np.isfinite(k)) and np.all(np.abs(k) <= 1.0 + 1e-9)
    v_torque, v_col, v_state, v_grasp = checks[w]
    assert v_torque <= J_CFG.torque_violation_threshold
    assert v_col <= J_CFG.collision_violation_threshold
    assert v_state <= 1e-6
    assert v_grasp <= J_CFG.grasp_violation_threshold


def test_the_scenes_have_feasible_worlds(certified):
    assert len(certified[1]) >= 4

"""The screen's order against the JAX package, float64 on the CPU.

jax.lax.top_k orders equal values by index, the lower first; torch.topk
leaves them in no defined order.  The port's screen_collision_plain (the
plain version of kernel K13, and the screen on CPU tensors) takes
lax.top_k's order, so that K13 can be held to it bit for bit.  Here a
T = 8 world of scene_013_001 with three of its obstacles duplicated (their
rows tie with the originals') and padded to 20 (the padded rows tie at
-BIG) goes through both packages' screens with and without an obstacle
quota; the screened rows must agree in order, the padded ones included."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu import collision as jcol
from armour_tpu.config import ArmourConfig as JConfig
from armour_tpu.jrs import build_jrs as j_build_jrs
from armour_tpu.kinematics import forward_occupancy as j_fo, reduce_links as j_rl
from armour_tpu.models.kinova import kinova_gen3 as j_kinova
from armour_tpu.pz.basis import make_basis as j_make_basis
from armour_tpu.worlds import load_world_csv
from armour_tpu_torch import collision as tcol
from armour_tpu_torch import convert

T, O_PAD, N_DUP = 8, 20, 3
SCENE = "saved_worlds/random/scene_013_001.csv"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small: one torch thread each, so that the
    six workers of a full run do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if f.name != "dims"}


@pytest.fixture(scope="module")
def tied_scene():
    robot = j_kinova()
    cfg = JConfig(num_time_steps=T, dtype=jnp.float64)
    basis = j_make_basis(7, 3)
    world = load_world_csv(SCENE)
    c = np.concatenate([world.obstacle_centers, world.obstacle_centers[:N_DUP]])
    g = np.concatenate([world.obstacle_generators, world.obstacle_generators[:N_DUP]])
    jobs = jcol.pad_obstacles(c, g, O_PAD, jnp.float64)

    @jax.jit
    def frs_hyp(q0):
        frs = j_rl(j_fo(j_build_jrs(q0, jnp.zeros(7), jnp.zeros(7), robot, cfg, basis),
                        robot, cfg, basis), basis)
        return frs, jcol.build_hyperplanes(frs, jobs)

    frs, hyp = frs_hyp(jnp.asarray(world.start))
    t_frs = convert.linkfrs_from_numpy(**{k: v[None] for k, v in _fields(frs).items()})
    t_obs = convert.obstacles_from_numpy(**{k: v[None] for k, v in _fields(jobs).items()})
    t_hyp = tcol.Hyperplanes(A=torch.as_tensor(np.array(hyp.A))[None],
                             d=torch.as_tensor(np.array(hyp.d))[None],
                             delta=torch.as_tensor(np.array(hyp.delta))[None], dims=hyp.dims)
    return frs, hyp, jobs, t_frs, t_obs, t_hyp


@pytest.mark.parametrize("K, quota", [(600, 0), (1100, 0), (600, 2), (1100, 4)])
def test_screen_order_matches_jax_on_ties(tied_scene, K, quota):
    """K = 600 cuts among the 896 real rows, K = 1,100 takes padded rows;
    the quota rows of a padded obstacle tie at -BIG."""
    frs, hyp, jobs, t_frs, t_obs, t_hyp = tied_scene
    g_up, _ = tcol._screen_bound(t_hyp, t_obs, t_frs)
    real = g_up[0][g_up[0] > -tcol.BIG]
    assert real.numel() - torch.unique(real).numel() >= 3 * T * 7     # duplicated rows tie
    sc = jcol.screen_collision(hyp, jobs, frs, K, quota)
    t_sc = tcol.screen_collision(t_hyp, t_obs, t_frs, K, quota)
    assert t_sc.row[0].tolist() == np.asarray(sc.row).tolist()
    assert t_sc.mask[0].tolist() == np.asarray(sc.mask).tolist()
    for f in ("A", "d", "delta"):
        np.testing.assert_array_equal(getattr(t_sc, f)[0].numpy(), np.asarray(getattr(sc, f)))


def test_screen_rows_order_matches_lax_top_k():
    """Values tied in long runs: the port's selection gives lax.top_k's
    indices in order."""
    x = np.array([1, 2, 2, 2, 0, 2, 5, 2] * 500, dtype=np.float64)
    _, j_idx = jax.lax.top_k(jnp.asarray(x), 600)
    idx = tcol.screen_rows(torch.as_tensor(x)[None], 1, 600)
    assert idx[0].tolist() == np.asarray(j_idx).tolist()

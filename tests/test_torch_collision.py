"""Parity of the PyTorch port's collision stage with the JAX package,
float64 on the CPU at T = 8 on a 13-obstacle saved scene padded to 16.

The JAX LinkFRS is fed to the port through convert.py, so this stage is
tested on its own: build_hyperplanes (kernel K3's plain version),
screen_collision (compared as the SET of real rows: ties among padded rows
at -BIG are free), and kernel K4's plain version on the screened rows and
over all rows (collision_constraints), including a case built to tie on the
argmax, which must keep the first maximal index as jnp.argmax does."""

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
from armour_tpu_torch.pz.basis import make_basis

T, O_PAD = 8, 16
SCENE = "saved_worlds/random/scene_013_001.csv"
J_BASIS = j_make_basis(7, 3)
T_BASIS = make_basis(7, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small: one torch thread each, so that the
    six workers of a full run do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if f.name != "dims"}


def close(t, j, rtol=1e-9):
    t = t.detach().numpy()
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    scale = max(1.0, float(np.max(np.abs(j)))) if j.size else 1.0
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * 1e-3 * scale)


@pytest.fixture(scope="module")
def scene():
    robot = j_kinova()
    cfg = JConfig(num_time_steps=T, dtype=jnp.float64)
    world = load_world_csv(SCENE)
    assert world.num_obstacles == 13
    jobs = jcol.pad_obstacles(world.obstacle_centers, world.obstacle_generators, O_PAD,
                              jnp.float64)

    @jax.jit
    def frs_hyp(q0):
        frs = j_rl(j_fo(j_build_jrs(q0, jnp.zeros(7), jnp.zeros(7), robot, cfg, J_BASIS),
                        robot, cfg, J_BASIS), J_BASIS)
        return frs, jcol.build_hyperplanes(frs, jobs)

    frs, hyp = frs_hyp(jnp.asarray(world.start))
    # the port's stages carry a leading worlds axis (W = 1)
    t_frs = convert.linkfrs_from_numpy(**{k: v[None] for k, v in fields(frs).items()})
    t_obs = convert.obstacles_from_numpy(**{k: v[None] for k, v in fields(jobs).items()})
    return frs, hyp, jobs, t_frs, t_obs, tcol.build_hyperplanes(t_frs, t_obs)


def test_hyperplanes_match_jax(scene):
    _, hyp, _, _, _, t_hyp = scene
    assert t_hyp.dims == hyp.dims
    close(t_hyp.A[0], hyp.A)
    close(t_hyp.d[0], hyp.d)
    close(t_hyp.delta[0], hyp.delta)
    # degenerate (parallel-generator) pairs give exactly zero normals in both
    t_deg = np.abs(t_hyp.A[0].numpy()).sum(axis=0) == 0
    j_deg = np.abs(np.asarray(hyp.A)).sum(axis=0) == 0
    assert np.array_equal(t_deg, j_deg) and j_deg.any()


def _real_rows(row, mask, d, delta, A):
    """Sorted (row, d, delta, A) table of the real (unmasked) screened rows."""
    keep = np.asarray(mask)
    row, d, delta = np.asarray(row)[keep], np.asarray(d)[:, keep], np.asarray(delta)[:, keep]
    A = np.asarray(A)[:, :, keep]
    order = np.lexsort((d[1], d[0], row))
    return row[order], d[:, order], delta[:, order], A[:, :, order]


@pytest.mark.parametrize("K,quota", [(256, 0), (800, 0), (256, 4)])
def test_screen_selects_the_same_real_rows(scene, K, quota):
    """K = 800 exceeds the 728 real rows, so padded rows fill the rest."""
    frs, hyp, jobs, t_frs, t_obs, t_hyp = scene
    sc = jcol.screen_collision(hyp, jobs, frs, K, quota)
    t_sc = tcol.screen_collision(t_hyp, t_obs, t_frs, K, quota)
    assert t_sc.row.shape == (1, K)
    j_tab = _real_rows(sc.row, sc.mask, sc.d, sc.delta, sc.A)
    t_tab = _real_rows(t_sc.row[0], t_sc.mask[0], t_sc.d[0], t_sc.delta[0], t_sc.A[0])
    assert np.array_equal(j_tab[0], t_tab[0])
    for t, j in zip(t_tab[1:], j_tab[1:]):
        close(torch.as_tensor(t), j)
    if quota:
        # every real obstacle owns its quota rows; padded ones are inert
        O = hyp.dims[2]
        owner = np.repeat(np.arange(O), quota)
        m = t_sc.mask[0, : O * quota].numpy()
        assert m[owner < 13].all() and not m[owner >= 13].any()


def _screened_pair(scene, K=256):
    """The same screened rows in both packages (JAX's selection, converted)."""
    frs, hyp, jobs, _, _, _ = scene
    sc = jcol.screen_collision(hyp, jobs, frs, K)
    return sc, convert.screened_from_numpy(**{k: v[None] for k, v in fields(sc).items()})


def _ks(rng, n):
    return rng.uniform(-1, 1, (n, 7))


def _jax_rows(sc, frs, k):
    p_all = jcol.eval_link_polys(frs, J_BASIS.phi(jnp.asarray(k)))
    dp_all = jcol.eval_link_poly_grads(frs, J_BASIS.dphi(jnp.asarray(k)))
    g, grad_p = jcol.screened_constraints(sc, p_all)
    return g, jcol.screened_constraint_grads(sc, grad_p, dp_all)


def _torch_rows(t_sc, t_frs, ks):
    kt = torch.as_tensor(ks)[None]                       # [W = 1, Q, F]
    p_all = tcol.eval_link_polys(t_frs, T_BASIS.phi(kt))
    dp_all = tcol.eval_link_poly_grads(t_frs, T_BASIS.dphi(kt))
    return tcol.screened_rows(t_sc, p_all, dp_all)


def test_link_polys_match_jax(scene):
    frs, _, _, t_frs, _, _ = scene
    k = np.random.default_rng(3).uniform(-1, 1, 7)
    kt = torch.as_tensor(k)[None, None]
    close(tcol.eval_link_polys(t_frs, T_BASIS.phi(kt))[0, 0],
          jcol.eval_link_polys(frs, J_BASIS.phi(jnp.asarray(k))))
    close(tcol.eval_link_poly_grads(t_frs, T_BASIS.dphi(kt))[0, 0],
          jcol.eval_link_poly_grads(frs, J_BASIS.dphi(jnp.asarray(k))))


def test_screened_rows_match_jax(scene):
    """K4's plain version (g and dg/dk) at several k in one call."""
    sc, t_sc = _screened_pair(scene)
    frs, t_frs = scene[0], scene[3]
    ks = _ks(np.random.default_rng(4), 3)
    g, dg = _torch_rows(t_sc, t_frs, ks)
    for q, k in enumerate(ks):
        jg, jdg = _jax_rows(sc, frs, k)
        close(g[0, q], jg)
        close(dg[0, q], jdg)


def test_repeated_normals_match_jax(scene):
    """Rows whose best normal repeats (c2 = c1) or flips (c2 = -c1, the pos
    c2 and neg c1 candidates tie), as parallel generator pairs give."""
    sc, _ = _screened_pair(scene)
    frs, t_frs = scene[0], scene[3]
    A, d, delta = (np.array(sc.A), np.array(sc.d), np.array(sc.delta))
    ks = _ks(np.random.default_rng(5), 2)
    # make every row's best candidate a tie: copy the row's argmax normal
    # (found with JAX) into a later slot, repeated or flipped
    p_all = jcol.eval_link_polys(frs, J_BASIS.phi(jnp.asarray(ks[0])))
    p = np.asarray(p_all)[:, np.asarray(sc.row)]
    Ap = np.einsum("ack,ak->ck", A, p)
    both = np.concatenate([Ap - (d + delta), -Ap - (-d + delta)])
    best = np.argmax(both, axis=0)
    n_rows = A.shape[-1]
    for r in range(n_rows):
        c1 = best[r] % 36
        c2 = 35 if c1 != 35 else 34
        flip = -1.0 if r % 2 else 1.0
        A[:, c2, r], d[c2, r], delta[c2, r] = flip * A[:, c1, r], flip * d[c1, r], delta[c1, r]
    jsc = jcol.ScreenedCollision(A=jnp.asarray(A), d=jnp.asarray(d), delta=jnp.asarray(delta),
                                 row=sc.row, mask=sc.mask)
    t_sc = convert.screened_from_numpy(A[None], d[None], delta[None],
                                       np.asarray(sc.row)[None], np.asarray(sc.mask)[None])
    g, dg = _torch_rows(t_sc, t_frs, ks)
    for q, k in enumerate(ks):
        jg, jdg = _jax_rows(jsc, frs, k)
        close(g[0, q], jg)
        close(dg[0, q], jdg)


def test_full_set_constraints_match_jax(scene):
    """The finalize check over all T*J*O rows (K4's plain version there)."""
    frs, hyp, jobs, t_frs, t_obs, t_hyp = scene
    ks = _ks(np.random.default_rng(6), 2)
    kt = torch.as_tensor(ks)[None]
    g = tcol.collision_constraints(t_hyp, t_obs, tcol.eval_link_polys(t_frs, T_BASIS.phi(kt)))
    for q, k in enumerate(ks):
        jg = jcol.collision_constraints(
            hyp, jobs, jcol.eval_link_polys(frs, J_BASIS.phi(jnp.asarray(k))))
        close(g[0, q], jg)
    # the padded obstacles sit at -BIG
    assert np.all(g[0, :, :, :, 13:].numpy() == -tcol.BIG)


def test_argmax_ties_keep_the_first_index():
    """Two different normals tie exactly on the best candidate: the gradient
    is the first maximal candidate's (pos[0..C-1] before neg[0..C-1]), as
    jnp.argmax gives; any other choice gives another gradient."""
    C, K, TJ, F = 36, 9, 3, 7
    rng = np.random.default_rng(5)
    A = np.zeros((3, C, K))
    d = np.zeros((C, K))
    delta = np.full((C, K), 0.1)
    row = (np.arange(K) % TJ).astype(np.int32)
    p_all = np.zeros((3, TJ))
    p_all[:2] = 0.5                          # A.p = +-0.5 exactly for unit axes
    want = np.zeros((3, K))
    for r in range(K):
        c1, c2 = sorted(rng.choice(C, 2, replace=False))
        if r % 3 == 0:      # pos c1 == pos c2 = 0.4: first is pos c1
            A[0, c1, r], A[1, c2, r] = 1.0, 1.0
            want[:, r] = -A[:, c1, r]
        elif r % 3 == 1:    # neg c1 == neg c2 = 0.4: first is neg c1
            A[0, c1, r], A[1, c2, r] = -1.0, -1.0
            want[:, r] = A[:, c1, r]
        else:               # pos c1 == neg c2 = 0.4: pos comes first
            A[0, c1, r], A[1, c2, r] = 1.0, -1.0
            want[:, r] = -A[:, c1, r]
    mask = np.ones(K, bool)
    dp_all = rng.normal(size=(3, F, TJ))

    t_sc = convert.screened_from_numpy(A[None], d[None], delta[None], row[None], mask[None])
    g, dg = tcol.screened_rows(t_sc, torch.as_tensor(p_all)[None, None],
                               torch.as_tensor(dp_all)[None, None])
    assert np.allclose(g[0, 0].numpy(), -0.4, rtol=0, atol=1e-15)
    want_dg = np.einsum("ak,afk->kf", want, dp_all[:, :, row])
    np.testing.assert_allclose(dg[0, 0].numpy(), want_dg, rtol=1e-12, atol=1e-15)

    jsc = jcol.ScreenedCollision(A=jnp.asarray(A), d=jnp.asarray(d), delta=jnp.asarray(delta),
                                 row=jnp.asarray(row), mask=jnp.asarray(mask))
    jg, grad_p = jcol.screened_constraints(jsc, jnp.asarray(p_all))
    close(g[0, 0], jg)
    close(dg[0, 0], jcol.screened_constraint_grads(jsc, grad_p, jnp.asarray(dp_all)))


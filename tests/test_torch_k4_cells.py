"""K4's cell mode: the full-set check that forms its rows from the cells.

Hyperplanes made from the cells (collision.build_hyperplanes) form A / d /
delta only when they are read; on the card collision_constraints hands
their cells to K4's cell mode (kernels/collision.py:collision_cells), so no
planning step runs K3 or makes its [W, 3, 36, N] tensor.  On the CPU:

  * the cell route's collision_constraints against the JAX package's
    collision_constraints(build_hyperplanes(...)) at W = 2, T = 8, O = 5 in
    float64 (1e-9), with a padded obstacle, a zero-radius link (degenerate
    normals) and a NaN query point;
  * plan_problem's hyperplanes, formed on read, against the JAX package's
    of the same cells, and its solve against the same solve on hyperplanes
    made from tensors (the same bits);
  * the routing on the card, with the launchers stubbed: cells to the cell
    mode (A never formed, and the screen forms nothing either), tensors to
    the row mode.

The cuda-marked tests hold the cell mode against K4's row mode over K3's
tensors of the same cells bit for bit, and the screened rows at every
group size against the G = 1 instantiation bit for bit, in the hard and
the smooth mode (they skip where there is no card).  JAX is imported inside
the CPU tests only, so that the card's tests run without it."""

import dataclasses

import numpy as np
import pytest
import torch

from armour_tpu_torch import collision as tcol
from armour_tpu_torch.kernels import collision as kcol

T, O, WN = 8, 5, 2
SCENES = ((np.array([0.6543, -0.0876, -0.4837, -1.2278, -1.5735, -1.0720, 0.0]), 4),
          (np.array([0.1, 0.3, -0.2, -1.0, 0.4, 0.8, -0.3]), 3))
ZERO_LINK = 2          # its radius set to 0: degenerate buffered pairs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small: one torch thread each, so that the
    six workers of a full run do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _obstacles(n, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.5, 0.5, (n, 3)) + np.array([0.3, 0.0, 0.5])
    g = np.stack([np.diag(rng.uniform(0.03, 0.12, 3)) for _ in range(n)])
    return c, g


@pytest.fixture(scope="module")
def jax_cells():
    """Per world: the JAX link sets (one link's radius 0), the padded
    obstacles, and the port's W = 2 counterparts."""
    import jax
    import jax.numpy as jnp

    from armour_tpu import collision as jcol
    from armour_tpu.config import ArmourConfig as JConfig
    from armour_tpu.jrs import build_jrs
    from armour_tpu.kinematics import forward_occupancy, reduce_links
    from armour_tpu.models.kinova import kinova_gen3
    from armour_tpu.pz.basis import make_basis

    robot, cfg, basis = kinova_gen3(), JConfig(num_time_steps=T, dtype=jnp.float64), \
        make_basis(7, 3)

    @jax.jit
    def frs_of(q0):
        z = jnp.zeros(7)
        return reduce_links(forward_occupancy(build_jrs(q0, z, z, robot, cfg, basis), robot, cfg,
                                              basis), basis)

    jfrs, jobs = [], []
    for w, (q0, n) in enumerate(SCENES):
        f = frs_of(jnp.asarray(q0))
        jfrs.append(dataclasses.replace(f, radius=f.radius.at[:, ZERO_LINK].set(0.0)))
        jobs.append(jcol.pad_obstacles(*_obstacles(n, w), O, jnp.float64))
    frs = tcol.LinkFRS(**{f: torch.as_tensor(np.stack([np.asarray(getattr(x, f)) for x in jfrs]))
                          for f in ("center_coef", "shape_gens", "radius")})
    obs = tcol.ObstacleSet(**{f: torch.as_tensor(np.stack([np.asarray(getattr(x, f))
                                                           for x in jobs]))
                              for f in ("centers", "generators", "mask")})
    return jfrs, jobs, frs, obs


def test_cell_route_matches_jax_full_set(jax_cells):
    """collision_constraints on Hyperplanes made from the cells (formed on
    read by the plain version here) against the JAX full-set check: 1e-9,
    the padded obstacle's rows at -BIG, NaN exactly at the NaN link centre."""
    import jax.numpy as jnp

    from armour_tpu import collision as jcol
    from armour_tpu_torch.pz.basis import make_basis

    jfrs, jobs, frs, obs = jax_cells
    hyp = tcol.build_hyperplanes(frs, obs)
    assert hyp.frs is frs and hyp.dims == (T, 7, O) and hyp._planes is None
    rng = np.random.default_rng(7)
    k = torch.as_tensor(rng.uniform(-1, 1, (WN, 3, 7)))
    p_all = tcol.eval_link_polys(frs, make_basis(7, 3).phi(k))
    p_all[1, 2, :, 9] = float("nan")                 # one (time, link) cell of one query
    g = tcol.collision_constraints(hyp, obs, p_all)
    assert g.shape == (WN, 3, T, 7, O)
    for w in range(WN):
        jhyp = jcol.build_hyperplanes(jfrs[w], jobs[w])
        assert bool((jnp.abs(jhyp.A).sum(0) == 0).any())   # the zero radius' degenerate pairs
        for q in range(3):
            jg = np.asarray(jcol.collision_constraints(jhyp, jobs[w],
                                                       jnp.asarray(p_all[w, q].numpy())))
            tg = g[w, q].numpy()
            assert np.array_equal(np.isnan(tg), np.isnan(jg))
            fin = ~np.isnan(jg)
            np.testing.assert_allclose(tg[fin], jg[fin], rtol=1e-9, atol=1e-12)
    assert int(torch.isnan(g).sum()) == int(obs.mask[1].sum())
    n_real = int(obs.mask[0].sum())
    assert bool((g[0, :, :, :, n_real:] == -tcol.BIG).all())


def test_plan_problem_hyperplanes_formed_on_read_match_jax():
    """plan_problem's hyperplanes (cells, formed on first read) against the
    JAX package's build_hyperplanes of the same cells (1e-9, float64), and
    its solve against the solve of the same problem with hyperplanes made
    from tensors: the same SolveResult bits."""
    import jax.numpy as jnp

    from armour_tpu import collision as jcol
    from armour_tpu.kinematics import LinkFRS as JLinkFRS
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.models.kinova import kinova_gen3
    from armour_tpu_torch.nlp import solve
    from armour_tpu_torch.planner import plan_problem
    from armour_tpu_torch.pz.basis import make_basis

    cfg = ArmourConfig(dtype=torch.float64, num_time_steps=T, max_obstacles=O, screen_k=64,
                       solver_seeds=2, solver_keep_seeds=1, solver_outer_iters=2,
                       solver_inner_iters=2)
    basis = make_basis(7, 3)
    obs = tcol.stack_obstacles([tcol.pad_obstacles(*_obstacles(n, w), O, torch.float64)
                                for w, (_, n) in enumerate(SCENES)])
    q0 = torch.as_tensor(np.stack([q for q, _ in SCENES]))
    z = torch.zeros_like(q0)
    prob = plan_problem(q0, z, z, q0 + 0.05, obs, kinova_gen3(), cfg, basis)
    hyp = prob.hyp
    assert hyp.frs is prob.frs and hyp.obs is obs
    for w in range(WN):
        jfrs = JLinkFRS(*(jnp.asarray(getattr(prob.frs, f)[w].numpy())
                          for f in ("center_coef", "shape_gens", "radius")))
        jobs = jcol.ObstacleSet(*(jnp.asarray(getattr(obs, f)[w].numpy())
                                  for f in ("centers", "generators", "mask")))
        jhyp = jcol.build_hyperplanes(jfrs, jobs)
        for f in ("A", "d", "delta"):
            np.testing.assert_allclose(getattr(hyp, f)[w].numpy(), np.asarray(getattr(jhyp, f)),
                                       rtol=1e-9, atol=1e-12)
    eager = tcol.Hyperplanes(hyp.A.clone(), hyp.d.clone(), hyp.delta.clone(), hyp.dims)
    got = solve(prob, cfg, basis)
    want = solve(dataclasses.replace(prob, hyp=eager), cfg, basis)
    for f in ("k", "feasible", "cost", "viol"):
        a, b = getattr(got, f), getattr(want, f)
        assert torch.equal(torch.nan_to_num(a.double(), 9.0), torch.nan_to_num(b.double(), 9.0)), f


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, to drive the CUDA routes
    into stubbed launchers."""

    @property
    def is_cuda(self):
        return True


def _on_card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


def _cells(Wn=2, Tn=3, Jn=7, On=4):
    frs = tcol.LinkFRS(center_coef=torch.zeros(Wn, Tn, Jn, 3, 10),
                       shape_gens=torch.zeros(Wn, Tn, Jn, 3, 3),
                       radius=_on_card(torch.zeros(Wn, Tn, Jn, 3)))
    obs = tcol.ObstacleSet(centers=torch.zeros(Wn, On, 3), generators=torch.zeros(Wn, On, 3, 3),
                           mask=torch.ones(Wn, On, dtype=torch.bool))
    return frs, obs


def test_cells_route_to_the_cell_mode_and_tensors_to_the_row_mode(monkeypatch):
    """On the card collision_constraints hands Hyperplanes made from the cells
    to K4's cell mode (their A never formed) and Hyperplanes made from
    tensors to K4's row mode over all N rows (row n // O, mask obs.mask[n %
    O]); screen_collision reads nothing of either."""
    calls = []

    def cells(*a, **k):
        calls.append(("cells", a))
        return torch.zeros(a[-1].shape[0], a[-1].shape[1], a[1].shape[1] * a[1].shape[2]
                           * a[-2].shape[-1])

    def rows(A, d, delta, row, mask, p_all, dp_all=None, **k):
        calls.append(("rows", (A, d, delta, row, mask)))
        return torch.zeros(p_all.shape[0], p_all.shape[1], row.shape[0]), None

    def screen(*a):
        calls.append(("screen", a))
        return (None,) * 5

    monkeypatch.setattr(kcol, "collision_cells", cells)
    monkeypatch.setattr(kcol, "collision_rows", rows)
    monkeypatch.setattr(kcol, "screen_collision", screen)
    monkeypatch.setattr(kcol, "build_hyperplanes",
                        lambda *a: pytest.fail("K3 ran on the planning route"))
    frs, obs = _cells()
    Wn, Tn, Jn, _ = frs.radius.shape
    On = obs.mask.shape[1]
    p_all = _on_card(torch.zeros(Wn, 4, 3, Tn * Jn))
    hyp = tcol.build_hyperplanes(frs, obs)
    g = tcol.collision_constraints(hyp, obs, p_all)
    tcol.screen_collision(hyp, obs, frs, 16)
    assert g.shape == (Wn, 4, Tn, Jn, On) and hyp._planes is None
    (kind, a), (kind2, _) = calls
    assert (kind, kind2) == ("cells", "screen")
    assert a[0] is frs.shape_gens and a[1] is frs.radius and a[2] is obs.centers
    assert a[3] is obs.generators and a[4] is obs.mask and a[5] is p_all

    calls.clear()
    N = Tn * Jn * On
    A = torch.zeros(Wn, 3, 36, N)
    d = torch.zeros(Wn, 36, N)
    obs.mask[1, 2] = False
    flat = tcol.Hyperplanes(A, d, d, (Tn, Jn, On))
    g = tcol.collision_constraints(flat, obs, p_all)
    (kind, (A_, d_, _, row, mask)), = calls
    assert kind == "rows" and A_ is A and d_ is d and g.shape == (Wn, 4, Tn, Jn, On)
    assert torch.equal(row.long(), torch.arange(N) // On)
    assert torch.equal(mask, obs.mask[:, None, :].expand(Wn, Tn * Jn, On).reshape(Wn, N))


def test_hyperplanes_take_tensors_or_cells_not_both():
    frs, obs = _cells()
    A = torch.zeros(2, 3, 36, 84)
    with pytest.raises(ValueError, match="either"):
        tcol.Hyperplanes(A, A, A, (3, 7, 4), frs=frs, obs=obs)
    with pytest.raises(ValueError, match="either"):
        tcol.Hyperplanes(dims=(3, 7, 4))
    with pytest.raises(ValueError, match="either"):
        tcol.Hyperplanes(frs=frs)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels are built with nvcc there)")
    return torch.device("cuda")


def _same(a, b) -> bool:
    """Equal bits, NaN at the same places."""
    return (a is None and b is None) or (
        torch.equal(torch.isnan(a), torch.isnan(b))
        and torch.equal(torch.nan_to_num(a, 7.0), torch.nan_to_num(b, 7.0)))


def _card_problem(dev, Wn=3, Tn=16):
    """A float32 Kinova plan of the first saved worlds on the card, with a
    zero-radius link on a copy of its sets."""
    import glob

    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.models.kinova import kinova_gen3
    from armour_tpu_torch.planner import plan_problem
    from armour_tpu_torch.pz.basis import make_basis
    from armour_tpu_torch.worlds import load_world_csv, straight_line_waypoint

    robot = kinova_gen3()
    cfg = ArmourConfig(dtype=torch.float32, num_time_steps=Tn, screen_k=512)
    basis = make_basis(7, 3)
    ws = [load_world_csv(p) for p in sorted(glob.glob("saved_worlds/random/*.csv"))[:Wn]]
    q0 = torch.as_tensor(np.stack([w.start for w in ws]), dtype=torch.float32, device=dev)
    q_des = torch.as_tensor(np.stack([straight_line_waypoint(w.start, w.goal,
                                                             continuous=robot.continuous_joints)
                                      for w in ws]), dtype=torch.float32, device=dev)
    obs = tcol.stack_obstacles([tcol.pad_obstacles(w.obstacle_centers, w.obstacle_generators,
                                                   cfg.max_obstacles, cfg.dtype) for w in ws])
    obs = tcol.ObstacleSet(centers=obs.centers.to(dev), generators=obs.generators.to(dev),
                           mask=obs.mask.to(dev))
    z = torch.zeros_like(q0)
    prob = plan_problem(q0, z, z, q_des, obs, robot, cfg, basis)
    return cfg, basis, prob


def _queries(prob, basis, Q, seed):
    g = torch.Generator().manual_seed(seed)
    Wn = prob.frs.radius.shape[0]
    k = ((torch.rand(Wn, Q, 7, generator=g) * 2 - 1) * 0.9).to(prob.frs.radius.device)
    p_all = tcol.eval_link_polys(prob.frs, basis.phi(k)).contiguous()
    dp_all = tcol.eval_link_poly_grads(prob.frs, basis.dphi(k)).contiguous()
    p_all[0, Q - 1, :, 5] = float("nan")            # a non-finite line-search point
    return p_all, dp_all


@pytest.mark.cuda
def test_k4_cell_mode_matches_the_row_mode_over_k3_on_the_card():
    """The cell mode at every group size gives K4's row mode over K3's
    tensors of the same cells bit for bit (also with a zero-radius link, and
    with real obstacles scattered among the slots or none in a world),
    within 1e-5 of the plain check, and no K3 launch."""
    from armour_tpu_torch import kernels

    dev = _card()
    _, basis, prob = _card_problem(dev)
    frs, obs = prob.frs, prob.obs
    zero = tcol.LinkFRS(center_coef=frs.center_coef, shape_gens=frs.shape_gens,
                        radius=frs.radius.clone())
    zero.radius[:, :, ZERO_LINK] = 0.0
    # the cell mode takes a world's real rows first: also obstacles that are
    # no prefix of the slots, and a world with none
    mixed = obs.mask.clone()
    mixed[0] = mixed[0].roll(7)
    mixed[1] = False
    scattered = tcol.ObstacleSet(centers=obs.centers, generators=obs.generators, mask=mixed)
    for f, ob in ((frs, obs), (zero, obs), (frs, scattered)):
        A, d, delta = kcol.build_hyperplanes(f.shape_gens, f.radius, ob.centers, ob.generators)
        flat = tcol.Hyperplanes(A, d, delta, prob.hyp.dims)
        for Q in (1, 4, 12):
            p_all, _ = _queries(prob, basis, Q, Q)
            want = tcol.collision_constraints(flat, ob, p_all)
            kernels.reset_counts()
            got = tcol.collision_constraints(tcol.build_hyperplanes(f, ob), ob, p_all)
            assert kernels.counts()["build_hyperplanes"] == 0
            assert kernels.counts()["collision_rows"] == 1
            assert _same(got, want)
            for G in kcol.K4_GROUPS:
                g = kcol._collision_cells(f.shape_gens, f.radius, ob.centers, ob.generators,
                                          ob.mask, p_all, G)
                assert _same(g.reshape(want.shape), want), (Q, G)
            plain = tcol.collision_constraints_plain(flat, ob, p_all)
            assert torch.equal(torch.isnan(plain), torch.isnan(got))
            fin = torch.isfinite(plain)
            assert float((got - plain)[fin].abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("tau", [0.0, 0.01], ids=["hard", "smooth"])
def test_k4_screened_groups_match_g1_on_the_card(tau):
    """The screened rows at every group size G give the G = 1
    instantiation's g and dg bit for bit, with and without dg, at Q = 1, 4
    and 12, in the hard and the smooth mode."""
    dev = _card()
    _, basis, prob = _card_problem(dev)
    sc = prob.screened
    for Q in (1, 4, 12):
        p_all, dp_all = _queries(prob, basis, Q, 100 + Q)
        for dp in (None, dp_all):
            want = kcol._collision_rows(sc.A, sc.d, sc.delta, sc.row, sc.mask, p_all, dp,
                                        tau, 1)
            for G in kcol.K4_GROUPS[1:]:
                got = kcol._collision_rows(sc.A, sc.d, sc.delta, sc.row, sc.mask, p_all, dp,
                                           tau, G)
                assert _same(got[0], want[0]) and _same(got[1], want[1]), (Q, G, dp is None)

"""Launch geometry of kernels K5 (rollout), K7 (alm_newton), K8
(alm_values), K9 (fk_chain) and K10 (rnea_chain), pure Python on the CPU: every row,
query, seed, chain and element is covered exactly once,
the grid reaches 2 x 132 CTAs wherever the work allows, and the shared
memory each block asks for fits the H100 (227 KB a block, 228 KB an SM), so
that a launch the card would refuse shows up here.  The Python mirrors of
the kernels' shared-memory formulas are held against the constants of the
CUDA sources.

The last five tests run K5, K7, K8, K9 and K10 against their plain versions
on the card (marked cuda; they skip where there is none)."""

import re

import numpy as np
import pytest
import torch

from armour_tpu_torch.kernels import build, reach, sim as ksim, solver as ks

SMS = 132
BLOCK_SMEM = 232448
# flagship widths: Kinova Gen3 (T = 128, J = F = 7), B = 120, E = 38, K = 4096
T, J, F, B, E, K = 128, 7, 7, 120, 38, 4096
N_POLY = 3 * T * J + T * F
LD, LDL = B + E + 1, reach.lin_ld(F, E)
WORLDS = [1, 64, 128]
QUERIES = [2, 4, 6, 12]
SEEDS = [2, 4]


def _source(name):
    return (build.CSRC / name).read_text()


def _define(text, name):
    return int(re.search(r"#define %s (\d+)" % name, text).group(1))


@pytest.mark.parametrize("Wn", WORLDS)
@pytest.mark.parametrize("Q", QUERIES)
def test_k8_rows_and_queries_covered_once(Wn, Q):
    geo = ks.k8_geometry(Wn, Q, N_POLY, K)
    # step (a): tile t takes rows [t R, t R + R); every query of every tile
    rows = np.zeros(N_POLY, dtype=int)
    for t in range(geo.tiles_a):
        rows[t * geo.R:min((t + 1) * geo.R, N_POLY)] += 1
    assert (rows == 1).all() and (geo.tiles_a - 1) * geo.R < N_POLY
    # step (b): thread x of CTA (bx, by) takes row bx 128 + x and queries by G ..
    pairs = np.zeros((K, Q), dtype=int)
    for bx in range(geo.tiles_b):
        r = np.arange(bx * ks.K8_COL_THREADS, (bx + 1) * ks.K8_COL_THREADS)
        r = r[r < K]
        for by in range(-(-Q // geo.G)):
            q = np.arange(by * geo.G, min((by + 1) * geo.G, Q))
            pairs[np.ix_(r, q)] += 1
    assert (pairs == 1).all()
    # the scratch of link centres holds every query group whole
    assert geo.Qp % geo.G == 0 and Q <= geo.Qp < Q + geo.G


@pytest.mark.parametrize("Wn", WORLDS)
@pytest.mark.parametrize("Q", QUERIES)
def test_k8_grid_fills_the_card(Wn, Q):
    geo = ks.k8_geometry(Wn, Q, N_POLY, K, SMS)
    ctas_a, ctas_b = geo.ctas(Wn, Q)
    # step (a): the smallest tile is 8 rows
    if Wn * N_POLY >= 2 * SMS * ks.K8_TILES[-1]:
        assert ctas_a >= 2 * SMS
    else:
        assert geo.R == ks.K8_TILES[-1]
    # step (b): one row and one query per thread at the least
    if Wn * K * Q >= 2 * SMS * ks.K8_COL_THREADS:
        assert ctas_b >= 2 * SMS
    else:
        assert geo.G == 1
    # the widest tile and group that do (each row read once for more queries)
    bigger = [r for r in ks.K8_TILES if r > geo.R]
    assert all(Wn * -(-N_POLY // r) < 2 * SMS for r in bigger)


@pytest.mark.parametrize("R", ks.K8_TILES)
def test_k8_shared_memory_fits(R):
    text = _source("alm_values.cu")
    assert _define(text, "K8_MAXQ") == ks.K8_MAXQ
    assert _define(text, "K8A_THREADS") == ks.K8_ROWS_THREADS
    assert _define(text, "K8B_THREADS") == ks.K8_COL_THREADS
    assert ks.k8_pitch(B) == 124 and (ks.k8_pitch(B) // 4) % 2 == 1
    assert ks.k8_rows_smem(B, R) <= BLOCK_SMEM
    assert ks.k8_rows_smem(ks.MAX_B, R) <= BLOCK_SMEM


def test_k8_takes_at_most_16_queries():
    with pytest.raises(ValueError, match="queries"):
        ks.k8_geometry(1, 17, N_POLY, K)


@pytest.mark.parametrize("Wn", WORLDS)
@pytest.mark.parametrize("S", SEEDS)
def test_k7_rows_covered_once(Wn, S):
    """Step (a)'s tiles take every polynomial row once, the tiles from
    t_first on hold every torque row, step (b)'s tiles every screened row
    once, and each of those tiles owns one partial slot per seed."""
    n_centre, n_torque = 3 * T * J, T * F
    geo = ks.k7_geometry(Wn, S, n_centre, n_torque, K)
    rows = np.zeros(N_POLY, dtype=int)
    for t in range(geo.tiles_a):
        rows[t * geo.R:min((t + 1) * geo.R, N_POLY)] += 1
    assert (rows == 1).all() and (geo.tiles_a - 1) * geo.R < N_POLY
    # tiles before t_first hold centre rows only; t_first holds the first torque row
    assert geo.t_first * geo.R <= n_centre < (geo.t_first + 1) * geo.R
    screened = np.zeros(K, dtype=int)
    for t in range(geo.tiles_b):
        screened[t * geo.RB:min((t + 1) * geo.RB, K)] += 1
    assert (screened == 1).all()
    slots = [("a", t) for t in range(geo.t_first, geo.tiles_a)] + \
        [("b", t) for t in range(geo.tiles_b)]
    assert len(slots) == geo.npart
    # step (c): a CTA per (world, seed)
    assert geo.ctas(Wn, S)[2] == Wn * S


@pytest.mark.parametrize("Wn", WORLDS)
@pytest.mark.parametrize("S", SEEDS)
def test_k7_grid_fills_the_card(Wn, S):
    geo = ks.k7_geometry(Wn, S, 3 * T * J, T * F, K, SMS)
    ctas_a, ctas_b, _ = geo.ctas(Wn, S)
    if Wn * N_POLY >= 2 * SMS * ks.K7_TILES[-1]:
        assert ctas_a >= 2 * SMS
    else:
        assert geo.R == ks.K7_TILES[-1]
    if Wn * K >= 2 * SMS * ks.K7_COL_TILES[-1]:
        assert ctas_b >= 2 * SMS
    else:
        assert geo.RB == ks.K7_COL_TILES[-1]
    # the largest tiles that do (each row read once for all seeds, fewer partials)
    assert all(Wn * -(-N_POLY // r) < 2 * SMS for r in ks.K7_TILES if r > geo.R)
    assert all(Wn * -(-K // r) < 2 * SMS for r in ks.K7_COL_TILES if r > geo.RB)


@pytest.mark.parametrize("R", ks.K7_TILES)
@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_k7_shared_memory_fits(R, S):
    text = _source("alm_newton.cu")
    assert _define(text, "K7_MAXS") == ks.K7_MAXS
    assert _define(text, "K7A_THREADS") == ks.K7_ROWS_THREADS
    assert _define(text, "K7C_THREADS") == ks.K7_FINISH_THREADS
    assert _define(text, "K7C_CHUNKS") == ks.K7_FINISH_CHUNKS
    assert re.search(r"case %d: err = k7_rows<NF, %d>" % (R, R), text)
    assert ks.k7_nacc(F) == 37 and ks.k7_nacc(F) * ks.K7_FINISH_CHUNKS <= ks.K7_FINISH_THREADS
    # the torque values of step (a) reuse the staged rows' space
    assert S * (1 + F) <= ks.k8_pitch(B)
    assert re.search(r"__shared__ float red\[SM\]\[\(R \+ 31\) / 32\]\[NACC\]", text)
    static = ks.k7_rows_static_smem(F, S, R)
    assert static == 4 * {1: 1, 2: 2, 4: 4, 8: 8}[S] * -(-R // 32) * 37
    assert ks.k7_rows_smem(B, F, S, R) + static <= BLOCK_SMEM
    assert ks.k7_rows_smem(ks.MAX_B, F, S, R) + static <= BLOCK_SMEM
    # above 48 KB a block only by opt-in: the launcher always asks for it
    assert "cudaFuncSetAttribute(k7_rows_kernel<NF, R, SM>" in text


def test_k7_takes_at_most_8_seeds():
    with pytest.raises(ValueError, match="seeds"):
        ks.k7_geometry(1, 9, 3 * T * J, T * F, K)


@pytest.mark.parametrize("J_, F_", [(7, 7), (7, 6), (6, 6), (8, 7), (8, 8), (1, 1), (7, 1)])
def test_k5_lanes_cover_every_chain(J_, F_):
    """K5 runs the 2 + 4J + F chains of a control step in one round: one
    lane each, 32 lanes when they fit one warp, else 64; the Gauss-Jordan
    inverse takes 2F lanes of the first warp, and rollout.cu has the
    instantiation."""
    lanes = ksim.k5_geometry(J_, F_)
    chains = ksim.k5_chains(J_, F_)
    assert chains == 2 + 4 * J_ + F_ and chains <= lanes and 2 * F_ <= 32
    assert lanes == (32 if chains <= 32 else 64)
    text = _source("rollout.cu")
    assert re.search(r"case %d: return k5_go<%d, %d>" % (J_, J_, lanes), text)


def test_k5_geometry_refuses_what_the_kernel_does_not_take():
    for J_, F_ in ((9, 7), (7, 8), (7, 0)):
        with pytest.raises(ValueError, match="closed-loop"):
            ksim.k5_geometry(J_, F_)


@pytest.mark.parametrize("Wn", WORLDS)
def test_k10_elements_covered_once(Wn):
    n = Wn * T
    geo = reach.k10_geometry(n, LD, LDL, SMS)
    seen = np.zeros(n, dtype=int)
    for b in range(geo.grid):
        for gi in range(geo.NG):
            seen[geo.elements(b, gi, n)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("Wn", WORLDS)
def test_k10_grid_fills_the_card(Wn):
    n = Wn * T
    geo = reach.k10_geometry(n, LD, LDL, SMS)
    assert geo.G in (32, 64, 256) and geo.NG <= 15
    assert geo.G * geo.NG <= max(reach.K10_THREADS, geo.G)
    if n >= 2 * SMS:
        assert geo.grid >= 2 * SMS
    else:
        # one element per block, eight warps each: W = 1 spreads over the card
        assert geo.NG == 1 and geo.grid == n and geo.G == 256
    # the persistent grid never asks for more blocks than the card holds at once
    per_sm = reach.SM_SMEM // (reach.k10_smem(LD, LDL, geo.NG) + reach.BLOCK_SMEM_RESERVED)
    assert per_sm >= 1 and geo.grid <= SMS * per_sm


def test_k10_shared_memory_fits():
    ops, k10 = _source("pz_ops.cuh"), _source("rnea_chain.cu")
    assert _define(ops, "PZ_TAB_BYTES") == reach.PZ_TAB_BYTES
    assert _define(ops, "PZ_MAXMASS") == reach.PZ_MAXMASS
    assert 3 * _define(k10, "K10_SLOTS") + 3 * _define(k10, "K10_TEMPS") == reach.K10_ENTRIES
    assert LDL == 52 and LDL % 4 == 0
    # up to K10_THREADS threads a block, three blocks an SM
    assert re.search(r"__launch_bounds__\(G > %d \? G : %d, G > %d \? 1 : 3\)"
                     % ((reach.K10_THREADS,) * 3), k10)
    for NG in (1, 2, 4):
        assert reach.k10_smem(LD, LDL, NG) <= BLOCK_SMEM
    # four warps a block, three blocks an SM at the flagship widths
    assert 3 * (reach.k10_smem(LD, LDL, 4) + reach.BLOCK_SMEM_RESERVED) <= reach.SM_SMEM


K9_WORLDS = [1, 4, 64, 512]


@pytest.mark.parametrize("Wn", K9_WORLDS)
def test_k9_elements_covered_once(Wn):
    n = Wn * T
    geo = reach.k9_geometry(n, LD, LDL, SMS)
    seen = np.zeros(n, dtype=int)
    for b in range(geo.grid):
        for gi in range(geo.NG):
            seen[geo.elements(b, gi, n)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("Wn", K9_WORLDS)
def test_k9_grid_fills_the_card(Wn):
    n = Wn * T
    geo = reach.k9_geometry(n, LD, LDL, SMS)
    assert geo.G in (32, 64, 256) and geo.NG <= 15 and geo.G * geo.NG <= reach.K9_THREADS
    if n >= 2 * SMS:
        assert geo.grid >= 2 * SMS
    else:
        # one element per block, eight warps each: W = 1 spreads over the card
        assert geo.NG == 1 and geo.grid == n and geo.G == 256
    if n >= 8 * SMS:
        # a warp per element, eight a block, two blocks an SM
        assert geo.G == 32 and geo.NG == 8 and geo.grid == 2 * SMS
    per_sm = reach.SM_SMEM // (reach.k9_smem(LD, LDL, geo.NG) + reach.BLOCK_SMEM_RESERVED)
    assert per_sm >= 1 and geo.grid <= SMS * per_sm


def test_k9_shared_memory_fits():
    ops, k9 = _source("pz_ops.cuh"), _source("fk_chain.cu")
    assert _define(ops, "PZ_TAB_BYTES") == reach.PZ_TAB_BYTES
    assert _define(ops, "PZ_MAXMASS") == reach.PZ_MAXMASS
    assert 3 * _define(k9, "K9_SLOTS") + 3 == reach.K9_ENTRIES
    assert _define(k9, "K9_THREADS") == reach.K9_THREADS
    assert _define(k9, "K9_MAXJ") == reach.MAX_J
    # at most K9_THREADS threads a block, two blocks an SM
    assert re.search(r"__launch_bounds__\(K9_THREADS, 2\)", k9)
    for NG in range(1, reach.K9_THREADS // 32 + 1):
        assert reach.k9_smem(LD, LDL, NG) <= BLOCK_SMEM
    assert 2 * (reach.k9_smem(LD, LDL, 8) + reach.BLOCK_SMEM_RESERVED) <= reach.SM_SMEM
    # past 48 KB a launch needs the opt-in: it is asked for on every launch,
    # whatever the size (a conditional opt-in was K7's cudaError 1)
    launch = k9[k9.index('extern "C" int k9_launch'):]
    assert re.search(r"\n  cudaError_t err = cudaFuncSetAttribute\(k9_kernel, "
                     r"cudaFuncAttributeMaxDynamicSharedMemorySize", launch)
    assert reach.k9_smem(LD, LDL, 8) > 48 * 1024


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels are built with nvcc there)")
    return torch.device("cuda")


def _small_problem(dev):
    import glob

    from armour_tpu_torch.collision import pad_obstacles, stack_obstacles
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.models.kinova import kinova_gen3
    from armour_tpu_torch.planner import plan_problem
    from armour_tpu_torch.pz.basis import make_basis
    from armour_tpu_torch.worlds import load_world_csv, straight_line_waypoint

    robot = kinova_gen3()
    cfg = ArmourConfig(dtype=torch.float32, num_time_steps=16, screen_k=512)
    basis = make_basis(7, 3)
    ws = [load_world_csv(p) for p in sorted(glob.glob("saved_worlds/random/*.csv"))[:3]]
    rng = np.random.default_rng(0)
    q0 = torch.as_tensor(np.stack([w.start for w in ws]), dtype=torch.float32, device=dev)
    qd0 = torch.as_tensor(rng.uniform(-0.3, 0.3, q0.shape), dtype=torch.float32, device=dev)
    q_des = torch.as_tensor(np.stack([straight_line_waypoint(w.start, w.goal,
                                                             continuous=robot.continuous_joints)
                                      for w in ws]), dtype=torch.float32, device=dev)
    obs = stack_obstacles([pad_obstacles(w.obstacle_centers, w.obstacle_generators,
                                         cfg.max_obstacles, cfg.dtype) for w in ws])
    obs = type(obs)(centers=obs.centers.to(dev), generators=obs.generators.to(dev),
                    mask=obs.mask.to(dev))
    return robot, cfg, basis, plan_problem(q0, qd0, 0.5 * qd0, q_des, obs, robot, cfg, basis)


@pytest.mark.cuda
def test_k8_matches_its_plain_version_on_the_card():
    """Merit within 1e-4 |merit|, rows within 1e-5 of their terms, feasibility
    identical but for queries with a row that close to its threshold, and
    the same bits on a second call."""
    from armour_tpu_torch import nlp

    dev = _card()
    robot, cfg, basis, prob = _small_problem(dev)
    rows = ks.alm_rows(prob, cfg, basis)
    Wn, S, A = prob.q_des.shape[0], 4, 3
    g = torch.Generator().manual_seed(0)
    kq = ((torch.rand(Wn, S * A, 7, generator=g) * 2 - 1) * 0.5).to(dev)
    lam = (torch.rand(Wn, S, rows.M, generator=g) * 3).to(dev)
    rho = torch.full((Wn, S), 10.0, device=dev)
    seed = torch.arange(S, dtype=torch.int32).repeat_interleave(A).to(dev)
    m, f, c = ks.alm_values(rows, kq, lam, rho, seed, True)
    m2, f2, c2 = ks.alm_values(rows, kq, lam, rho, seed, True)
    m0, f0, c0 = nlp.alm_values_plain(kq, lam, rho, seed, prob, cfg, basis, True)
    assert torch.equal(m, m2) and torch.equal(c, c2) and torch.equal(f, f2)
    assert ((m - m0).abs() <= 1e-4 * (m0.abs() + 1e-6)).all()
    # a torque row's terms: sum_b |u_coef_b phi_b| + |hi|, twice (+u - hi, -u - hi)
    t = (torch.matmul(basis.phi(kq).abs(), rows.tensors["u_coef"].abs().transpose(1, 2))
         + rows.tensors["u_hi"].abs()[:, None])
    mag = 1.0 + c0.abs()
    mag[..., :2 * rows.args.TF] += torch.cat([t, t], dim=-1)
    assert ((c - c0).abs() <= 1e-5 * mag).all()
    near = ((c0 - nlp._stack_thresholds(prob, cfg)).abs() <= 1e-5 * mag).any(-1)
    assert ((f == f0) | near).all()


@pytest.mark.cuda
def test_k10_matches_its_plain_version_on_the_card():
    """Every entry within 1e-5 of the plain entry's total mass, and the same
    bits on a second call."""
    from armour_tpu_torch import dynamics
    from armour_tpu_torch.jrs import build_jrs

    dev = _card()
    robot, cfg, basis, prob = _small_problem(dev)
    rng = np.random.default_rng(1)
    q = [torch.as_tensor(rng.uniform(-0.5, 0.5, (3, 7)), dtype=torch.float32, device=dev)
         for _ in range(3)]
    jrs = build_jrs(*q, robot, cfg, basis)
    got = reach.rnea_chain(jrs, robot, cfg, basis)
    again = reach.rnea_chain(jrs, robot, cfg, basis)
    ref = dynamics.rnea_pz_sets_plain(jrs, robot, cfg, basis)
    mass = ref.coef.abs().sum(-1) + ref.egen.abs().sum(-1) + ref.rad.abs()
    for f in ("coef", "egen", "rad"):
        assert torch.equal(getattr(got, f), getattr(again, f))
        m = mass if f == "rad" else mass[..., None]
        assert ((getattr(got, f) - getattr(ref, f)).abs() <= 1e-5 * (m + 1e-6)).all()


@pytest.mark.cuda
def test_k9_matches_its_plain_version_on_the_card():
    """Every link entry within 1e-5 of the plain entry's total mass, the
    same bits on a second call and under other launch geometries."""
    from armour_tpu_torch import kinematics
    from armour_tpu_torch.jrs import build_jrs

    dev = _card()
    robot, cfg, basis, _ = _small_problem(dev)
    rng = np.random.default_rng(2)
    q = [torch.as_tensor(rng.uniform(-0.5, 0.5, (3, 7)), dtype=torch.float32, device=dev)
         for _ in range(3)]
    jrs = build_jrs(*q, robot, cfg, basis)
    got = reach.fk_chain(jrs, robot, cfg, basis)
    ref = kinematics.forward_occupancy_plain(jrs, robot, cfg, basis)
    mass = ref.coef.abs().sum(-1) + ref.egen.abs().sum(-1) + ref.rad.abs()
    for f in ("coef", "egen", "rad"):
        m = mass if f == "rad" else mass[..., None]
        assert ((getattr(got, f) - getattr(ref, f)).abs() <= 1e-5 * (m + 1e-6)).all()
    default = reach.k9_geometry
    try:
        for G, NG, grid in ((256, 1, 5), (64, 2, 7), (32, 8, 1), (32, 3, 2), (None, 0, 0)):
            if G is not None:
                reach.k9_geometry = lambda *a, g=reach.ChainGeometry(G, NG, grid), **k: g
            else:
                reach.k9_geometry = default
            again = reach.fk_chain(jrs, robot, cfg, basis)
            assert all(torch.equal(getattr(got, f), getattr(again, f))
                       for f in ("coef", "egen", "rad")), (G, NG, grid)
    finally:
        reach.k9_geometry = default


@pytest.mark.cuda
def test_k7_matches_its_plain_version_on_the_card():
    """m0 within 1e-4 |m0|, g and H within 1e-4 of their summed terms, the
    step's backward error within 1e-4, feasibility identical, and the same
    bits on a second call (seeds 4 and 2)."""
    from armour_tpu_torch import nlp

    dev = _card()
    robot, cfg, basis, prob = _small_problem(dev)
    rows = ks.alm_rows(prob, cfg, basis)
    Wn = prob.q_des.shape[0]
    g = torch.Generator().manual_seed(0)
    for S in (4, 2):
        k = ((torch.rand(Wn, S, 7, generator=g) * 2 - 1) * 0.5).to(dev)
        lam = (torch.rand(Wn, S, rows.M, generator=g) * 3).to(dev)
        rho = torch.full((Wn, S), 10.0, device=dev)
        got = ks.alm_newton(rows, k, lam, rho, want_system=True)
        again = ks.alm_newton(rows, k, lam, rho, want_system=True)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        step, m0, feas, gk, Hk = got
        _, m00, f0 = nlp.alm_newton_plain(k, lam, rho, prob, cfg, basis)
        g0, H0, c0 = nlp.alm_newton_system(k, lam, rho, prob, cfg, basis)
        _, Jc = nlp.constraint_stack(k, prob, cfg, basis, with_grad=True)
        z0 = lam + rho[..., None] * c0
        w = torch.where(z0 > 0, rho[..., None], torch.zeros_like(c0))
        le = torch.where(z0 > 0, z0, torch.zeros_like(c0))
        Ja = Jc.abs()
        g_mag = nlp.plan_cost_grad(k, prob.traj, prob.q_des, prob.limits.continuous,
                                   cfg).abs() + (Ja * le[..., None]).sum(-2)
        H_mag = torch.matmul(Ja.transpose(-1, -2) * w[..., None, :], Ja) \
            + nlp.plan_cost_hessian(prob.traj, cfg) + 1e-3
        assert ((m0 - m00).abs() <= 1e-4 * (m00.abs() + 1e-6)).all()
        assert ((gk - g0).abs() <= 1e-4 * (g_mag + 1e-6)).all()
        assert ((Hk - H0).abs() <= 1e-4 * (H_mag + 1e-6)).all()
        resid = (torch.matmul(H0, step[..., None])[..., 0] - g0).abs()
        assert (resid <= 1e-4 * (torch.matmul(H0.abs(), step.abs()[..., None])[..., 0]
                                 + g0.abs() + 1e-6)).all()
        assert torch.equal(feas, f0)


@pytest.mark.cuda
def test_k5_matches_its_plain_version_on_the_card():
    """A 60-step move of three worlds under each controller: |dq| <= 1e-4
    rad, |dqd| <= 1e-3 rad/s, |du| <= 1e-4 (|u| + 1), and the same bits on
    a second call."""
    from armour_tpu_torch import simulator as tsim
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.controller import ALTHOFF_DEFAULT
    from armour_tpu_torch.models.kinova import kinova_gen3

    dev = _card()
    robot, cfg = kinova_gen3(), ArmourConfig(dtype=torch.float32)
    rng = np.random.default_rng(0)
    Wn, n = 3, 60

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev).contiguous()

    q, qd = f32(rng.uniform(-1, 1, (Wn, 7))), f32(rng.uniform(-0.3, 0.3, (Wn, 7)))
    t = np.arange(n) * 1e-3
    amp = [rng.uniform(-1, 1, (Wn, 1, 7)) for _ in range(3)]
    q_des = f32(q.cpu().numpy()[:, None] + 0.2 * np.sin(3 * t)[None, :, None] * amp[0])
    qd_des = f32(0.6 * np.cos(3 * t)[None, :, None] * amp[1])
    qdd_des = f32(-1.8 * np.sin(3 * t)[None, :, None] * amp[2])
    tps = [tsim.sample_true_params(robot, rng, scale=1.0) for _ in range(Wn)]
    tp = tsim.TrueParams(*(f32(np.stack([getattr(x, a).numpy() for x in tps]))
                           for a in ("mass", "inertia", "com")))
    noise = f32(1e-4 * rng.standard_normal((Wn, n, 2, 7)))
    for controller, nz in (("robust", None), ("althoff", None), ("nominal", None),
                           ("robust", noise)):
        a = (robot, cfg, q, qd, q_des, qd_des, qdd_des, tp, 1e-3, 2, controller, nz,
             ALTHOFF_DEFAULT)
        got, again = ksim.rollout(*a), ksim.rollout(*a)
        ref = tsim.rollout_plain(*a)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        assert float((got[2] - ref[2]).abs().max()) <= 1e-4
        assert float((got[3] - ref[3]).abs().max()) <= 1e-3
        assert ((got[4] - ref[4]).abs() <= 1e-4 * (ref[4].abs() + 1.0)).all()

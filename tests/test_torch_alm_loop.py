"""The solve loop's bookkeeping (kernel K14, csrc/alm_loop.cu) and the row
kernels' cost and max mode.

CPU, against the JAX package: every plain bookkeeping function of
armour_tpu_torch/nlp.py (alm_init_plain ... alm_select_plain) against the
inline semantics of armour_tpu/nlp.py:_alm_phases / _finalize / solve,
written here with jnp on seeded float64 inputs with ties, infinities and
NaN, exactly; the cost output of alm_newton_plain / alm_values_plain
against plan_cost in both trajectory families; the refactored solve against
the JAX solve; max_violations against the JAX function at 1e-9.  K14's
launch geometry, argument checks and C prototypes (the launchers' table
against csrc/alm_loop.cu, and each launcher's call with the library
stubbed) are pure Python.

The cuda-marked tests (they skip where there is no card) hold K14 to the
plain bookkeeping bit for bit, K8's max mode to the plain max_violations,
K7 / K8's cost to plan_cost, and the solve with K14 to the eager solve
(K7 / K8 with the plain bookkeeping), bit for bit.  JAX is imported only
by the CPU tests, so that the card runs this file without it:
python3 -m pytest --noconftest tests/test_torch_alm_loop.py -m cuda."""

import ctypes
import dataclasses
import math

import numpy as np
import pytest
import torch

from armour_tpu_torch import convert, nlp as tnlp
from armour_tpu_torch.kernels import solver as ks

ALPHAS = (1.0, 0.3, 0.09)
THR = (1e-6, 1e-6, 1e-6, 1e-3)
TOL = 1e-9


def _jax():
    import jax
    import jax.numpy as jnp

    return jax, jnp


def _spiky(rng, shape, p_inf=0.15, p_nan=0.05):
    """Values on a coarse grid (ties), some infinite, some NaN."""
    x = np.round(rng.normal(size=shape) * 3, 1)
    m = rng.random(shape)
    x[m < p_inf] = np.inf
    x[(m >= p_inf) & (m < p_inf + p_nan)] = np.nan
    return x


def _state(seed, W=4, S=4, A=3, F=7, M=13):
    rng = np.random.default_rng(seed)
    st = {
        "k": rng.uniform(-1, 1, (W, S, F)),
        "step": rng.normal(size=(W, S, F)) * 2,
        "feas": rng.random((W, S)) < 0.6,
        "cost": _spiky(rng, (W, S), 0.0, 0.05),
        "best_k": rng.uniform(-1, 1, (W, S, F)),
        "best_cost": _spiky(rng, (W, S)),
        "kq": rng.uniform(-1, 1, (W, S * A, F)),
        "merit": _spiky(rng, (W, S * A), 0.05, 0.05),
        "feas_q": rng.random((W, S * A)) < 0.5,
        "cost_q": _spiky(rng, (W, S * A), 0.0, 0.05),
        "m0": _spiky(rng, (W, S), 0.05, 0.05),
        "c": rng.normal(size=(W, S, M)) * 5,
        "lam": np.abs(rng.normal(size=(W, S, M))) * 3,
        "rho": rng.choice([10.0, 640.0, 6e5, 1e6], size=(W, S)),
        "v": _spiky(rng, (W, S), 0.0, 0.05),
        "ok": rng.random((W, S)) < 0.5,
        "end_feas": rng.random((W, S)) < 0.5,
        "kb": rng.uniform(-1, 1, (W, 2 * S, F)),
        "viol": rng.choice([-1.0, 0.0, 1e-7, 2e-6, 1e-3, 0.5], size=(W, 2 * S, 4)),
        "cost_final": _spiky(rng, (W, S), 0.1, 0.05),
    }
    st["step"][0, 0, 0] = np.nan
    st["c"][0, 0, 0] = np.nan
    st["merit"][:, :2] = st["merit"][:, 2:4]          # tied merits across alphas
    st["best_cost"][:, 0] = st["best_cost"][:, -1]    # tied scores in the cull
    return st


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _j_track(kk, feas, cost, best_k, best_cost):
    # armour_tpu/nlp.py:451-457 (track_best) with the row pass's cost
    _, jnp = _jax()
    better = feas & (cost < best_cost)
    return jnp.where(better, kk, best_k), jnp.where(better, cost, best_cost)


def _vmap2(fn):
    """fn of one (world, seed) mapped over both axes."""
    jax, _ = _jax()
    return jax.vmap(jax.vmap(fn))


@pytest.mark.parametrize("seed", [0, 1])
def test_init_ladder_accept_match_the_jax_inner_step(seed):
    """armour_tpu/nlp.py:459-467 (init's tracker), :491-516 (the tracker at
    k, the alpha ladder, its candidates into the tracker, the accept)."""
    jax, jnp = _jax()
    st = _state(seed)
    W, S, F = st["k"].shape
    A = len(ALPHAS)
    j = {k: jnp.asarray(v) for k, v in st.items()}

    want = jnp.where(j["feas"], j["cost"], jnp.inf)
    got = tnlp.alm_init_plain(_t(st["k"]), _t(st["feas"]), _t(st["cost"]))
    _same(got, (st["k"], want))

    def ladder(k, step, feas, cost, bk, bc):
        bk, bc = _j_track(k, feas, cost, bk, bc)
        kks = jax.vmap(lambda a: jnp.clip(k - a * step, -1.0, 1.0))(jnp.asarray(ALPHAS))
        return kks, bk, bc

    kks, bk, bc = _vmap2(ladder)(j["k"], j["step"], j["feas"], j["cost"], j["best_k"],
                                  j["best_cost"])
    got = tnlp.alm_ladder_plain(*(_t(st[n]) for n in ("k", "step", "feas", "cost", "best_k",
                                                       "best_cost")), ALPHAS)
    _same(got, (np.asarray(kks).reshape(W, S * A, F), bk, bc))

    def accept(k, m0, kks, merits, feas, cost, bk, bc):
        for a in range(A):
            bk, bc = _j_track(kks[a], feas[a], cost[a], bk, bc)
        best = jnp.argmin(merits)
        return jnp.where(merits[best] < m0, kks[best], k), bk, bc

    want = _vmap2(accept)(j["k"], j["m0"], j["kq"].reshape(W, S, A, F),
                          j["merit"].reshape(W, S, A), j["feas_q"].reshape(W, S, A),
                          j["cost_q"].reshape(W, S, A), j["best_k"], j["best_cost"])
    got = tnlp.alm_accept_plain(*(_t(st[n]) for n in ("k", "m0", "kq", "merit", "feas_q",
                                                       "cost_q", "best_k", "best_cost")))
    _same(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_outer_and_cull_match_the_jax_loop(seed):
    """armour_tpu/nlp.py:518-532 (the tracker at k, the multiplier and
    penalty update) and :393-400, 536-543 (the cull's score, a stable
    ascending sort with NaN last, the kept seeds' carry)."""
    jax, jnp = _jax()
    st = _state(seed)
    j = {k: jnp.asarray(v) for k, v in st.items()}

    def outer(k, feas, cost, c, lam, rho, bk, bc):
        bk, bc = _j_track(k, feas, cost, bk, bc)
        return jnp.maximum(lam + rho * c, 0.0), jnp.minimum(rho * 2.0, 1e6), bk, bc

    want = _vmap2(outer)(*(j[n] for n in ("k", "feas", "cost", "c", "lam", "rho", "best_k",
                                          "best_cost")))
    got = tnlp.alm_outer_plain(*(_t(st[n]) for n in ("k", "feas", "cost", "c", "lam", "rho",
                                                      "best_k", "best_cost")))
    _same(got, want)

    for keep in (1, 2, 3):
        def cull(k, lam, rho, bk, bc, v, cost):
            score = jnp.where(jnp.isfinite(bc), bc, 1e6 + v + cost)
            idx = jnp.argsort(score)[:keep]
            return tuple(x[idx] for x in (k, lam, rho, bk, bc))

        want = jax.vmap(cull)(*(j[n] for n in ("k", "lam", "rho", "best_k", "best_cost", "v",
                                               "cost")))
        got = tnlp.alm_cull_plain(*(_t(st[n]) for n in ("k", "lam", "rho", "best_k",
                                                         "best_cost", "v", "cost")), keep)
        _same(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_pull_in_and_selection_match_the_jax_finalize(seed):
    """armour_tpu/nlp.py:562-575 (the pull-in's bracket, six bisection
    steps, k_pull), :576-577 (k_pull into the tracker), :586-600 (the final
    or the best iterate, NaN when infeasible) and :403-416 (the start of
    least cost among the feasible ones, else of least cost)."""
    jax, jnp = _jax()
    st = _state(seed)
    W, S, F = st["k"].shape
    rng = np.random.default_rng(seed + 10)
    oks = rng.random((6, W, S)) < 0.5
    j = {k: jnp.asarray(v) for k, v in st.items()}

    def pull(k, bk, bc, end_feas, oks):
        have = jnp.isfinite(bc)
        lo, hi = jnp.where(have, bk, k), k
        for i in range(6):
            mid = 0.5 * (lo + hi)
            lo, hi = jnp.where(oks[i], mid, lo), jnp.where(oks[i], hi, mid)
        return jnp.where(~end_feas & have, lo, k)

    want = _vmap2(pull)(j["k"], j["best_k"], j["best_cost"], j["end_feas"],
                        jnp.moveaxis(jnp.asarray(oks), 0, -1))
    k, bk, bc = _t(st["k"]), _t(st["best_k"]), _t(st["best_cost"])
    lo, hi, mid = tnlp.alm_pull_start_plain(k, bk, bc)
    for i in range(5):
        lo, hi, mid = tnlp.alm_pull_step_plain(lo, hi, mid, _t(oks[i]))
    k_pull = tnlp.alm_pull_end_plain(k, lo, mid, _t(oks[5]), _t(st["end_feas"]), bc)
    _same((k_pull,), (want,))

    kb, bc2 = tnlp.alm_finish_plain(k, k_pull, _t(st["feas"]), _t(st["cost"]), bk, bc)
    jbk, jbc = _vmap2(_j_track)(jnp.asarray(k_pull.numpy()), j["feas"], j["cost"], j["best_k"],
                                j["best_cost"])
    _same((kb, bc2), (np.concatenate([st["k"], np.asarray(jbk)], axis=1), jbc))

    def viol_ok(v):
        return (v[0] <= THR[0]) & (v[1] <= THR[1]) & (v[2] <= THR[2]) & (v[3] <= THR[3])

    def select(kb, v, bc, cf):
        k, bk = kb[:S], kb[S:]

        def one(k, bk, vf, vb, bc, cf):
            feas_final = viol_ok(vf)
            feas_best = viol_ok(vb) & jnp.isfinite(bc)
            use_best = feas_best & ((~feas_final) | (bc < cf))
            feasible = feas_final | feas_best
            k_sel = jnp.where(use_best, bk, k)
            return (jnp.where(feasible, k_sel, jnp.nan), feasible,
                    jnp.where(use_best, bc, cf), jnp.where(use_best, vb, vf))

        ks_, fs, cs, vs = jax.vmap(one)(k, bk, v[:S], v[S:], bc, cf)
        rank = jnp.where(fs, cs, jnp.inf)
        i = jnp.where(jnp.any(fs), jnp.argmin(rank), jnp.argmin(cs))
        return ks_[i], fs[i], cs[i], vs[i]

    want = jax.vmap(select)(j["kb"], j["viol"], j["best_cost"], j["cost_final"])
    got = tnlp.alm_select_plain(_t(st["kb"]), _t(st["viol"]), bc, _t(st["cost_final"]), THR)
    _same(got, want)


def _port_problem(family, dtype=torch.float64, W=2, device="cpu"):
    """A small plan of the port (T = 16) from saved scenes with moving
    starts: (cfg, basis, prob)."""
    import glob

    from armour_tpu_torch.collision import pad_obstacles, stack_obstacles
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.models.kinova import kinova_gen3
    from armour_tpu_torch.planner import plan_problem
    from armour_tpu_torch.pz.basis import make_basis
    from armour_tpu_torch.worlds import load_world_csv, straight_line_waypoint

    robot, basis = kinova_gen3(), make_basis(7, 3)
    cfg = ArmourConfig(num_time_steps=16, max_obstacles=16, screen_k=256, dtype=dtype,
                       traj_family=family)
    ws = [load_world_csv(p) for p in sorted(glob.glob("saved_worlds/random/*.csv"))[:W]]
    rng = np.random.default_rng(7)

    def on(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)

    q0 = on(np.stack([w.start for w in ws]))
    qd0 = on(rng.uniform(-0.3, 0.3, q0.shape))
    q_des = on(np.stack([straight_line_waypoint(w.start, w.goal,
                                                continuous=robot.continuous_joints)
                         for w in ws]))
    obs = stack_obstacles([pad_obstacles(w.obstacle_centers, w.obstacle_generators,
                                         cfg.max_obstacles, dtype) for w in ws])
    obs = type(obs)(centers=obs.centers.to(device), generators=obs.generators.to(device),
                    mask=obs.mask.to(device))
    return cfg, basis, plan_problem(q0, qd0, 0.5 * qd0, q_des, obs, robot, cfg, basis)


@pytest.mark.parametrize("family", ["bernstein", "armtd"])
def test_row_passes_return_plan_cost(family):
    """The cost output of alm_newton_plain (at the seeds) and
    alm_values_plain (at the queries) is plan_cost at the same points, and
    the merits are that cost plus the penalty."""
    cfg, basis, prob = _port_problem(family)
    W, S, A = prob.q_des.shape[0], 2, 3
    g = torch.Generator().manual_seed(1)
    k = torch.rand(W, S, 7, generator=g, dtype=torch.float64) * 2 - 1
    M = tnlp._stack_thresholds(prob, cfg).shape[0]
    lam = torch.rand(W, S, M, generator=g, dtype=torch.float64)
    rho = torch.full((W, S), 10.0, dtype=torch.float64)
    cont = prob.limits.continuous
    step, m0, feas, cost = tnlp.alm_newton_plain(k, lam, rho, prob, cfg, basis)
    assert torch.equal(cost, tnlp.plan_cost(k, prob.traj, prob.q_des, cont, cfg))
    assert bool((m0 >= cost).all())
    kq = torch.rand(W, S * A, 7, generator=g, dtype=torch.float64) * 2 - 1
    seed = torch.arange(S).repeat_interleave(A)
    merit, feas_q, cost_q, c = tnlp.alm_values_plain(kq, lam, rho, seed, prob, cfg, basis, True)
    assert torch.equal(cost_q, tnlp.plan_cost(kq, prob.traj, prob.q_des, cont, cfg))
    assert torch.equal(merit, cost_q + tnlp._penalty(c, lam[:, seed], rho[:, seed]))


def _jax_setup():
    """The JAX robot, config (float64, T = 16) and basis, and the port's
    config and basis carried across."""
    _, jnp = _jax()
    from armour_tpu.config import ArmourConfig as JConfig
    from armour_tpu.models.kinova import kinova_gen3 as j_kinova
    from armour_tpu.pz.basis import make_basis as j_make_basis
    from armour_tpu_torch.pz.basis import make_basis

    robot = j_kinova()
    cfg = JConfig(num_time_steps=16, max_obstacles=16, screen_k=256, dtype=jnp.float64)
    t_robot = convert.robot_from_fields({f.name: getattr(robot, f.name)
                                         for f in dataclasses.fields(robot)})
    t_cfg = convert.config_from_fields({f.name: getattr(cfg, f.name)
                                        for f in dataclasses.fields(cfg)})
    return robot, cfg, j_make_basis(7, 3), t_robot, t_cfg, make_basis(7, 3)


def _np_fields(obj):
    """The array fields of a JAX dataclass as numpy, with a worlds axis."""
    return {f.name: np.array(getattr(obj, f.name))[None]
            for f in dataclasses.fields(obj) if f.name not in ("dims", "family")}


@pytest.fixture(scope="module")
def jax_problems():
    """Two JAX PlanProblems (float64, T = 16) from saved scenes, one from a
    moving start, and the same problems carried into the port through
    convert.py."""
    jax, jnp = _jax()
    from armour_tpu import nlp as jnlp
    from armour_tpu.collision import (build_hyperplanes, pad_obstacles as j_pad,
                                      screen_collision)
    from armour_tpu.dynamics import torque_frs
    from armour_tpu.jrs import build_jrs
    from armour_tpu.kinematics import forward_occupancy, reduce_links
    from armour_tpu.worlds import load_world_csv
    from armour_tpu_torch.jrs import TrajectoryCoeffs
    from armour_tpu_torch.worlds import straight_line_waypoint

    robot, cfg, basis, t_robot, _, _ = _jax_setup()

    @jax.jit
    def build(q0, qd0, q_des, obs):
        jrs = build_jrs(q0, qd0, 0.5 * qd0, robot, cfg, basis)
        frs = reduce_links(forward_occupancy(jrs, robot, cfg, basis), basis)
        hyp = build_hyperplanes(frs, obs)
        return jnlp.PlanProblem(
            traj=jrs.traj, q_des=q_des, torque=torque_frs(jrs, robot, cfg, basis),
            frs=frs, hyp=hyp, obs=obs, screened=screen_collision(hyp, obs, frs, cfg.screen_k))

    out = []
    for name, speed in (("scene_013_001", 0.3), ("scene_016_001", 0.0)):
        w = load_world_csv(f"saved_worlds/random/{name}.csv")
        q_des = straight_line_waypoint(w.start, w.goal, continuous=t_robot.continuous_joints)
        qd0 = np.random.default_rng(5).uniform(-speed, speed, 7)
        obs = j_pad(w.obstacle_centers, w.obstacle_generators, cfg.max_obstacles, jnp.float64)
        jp = build(jnp.asarray(w.start), jnp.asarray(qd0), jnp.asarray(q_des), obs)
        tp = tnlp.PlanProblem(
            traj=TrajectoryCoeffs(**{k: torch.as_tensor(v)
                                     for k, v in _np_fields(jp.traj).items()}),
            q_des=torch.as_tensor(np.array(jp.q_des))[None],
            torque=convert.torque_frs_from_numpy(**_np_fields(jp.torque)),
            frs=convert.linkfrs_from_numpy(**_np_fields(jp.frs)),
            hyp=convert.hyperplanes_from_numpy(dims=jp.hyp.dims, **_np_fields(jp.hyp)),
            obs=convert.obstacles_from_numpy(**_np_fields(jp.obs)),
            screened=convert.screened_from_numpy(**_np_fields(jp.screened)),
            limits=tnlp.robot_limits(t_robot, torch.float64, "cpu"))
        out.append((jp, tp))
    return out


def test_plan_cost_sums_in_factor_order(jax_problems):
    """plan_cost sums the F squares in order (the kernels' alm_cost) and
    stays the JAX cost at 1e-9."""
    jax, jnp = _jax()
    from armour_tpu import nlp as jnlp

    robot, cfg, _, _, t_cfg, _ = _jax_setup()
    k = 2 * torch.rand(1, 6, 7, generator=torch.Generator().manual_seed(3),
                       dtype=torch.float64) - 1
    for jp, tp in jax_problems:
        cont = tp.limits.continuous
        cost = tnlp.plan_cost(k, tp.traj, tp.q_des, cont, t_cfg)
        d = tnlp._plan_diff(k, tp.traj, tp.q_des, cont, t_cfg)
        total = d[..., 0] * d[..., 0]
        for f in range(1, 7):
            total = total + d[..., f] * d[..., f]
        assert torch.equal(cost, t_cfg.cost_scale * total)
        want = jax.vmap(lambda kk: jnlp.plan_cost(kk, jp.traj, jp.q_des, robot, cfg))(
            jnp.asarray(k[0].numpy()))
        np.testing.assert_allclose(cost[0].numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_solve_matches_the_jax_solve(jax_problems):
    """The refactored solve (plain rows and bookkeeping on the CPU) against
    the JAX solve on two scenes: the same feasibility, cost and k within
    1e-6, the violations within 1e-6."""
    jax, jnp = _jax()
    from armour_tpu import nlp as jnlp

    robot, cfg, basis, _, t_cfg, t_basis = _jax_setup()
    jsolve = jax.jit(lambda p: jnlp.solve(p, robot, cfg, basis))
    for jp, tp in jax_problems:
        want = jsolve(jp)
        got = tnlp.solve(tp, t_cfg, t_basis)
        assert bool(got.feasible[0]) == bool(want.feasible)
        assert abs(float(got.cost[0]) - float(want.cost)) <= 1e-6 * max(1.0, float(want.cost))
        np.testing.assert_allclose(got.k[0].numpy(), np.asarray(want.k), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.viol[0].numpy(), np.asarray(want.viol), rtol=1e-6,
                                   atol=1e-6)


def test_max_violations_matches_jax(jax_problems):
    """Every group of max_violations at 1e-9 against the JAX function, at
    k = 0 and six random k of each scene."""
    jax, jnp = _jax()
    from armour_tpu import nlp as jnlp

    robot, cfg, basis, _, t_cfg, t_basis = _jax_setup()
    ks_ = np.concatenate([np.zeros((1, 7)), np.random.default_rng(8).uniform(-1, 1, (6, 7))])
    jmv = jax.jit(jax.vmap(lambda k, p: jnp.stack(jnlp.max_violations(k, p, robot, cfg, basis)),
                           in_axes=(0, None)))
    for jp, tp in jax_problems:
        got = torch.stack(tnlp.max_violations(torch.as_tensor(ks_)[None], tp, t_cfg, t_basis),
                          dim=-1)[0].numpy()
        want = np.asarray(jmv(jnp.asarray(ks_), jp))
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("Wn", [1, 64, 1024])
@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_k14_geometry_covers_every_element_once(Wn, S):
    """A thread per (world, seed), per multiplier of the outer update and
    per world of the selection; the cull's CTAs cover (kept seed, M)."""
    T = ks.K14_THREADS
    M = 5944
    (b,) = ks.k14_geometry("ladder", Wn, S)
    assert (b - 1) * T < Wn * S <= b * T
    (b,) = ks.k14_geometry("outer", Wn, S, M)
    assert (b - 1) * T < Wn * S * M <= b * T
    (b,) = ks.k14_geometry("select", Wn, S)
    assert (b - 1) * T < Wn <= b * T
    for keep in range(1, S + 1):
        bx, by = ks.k14_geometry("cull", Wn, S, M, keep)
        assert by == Wn * keep and (bx - 1) * T < M <= bx * T and T >= 7


def test_k14_source_constants_match_the_launchers():
    from armour_tpu_torch.kernels import build

    text = (build.CSRC / "alm_loop.cu").read_text()
    for name, want in (("K14_THREADS", ks.K14_THREADS), ("K14_MAX_A", ks.K14_MAX_A),
                       ("K14_MAX_S", ks.K14_MAX_S), ("K14_MAX_F", ks.K14_MAX_F)):
        assert f"#define {name} {want}\n" in text, name
    assert build.SOURCES["alm_loop"] == "alm_loop.cu"


def test_k14_launchers_check_their_arguments():
    """CPU tensors raise (a CUDA tensor launches or raises: no plain
    fallback); shapes K14 does not take raise before any launch."""
    z = torch.zeros
    b = torch.bool
    with pytest.raises(ValueError, match="CUDA"):
        ks.loop_init(z(2, 4, 7), z(2, 4, dtype=b), z(2, 4))
    with pytest.raises(ValueError, match="CUDA"):
        ks.loop_select(z(2, 8, 7), z(2, 8, 4), z(2, 4), z(2, 4), THR)
    with pytest.raises(ValueError, match="seeds"):
        ks.loop_init(z(2, 9, 7), z(2, 9, dtype=b), z(2, 9))
    with pytest.raises(ValueError, match="seeds"):
        ks.loop_pull_start(z(2, 4, 9), z(2, 4, 9), z(2, 4))
    with pytest.raises(ValueError, match="ladder points"):
        ks.loop_ladder(z(2, 8, 7), z(2, 8, 7), z(2, 8, dtype=b), z(2, 8), z(2, 8, 7), z(2, 8),
                       ALPHAS)
    with pytest.raises(ValueError, match="ladder block"):
        ks.loop_accept(z(2, 4, 7), z(2, 4), z(2, 10, 7), z(2, 10), z(2, 10, dtype=b), z(2, 10),
                       z(2, 4, 7), z(2, 4))
    with pytest.raises(ValueError, match="keeps"):
        ks.loop_cull(z(2, 4, 7), z(2, 4, 5), z(2, 4), z(2, 4, 7), z(2, 4), z(2, 4), z(2, 4), 5)
    with pytest.raises(ValueError, match="2S"):
        ks.loop_select(z(2, 7, 7), z(2, 7, 4), z(2, 3), z(2, 3), THR)


def _c_prototypes():
    """{symbol: [(name, C kind)]} of the extern "C" k14_* launchers in
    csrc/alm_loop.cu; kind "float*", "unsigned char*", "void*", "int" or
    "float"."""
    import re

    from armour_tpu_torch.kernels import build

    text = (build.CSRC / "alm_loop.cu").read_text()
    out = {}
    for sym, plist in re.findall(r'extern "C" int (k14_\w+)\(([^)]*)\)', text):
        params = []
        for p in " ".join(plist.split()).split(","):
            decl, name = p.strip().rsplit(" ", 1)
            kind = decl.replace("const ", "").replace(" ", "")
            params.append((name, kind.replace("*", "") + ("*" if "*" in kind else "")))
        out[sym] = params
    return out


_C_KIND = {"tensor": "float*", "array": "float*", "bool": "unsignedchar*", "stream": "void*",
           "int": "int", "float": "float"}


def test_k14_prototype_table_matches_the_source():
    """K14_PROTOS names every extern "C" launcher of alm_loop.cu and each
    one's parameters in order, with their kinds: ctypes infers nothing, so
    a launcher that gains, loses or reorders a parameter fails here, not
    on the card."""
    protos = _c_prototypes()
    assert sorted(protos) == sorted(ks.K14_PROTOS)
    assert {f"k14_{name}" for name in vars(ks.LOOP)} == set(protos)
    for sym, params in protos.items():
        want = [(n, _C_KIND[kind]) for n, kind, _ in ks.k14_params(sym)]
        assert [(n, k.replace(" ", "")) for n, k in params] == want, sym


def _dry_loop_args(phase, W=3, S=4, A=3, F=7, M=11, keep=2):
    z, b = torch.zeros, torch.bool
    ws, wsf = z(W, S), z(W, S, F)
    return {
        "init": (wsf, z(W, S, dtype=b), ws),
        "ladder": (wsf, wsf, z(W, S, dtype=b), ws, wsf, ws, ALPHAS),
        "accept": (wsf, ws, z(W, S * A, F), z(W, S * A), z(W, S * A, dtype=b), z(W, S * A),
                   wsf, ws),
        "outer": (wsf, z(W, S, dtype=b), ws, z(W, S, M), z(W, S, M), ws, wsf, ws),
        "cull": (wsf, z(W, S, M), ws, wsf, ws, ws, ws, keep),
        "pull_start": (wsf, wsf, ws),
        "pull_step": (wsf, wsf, wsf, z(W, S, dtype=b)),
        "pull_end": (wsf, wsf, wsf, z(W, S, dtype=b), z(W, S, dtype=b), ws),
        "finish": (wsf, wsf, z(W, S, dtype=b), ws, wsf, ws),
        "select": (z(W, 2 * S, F), z(W, 2 * S, 4), ws, ws, THR),
    }[phase]


@pytest.mark.parametrize("phase", ["init", "ladder", "accept", "outer", "cull", "pull_start",
                                   "pull_step", "pull_end", "finish", "select"])
def test_k14_launchers_pass_their_prototypes(phase, monkeypatch):
    """Each launcher, with the device check and the library stubbed out,
    hands its C function exactly the prototype's parameters: one value per
    parameter, of its ctypes type, the grid from k14_geometry, the sizes
    of its tensors."""
    from armour_tpu_torch import kernels

    calls = []

    def fake_launcher(lib, symbol, argtypes):
        def fn(*args):
            calls.append((symbol, argtypes, args))
            return 0
        return fn

    def shape_only(t, name, shape, dtype=torch.float32):
        assert t.dtype == dtype and tuple(t.shape) == tuple(shape), name

    monkeypatch.setattr(ks, "launcher", fake_launcher)
    monkeypatch.setattr(ks, "_require", shape_only)
    monkeypatch.setattr(ks, "_stream", lambda t: "the stream")
    before = kernels.LAUNCHES["alm_loop"]
    getattr(ks.LOOP, phase)(*_dry_loop_args(phase))
    assert kernels.LAUNCHES["alm_loop"] == before + 1
    [(symbol, argtypes, args)] = calls
    c_params = _c_prototypes()[symbol]
    assert symbol == f"k14_{phase}" and len(argtypes) == len(args) == len(c_params)
    for (name, kind), t, x in zip(c_params, argtypes, args):
        kind = kind.replace(" ", "")
        want = {"int": ctypes.c_int, "float": ctypes.c_float}.get(kind, ctypes.c_void_p)
        assert t is want, name
        assert isinstance(x, int if kind == "int" else float) or kind.endswith("*"), name
    sizes = dict(zip((n for n, _ in c_params), args))
    assert sizes.get("F") == 7
    blocks = tuple(sizes[n] for n, _ in c_params if n.startswith("blocks"))
    assert blocks == ks.k14_geometry(phase, 3, 4, 11, 2 if phase == "cull" else 0)
    assert args[-1] == "the stream"


def test_cpu_solve_takes_the_plain_book(monkeypatch):
    """On CPU tensors the solve's phases are the plain versions: it never
    reaches K14's launchers (each raises here), and gives the eager
    solve's result."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU solve reached K14")

    cfg, basis, prob = _port_problem("bernstein", W=1)
    want = tnlp.solve(prob, cfg, basis, eager=True)
    for name in vars(ks.LOOP):
        monkeypatch.setattr(ks.LOOP, name, refuse)
    got = tnlp.solve(prob, cfg, basis)
    for f in ("k", "feasible", "cost", "viol"):
        assert torch.equal(torch.nan_to_num(getattr(got, f)), torch.nan_to_num(getattr(want, f)))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels are built with nvcc there)")
    return torch.device("cuda")


def _bits_equal(a, b):
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    a, b = a.contiguous(), b.contiguous()
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _loop_cases(st, dev):
    """(phase, K14 launcher args) from a _state on the card, float32."""
    def f(n):
        x = torch.as_tensor(np.asarray(st[n]))
        return (x.to(dev) if x.dtype == torch.bool else x.to(dev, torch.float32)).contiguous()

    return [
        ("init", (f("k"), f("feas"), f("cost"))),
        ("ladder", (f("k"), f("step"), f("feas"), f("cost"), f("best_k"), f("best_cost"),
                    ALPHAS)),
        ("accept", (f("k"), f("m0"), f("kq"), f("merit"), f("feas_q"), f("cost_q"), f("best_k"),
                    f("best_cost"))),
        ("outer", (f("k"), f("feas"), f("cost"), f("c"), f("lam"), f("rho"), f("best_k"),
                   f("best_cost"))),
        ("cull", (f("k"), f("lam"), f("rho"), f("best_k"), f("best_cost"), f("v"), f("cost"), 2)),
        ("pull_start", (f("k"), f("best_k"), f("best_cost"))),
        ("pull_step", (f("k"), f("best_k"), f("kq")[:, :4].contiguous(), f("ok"))),
        ("pull_end", (f("k"), f("best_k"), f("kq")[:, :4].contiguous(), f("ok"), f("end_feas"),
                      f("best_cost"))),
        ("finish", (f("k"), f("best_k"), f("feas"), f("cost"), f("best_k"), f("best_cost"))),
        ("select", (f("kb"), f("viol"), f("best_cost"), f("cost_final"), THR)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_k14_matches_the_plain_bookkeeping_on_the_card(seed):
    """Every phase of K14 against its plain version on the same CUDA
    tensors (ties, infinities, NaN): the same bits, and the same again on a
    second call."""
    dev = _card()
    for name, args in _loop_cases(_state(seed), dev):
        got = getattr(ks.LOOP, name)(*args)
        again = getattr(ks.LOOP, name)(*args)
        want = getattr(tnlp.PLAIN_LOOP, name)(*args)
        got, again, want = (x if isinstance(x, tuple) else (x,) for x in (got, again, want))
        assert len(got) == len(want)
        for g, a, w in zip(got, again, want):
            assert _bits_equal(g, w), name
            assert _bits_equal(g, a), name


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["bernstein", "armtd"])
def test_k8_max_mode_and_costs_match_the_plain_versions_on_the_card(family):
    """K8's max mode against the plain max_violations: the state maxima and
    the grasp maxima (-BIG: no grasp rows here) bit for bit, the torque
    maxima within 1e-5 of their terms (K8's dot order);
    K7's and K8's cost against plan_cost bit for bit."""
    dev = _card()
    cfg, basis, prob = _port_problem(family, torch.float32, 3, dev)
    rows = ks.alm_rows(prob, cfg, basis)
    W = prob.q_des.shape[0]
    g = torch.Generator().manual_seed(0)
    kq = (torch.rand(W, 8, 7, generator=g) * 2 - 1).to(dev)
    kq[:, 0] = 0.0
    vt, vs, vg = ks.alm_maxima(rows, kq)
    vt2, vs2, vg2 = ks.alm_maxima(rows, kq)
    pt, _, ps, pg = tnlp.max_violations(kq, prob, cfg, basis)
    assert _bits_equal(vt, vt2) and _bits_equal(vs, vs2) and _bits_equal(vg, vg2)
    assert _bits_equal(vs, ps) and _bits_equal(vg, pg)
    u_abs = torch.matmul(basis.phi(kq).abs(), rows.tensors["u_coef"].abs().transpose(1, 2))
    mag = (u_abs + rows.tensors["u_hi"].abs()[:, None]).amax(-1) + 1.0
    assert bool(((vt - pt).abs() <= 1e-5 * mag).all())
    cont = prob.limits.continuous
    lam = torch.zeros(W, 4, rows.M, device=dev)
    rho = torch.full((W, 4), 10.0, device=dev)
    k = kq[:, :4].contiguous()
    _, _, _, cost = ks.alm_newton(rows, k, lam, rho)
    assert _bits_equal(cost, tnlp.plan_cost(k, prob.traj, prob.q_des, cont, cfg))
    seed = torch.arange(4, dtype=torch.int32, device=dev).repeat_interleave(2)
    _, _, cost_q, _ = ks.alm_values(rows, kq, lam, rho, seed)
    assert _bits_equal(cost_q, tnlp.plan_cost(kq, prob.traj, prob.q_des, cont, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["bernstein", "armtd"])
def test_fused_solve_matches_the_eager_solve_on_the_card(family):
    """The solve with K14 against the eager solve (K7 / K8 and the plain
    bookkeeping) on the same problem: k, feasible, cost and viol bit for
    bit, with and without the cull and from one start (k0)."""
    dev = _card()
    cfg, basis, prob = _port_problem(family, torch.float32, 3, dev)
    for c, k0 in ((cfg, None), (dataclasses.replace(cfg, solver_cull_after=0), None),
                  (cfg, torch.zeros(prob.q_des.shape, device=dev))):
        a = tnlp.solve(prob, c, basis, k0=k0)
        b = tnlp.solve(prob, c, basis, k0=k0, eager=True)
        for f in ("k", "feasible", "cost", "viol"):
            assert _bits_equal(getattr(a, f), getattr(b, f)), f
        assert not bool(torch.isfinite(a.k[~a.feasible]).any())
        assert math.isfinite(float(a.cost[a.feasible].sum()))

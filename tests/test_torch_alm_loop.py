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
against csrc/alm_loop.cu, the phases' epilogue table against
csrc/alm_loop.cuh, and each launch or row pass with the library stubbed)
are pure Python.

The cuda-marked tests (they skip where there is no card) hold K14 to the
plain bookkeeping bit for bit (the cull and the selection as launches, the
other phases as run by K7's / K8's finish against the row pass followed by
the plain phase), K8's max mode to the plain max_violations, K7 / K8's
cost to plan_cost, and the solve with K14 to the eager solve (K7 / K8
with the plain bookkeeping), bit for bit, in both families and with the
grasp group.  JAX is imported only
by the CPU tests, so that the card runs this file without it:
python3 -m pytest --noconftest tests/test_torch_alm_loop.py -m cuda."""

import ctypes
import dataclasses
import functools
import math
import re
import types

import numpy as np
import pytest
import torch

from armour_tpu_torch import convert, nlp as tnlp
from armour_tpu_torch.kernels import build, solver as ks

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
    """K14's own launches: a thread per world of the selection; the cull's
    CTAs cover (kept seed, M).  Its phases in the row passes' finishes: K7's
    finish, a CTA per (world, seed), runs the ladder for each once; K8's,
    a CTA per world of K8C_THREADS, a thread per seed; the outer update
    writes each of the M multipliers of a (world, seed) once, where K8
    forms its row (2 T F torque rows and 3 T grasp rows in step (a), the K
    screened rows in step (b), the 8 F state rows in the finish)."""
    T = ks.K14_THREADS
    M = 5944
    (b,) = ks.k14_geometry("select", Wn, S)
    assert (b - 1) * T < Wn <= b * T
    for keep in range(1, S + 1):
        bx, by = ks.k14_geometry("cull", Wn, S, M, keep)
        assert by == Wn * keep and (bx - 1) * T < M <= bx * T and T >= 7
    for phase in ("init", "ladder", "outer"):
        with pytest.raises(ValueError, match="no phase"):
            ks.k14_geometry(phase, Wn, S)
    Tt, F, K, TG = 128, 7, 4096, 3 * 128
    geo7 = ks.k7_geometry(Wn, S, 3 * Tt * F, Tt * F + TG, K)
    assert geo7.ctas(Wn, S)[2] == Wn * S
    text = (build.CSRC / "alm_values.cu").read_text()
    assert S <= int(re.search(r"#define K8C_THREADS (\d+)", text).group(1))
    geo8 = ks.k8_geometry(Wn, S, 3 * Tt * F + Tt * F + TG, K)
    rows = np.zeros(3 * Tt * F + Tt * F + TG, dtype=int)
    for t in range(geo8.tiles_a):
        rows[t * geo8.R:(t + 1) * geo8.R] += 1
    torque_grasp = rows[3 * Tt * F:]
    assert (torque_grasp == 1).all() and geo8.tiles_b * ks.K8_COL_THREADS >= K
    assert 2 * Tt * F + TG + K + 8 * F == M + TG


def test_k14_source_constants_match_the_launchers():
    """alm_loop.cuh's constants and its phase ids (EPI_PHASES in order);
    alm_loop.cu launches only the cull and the selection."""
    text = (build.CSRC / "alm_loop.cuh").read_text()
    for name, want in (("K14_THREADS", ks.K14_THREADS), ("K14_MAX_A", ks.K14_MAX_A),
                       ("K14_MAX_S", ks.K14_MAX_S), ("K14_MAX_F", ks.K14_MAX_F)):
        assert f"#define {name} {want}\n" in text, name
    for i, phase in enumerate(ks.EPI_PHASES):
        assert f"#define ALM_EPI_{phase.upper()} {i}\n" in text, phase
    assert build.SOURCES["alm_loop"] == "alm_loop.cu"
    loop = (build.CSRC / "alm_loop.cu").read_text()
    assert set(re.findall(r"\b(k14_\w+?)_kernel\b", loop)) == {
        "k14_cull", "k14_select"}
    assert '#include "alm_loop.cuh"' in (build.CSRC / "alm_rows.cuh").read_text()


def _dry_rows(monkeypatch, W=3):
    """A small plan's AlmRows on the CPU (Kinova, T = 4), the device checks
    and the card's SM count stubbed, so that the launchers can be driven
    with the library stubbed."""
    from armour_tpu_torch.collision import pad_obstacles, stack_obstacles
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.models.kinova import kinova_gen3
    from armour_tpu_torch.planner import plan_problem
    from armour_tpu_torch.pz.basis import make_basis

    robot, basis = kinova_gen3(), make_basis(7, 3)
    cfg = ArmourConfig(num_time_steps=4, max_obstacles=4, screen_k=64, dtype=torch.float32)
    obs = stack_obstacles([pad_obstacles(np.array([[0.5, 0.4, 0.6]]),
                                         np.diag([0.05] * 3)[None], 4, torch.float32)] * W)
    q0 = torch.full((W, 7), 0.1)
    prob = plan_problem(q0, torch.zeros_like(q0), torch.zeros_like(q0), q0 + 0.05, obs, robot,
                        cfg, basis)
    monkeypatch.setattr(ks, "_require", _shape_only)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"multi_processor_count": 132})())
    return ks.alm_rows(prob, cfg, basis)


def _shape_only(t, name, shape, dtype=torch.float32):
    assert t.dtype == dtype and tuple(t.shape) == tuple(shape), name


def test_k14_launchers_check_their_arguments(monkeypatch):
    """CPU tensors raise (a CUDA tensor launches or raises: no plain
    fallback); shapes K14 does not take raise before any launch, in its
    own launches and in the row passes that run its phases."""
    z = torch.zeros
    b = torch.bool
    with pytest.raises(ValueError, match="CUDA"):
        ks.loop_cull(z(2, 4, 7), z(2, 4, 5), z(2, 4), z(2, 4, 7), z(2, 4), z(2, 4), z(2, 4), 2)
    with pytest.raises(ValueError, match="CUDA"):
        ks.loop_select(z(2, 8, 7), z(2, 8, 4), z(2, 4), z(2, 4), THR)
    with pytest.raises(ValueError, match="seeds"):
        ks.loop_cull(z(2, 9, 7), z(2, 9, 5), z(2, 9), z(2, 9, 7), z(2, 9), z(2, 9), z(2, 9), 2)
    with pytest.raises(ValueError, match="keeps"):
        ks.loop_cull(z(2, 4, 7), z(2, 4, 5), z(2, 4), z(2, 4, 7), z(2, 4), z(2, 4), z(2, 4), 5)
    with pytest.raises(ValueError, match="2S"):
        ks.loop_select(z(2, 7, 7), z(2, 7, 4), z(2, 3), z(2, 3), THR)
    rows = types_rows(W=2, M=5)
    fused = _fused_steps(rows)
    with pytest.raises(ValueError, match="CUDA"):
        fused.init(z(2, 4, 7), z(2, 4, 5), z(2, 4))
    with pytest.raises(ValueError, match="seeds"):
        fused.init(z(2, 9, 7), z(2, 9, 5), z(2, 9))
    with pytest.raises(ValueError, match="ladder points"):
        fused.ladder(z(2, 8, 7), z(2, 8, 5), z(2, 8), z(2, 8, 7), z(2, 8))
    with pytest.raises(ValueError, match="ladder block"):
        fused.accept(z(2, 10, 7), z(2, 4, 5), z(2, 4), z(2, 4, 7), z(2, 4), z(2, 4, 7), z(2, 4))
    with pytest.raises(ValueError, match="one query per seed"):
        fused.pull_step(z(2, 3, 7), z(2, 4, 5), z(2, 4), z(2, 4, 7), z(2, 4, 7))
    monkeypatch.setattr(ks, "_require", _shape_only)
    with pytest.raises(AssertionError, match="end_feas"):
        fused.pull_end(z(2, 4, 7), z(2, 4, 5), z(2, 4), z(2, 4, 7), z(2, 4, 7), z(2, 4), z(2, 4))
    with pytest.raises(TypeError, match="takes no"):
        ks.epilogue(rows, ALPHAS, "init", z(2, 4, 7), z(2, 4, 5), z(2, 4), best_k=z(2, 4, 7))
    with pytest.raises(ValueError, match="does not run"):
        ks._set_epilogue(ks.AlmArgs(), ks.Epilogue("ladder", ks.AlmEpilogue(), ()), "alm_values")
    with pytest.raises(ValueError, match="only the kernels"):
        tnlp.alm_values(z(2, 4, 7), z(2, 4, 5), z(2, 4), None, None, None, None,
                        epi=ks.Epilogue("init", ks.AlmEpilogue(), ()))


def types_rows(W, M, F=7):
    """A stand-in for AlmRows with the sizes the fused steps read first."""
    return types.SimpleNamespace(args=types.SimpleNamespace(W=W, F=F), M=M)


def _row_passes(rows):
    """K7 and K8 on the plan `rows` as nlp.loop_pairs calls them."""
    return (lambda k, lam, rho, epi=None: ks.alm_newton(rows, k, lam, rho, epi=epi),
            lambda *a, **kw: ks.alm_values(rows, *a, **kw))


def _fused_steps(rows):
    """The fused solve's steps: nlp.loop_pairs with K7 / K8 running each
    phase in their finish (kernels/solver.py:epilogue)."""
    return tnlp.loop_pairs(*_row_passes(rows), ks.LOOP, ALPHAS,
                           functools.partial(ks.epilogue, rows, ALPHAS))


def _c_prototypes():
    """{symbol: [(name, C kind)]} of the extern "C" k14_* launchers in
    csrc/alm_loop.cu; kind "float*", "unsigned char*", "void*", "int" or
    "float"."""
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


_C_KIND = {"tensor": "float*", "bool": "unsignedchar*", "stream": "void*", "int": "int",
           "float": "float"}


def test_k14_prototype_table_matches_the_source():
    """K14_PROTOS names every extern "C" launcher of alm_loop.cu and each
    one's parameters in order, with their kinds: ctypes infers nothing, so
    a launcher that gains, loses or reorders a parameter fails here, not
    on the card.  ALM_EPILOGUES names a phase for every ALM_EPI_* but none,
    and only AlmEpilogue's fields, each an input or an output of the kind
    the struct declares."""
    protos = _c_prototypes()
    assert sorted(protos) == sorted(ks.K14_PROTOS)
    assert {f"k14_{name}" for name in vars(ks.LOOP)} == set(protos)
    for sym, params in protos.items():
        want = [(n, _C_KIND[kind]) for n, kind, _ in ks.k14_params(sym)]
        assert [(n, k.replace(" ", "")) for n, k in params] == want, sym
    assert set(ks.ALM_EPILOGUES) == set(ks.EPI_PHASES[1:]) == set(
        vars(tnlp.loop_pairs(None, None, None, ALPHAS)))
    decl = _c_struct(_loop_header(), "AlmEpilogue")
    assert [n for n, _ in decl] == [f[0] for f in ks.AlmEpilogue._fields_]
    kinds = dict(decl)
    for phase in ks.ALM_EPILOGUES:
        _, ins, outs = ks.epilogue_fields(phase)
        for name, kind, _ in ins:
            assert kinds[name] == ("constunsignedchar*" if kind == "bool" else "constfloat*")
        for name, kind, _ in outs:
            assert kinds[name] == "float*", name


def _loop_header():
    return (build.CSRC / "alm_loop.cuh").read_text()


def _c_struct(text, name):
    """[(field, C type without spaces)] of `struct name { ... };`."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in body.split(";"):
        decl = " ".join(decl.split())
        if decl:
            kind, field = decl.rsplit(" ", 1)
            kind += "*" * field.count("*")
            out.append((re.sub(r"\[.*\]", "", field.lstrip("*")), kind.replace(" ", "")))
    return out


def _phase_fields(phase):
    """The AlmEpilogue fields (e.name) that phase's device code in
    alm_loop.cuh reads or writes, through the helpers it calls."""
    text = _loop_header()

    def body(fn):
        m = re.search(r"void %s\((.*?)\n\}" % fn, text, re.S)
        return m.group(1)

    code = body(f"alm_epi_{phase}")
    if "k14_track_out(" in code:
        code += body("k14_track_out")
    if phase == "outer":
        code += body("alm_epi_lam")
    return set(re.findall(r"\be\.(\w+)", code)) - {"phase"}


def _dry_loop_args(phase, W=3, S=4, A=3, F=7, M=11, keep=2):
    z, b = torch.zeros, torch.bool
    ws, wsf = z(W, S), z(W, S, F)
    return {
        "init": (wsf, z(W, S, M), ws),
        "ladder": (wsf, z(W, S, M), ws, wsf, ws),
        "accept": (z(W, S * A, F), z(W, S, M), ws, wsf, ws, wsf, ws),
        "outer": (wsf, z(W, S, M), ws, wsf, ws),
        "cull": (wsf, z(W, S, M), ws, wsf, ws, ws, ws, keep),
        "pull_start": (wsf, z(W, S, M), ws, wsf, ws),
        "pull_step": (wsf, z(W, S, M), ws, wsf, wsf),
        "pull_end": (wsf, z(W, S, M), ws, wsf, wsf, z(W, S, dtype=b), ws),
        "finish": (wsf, z(W, S, M), ws, wsf, wsf, ws),
        "select": (z(W, 2 * S, F), z(W, 2 * S, 4), ws, ws, THR),
    }[phase]


@pytest.mark.parametrize("phase", ["init", "ladder", "accept", "outer", "cull", "pull_start",
                                   "pull_step", "pull_end", "finish", "select"])
def test_k14_launchers_pass_their_prototypes(phase, monkeypatch):
    """Each phase, with the device check and the library stubbed out,
    hands its kernel exactly what it declares.  The cull and the selection
    (K14's launches): one value per prototype parameter, of its ctypes
    type, the grid from k14_geometry, the sizes of its tensors.  A phase
    run by a row pass (K7 for the ladder, else K8): one launch of that
    kernel whose AlmArgs.epi holds the phase's id, A and alphas, the
    pointers of its inputs and of the outputs it returns (ALM_EPILOGUES),
    null in every field it does not use, the fields its device code reads
    and writes; the row pass takes the step's query points, multipliers
    and penalties, and writes no scratch rows."""
    from armour_tpu_torch import kernels

    calls = []

    def fake_launcher(lib, symbol, argtypes):
        def fn(*args):
            calls.append((symbol, argtypes, args))
            return 0
        return fn

    monkeypatch.setattr(ks, "launcher", fake_launcher)
    monkeypatch.setattr(ks, "_stream", lambda t: "the stream")
    if phase in ("cull", "select"):
        monkeypatch.setattr(ks, "_require", _shape_only)
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
        return
    rows = _dry_rows(monkeypatch)
    M = rows.M
    args = _dry_loop_args(phase, M=M)
    kernels.reset_counts()
    got = getattr(_fused_steps(rows), phase)(*args)
    kernel, ins, outs = ks.epilogue_fields(phase)
    assert kernels.LAUNCHES["alm_loop"] == 0 and kernels.IN_FINISH == {phase: 1}
    assert kernels.LAUNCHES[kernel] == 1
    [(symbol, _, cargs)] = calls
    assert symbol == ("k7_launch" if kernel == "alm_newton" else "k8_launch")
    a = cargs[0]._obj
    e = a.epi
    assert ks.EPI_PHASES[e.phase] == phase
    assert e.A == {"ladder": len(ALPHAS), "accept": 3}.get(phase, 0)
    assert [e.alphas[i] for i in range(len(ALPHAS))] == (
        [np.float32(x) for x in ALPHAS] if phase == "ladder" else [0.0] * len(ALPHAS))
    names = {
        "ladder": ("k", "lam", "rho", "best_k", "best_cost"),
        "accept": ("kq", "lam", "rho", "k", "m0", "best_k", "best_cost"),
        "pull_step": ("mid", "lam", "rho", "lo", "hi"),
        "pull_end": ("mid", "lam", "rho", "k", "lo", "end_feas", "best_cost"),
        "finish": ("k_pull", "lam", "rho", "k", "best_k", "best_cost"),
    }.get(phase, ("k", "lam", "rho", "best_k", "best_cost"))
    given = dict(zip(names, args))
    q = args[0]
    assert a.k == q.data_ptr() and a.lam == given["lam"].data_ptr()
    assert a.rho == given["rho"].data_ptr() and a.Q == q.shape[1] and a.S == 4
    assert not a.c and not a.maxima
    used = {n for n, _, _ in ins} | {n for n, _, _ in outs}
    for name, _, _ in ins:
        assert getattr(e, name) == given[name].data_ptr(), name
    got = got if isinstance(got, tuple) else (got,)
    returned = {"ladder": got[1:], "pull_start": got[2:]}.get(phase, got)
    assert len(returned) == len(outs)
    sz = dict(W=3, S=4, F=7, M=M, Q=12, S2=8)
    for (name, _, dims), t in zip(outs, returned):
        assert getattr(e, name) == t.data_ptr(), name
        assert tuple(t.shape) == tuple(sz[d] if isinstance(d, str) else d for d in dims), name
    for name, _ in ks.AlmEpilogue._fields_:
        if name not in used | {"phase", "A", "alphas"}:
            assert not getattr(e, name), name
    assert _phase_fields(phase) == used | ({"A", "alphas"} if phase == "ladder" else
                                           {"A"} if phase == "accept" else set())


def test_row_passes_without_a_phase_leave_the_descriptor_null(monkeypatch):
    """K7 and K8 called alone (the eager solve, the max mode, the recorded
    calls) hand a zeroed AlmEpilogue (ALM_EPI_NONE, every pointer null):
    their finish then runs as before the phases moved in."""
    calls = []

    def fake_launcher(lib, symbol, argtypes):
        return lambda *args: calls.append(args[0]._obj) or 0

    monkeypatch.setattr(ks, "launcher", fake_launcher)
    monkeypatch.setattr(ks, "_stream", lambda t: "the stream")
    rows = _dry_rows(monkeypatch)
    k, lam, rho = torch.zeros(3, 4, 7), torch.zeros(3, 4, rows.M), torch.ones(3, 4)
    ks.alm_newton(rows, k, lam, rho)
    ks.alm_values(rows, k, lam, rho, torch.arange(4, dtype=torch.int32), True)
    ks.alm_maxima(rows, k)
    assert len(calls) == 3
    for a in calls:
        assert bytes(a.epi) == bytes(ks.AlmEpilogue())
        assert ks.EPI_PHASES[a.epi.phase] == "none"
    rows_text = (build.CSRC / "alm_rows.cuh").read_text()
    assert "AlmEpilogue epi;" in rows_text
    for src, ph in (("alm_newton.cu", "LADDER"), ("alm_values.cu", "ACCEPT")):
        text = (build.CSRC / src).read_text()
        assert "a.epi.phase" in text and f"ALM_EPI_{ph}" in text
    k8 = (build.CSRC / "alm_values.cu").read_text()
    assert set(re.findall(r"case ALM_EPI_(\w+):", k8)) == {
        p.upper() for p in ks.ALM_EPILOGUES if ks.ALM_EPILOGUES[p][0] == "alm_values"}
    assert "if (a.epi.phase == ALM_EPI_NONE) return;" in k8


def test_cpu_solve_takes_the_plain_book(monkeypatch):
    """On CPU tensors the solve's phases are the plain versions: it never
    reaches K14's launchers or the row passes that run its phases (each
    raises here), and gives the eager solve's result."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU solve reached K14")

    cfg, basis, prob = _port_problem("bernstein", W=1)
    want = tnlp.solve(prob, cfg, basis, eager=True)
    for name in vars(ks.LOOP):
        monkeypatch.setattr(ks.LOOP, name, refuse)
    for name in ("epilogue", "alm_newton", "alm_values"):
        monkeypatch.setattr(ks, name, refuse)
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
    """(phase, launcher args) of K14's own launches from a _state on the
    card, float32."""
    def f(n):
        x = torch.as_tensor(np.asarray(st[n]))
        return (x.to(dev) if x.dtype == torch.bool else x.to(dev, torch.float32)).contiguous()

    return [
        ("cull", (f("k"), f("lam"), f("rho"), f("best_k"), f("best_cost"), f("v"), f("cost"), 2)),
        ("select", (f("kb"), f("viol"), f("best_cost"), f("cost_final"), THR)),
    ]


def _step_cases(st, dev, M):
    """(phase, step args) of every phase run by a row pass, from a _state
    of the plan's sizes on the card (float32): the tracker's costs, m0 and
    the brackets with ties, infinities and NaN."""
    def f(n):
        x = torch.as_tensor(np.asarray(st[n]))
        return (x.to(dev) if x.dtype == torch.bool else x.to(dev, torch.float32)).contiguous()

    k, lam, rho, bk, bc = f("k"), f("lam"), f("rho"), f("best_k"), f("best_cost")
    mid = f("kq")[:, :k.shape[1]].contiguous()
    return [
        ("init", (k, lam, rho)),
        ("ladder", (k, lam, rho, bk, bc)),
        ("accept", (f("kq"), lam, rho, k, f("m0"), bk, bc)),
        ("outer", (k, lam, rho, bk, bc)),
        ("pull_start", (k, lam, rho, bk, bc)),
        ("pull_step", (mid, lam, rho, bk, k)),
        ("pull_end", (mid, lam, rho, k, bk, f("end_feas"), bc)),
        ("finish", (mid, lam, rho, k, bk, bc)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_k14_matches_the_plain_bookkeeping_on_the_card(seed):
    """K14's cull and selection against their plain versions on the same
    CUDA tensors (ties, infinities, NaN); and every phase run by a row
    pass's finish against the same pass without it followed by the plain
    phase (nlp.loop_pairs with K7 / K8 and nlp.PLAIN_LOOP), on a plan of
    the card in both families: every output the same bits, and the same
    again on a second call."""
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
    for family in ("bernstein", "armtd"):
        cfg, basis, prob = _port_problem(family, torch.float32, 3, dev)
        rows = ks.alm_rows(prob, cfg, basis)
        fused = _fused_steps(rows)
        plain = tnlp.loop_pairs(*_row_passes(rows), tnlp.PLAIN_LOOP, ALPHAS)
        st = _state(seed, W=3, S=4, A=3, F=7, M=rows.M)
        st["lam"][:, :, ::7] = 0.0
        for name, args in _step_cases(st, dev, rows.M):
            got, again = getattr(fused, name)(*args), getattr(fused, name)(*args)
            want = getattr(plain, name)(*args)
            got, again, want = (x if isinstance(x, tuple) else (x,) for x in (got, again, want))
            assert len(got) == len(want), name
            for g, a, w in zip(got, again, want):
                assert _bits_equal(g, w), (family, name)
                assert _bits_equal(g, a), (family, name)


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
@pytest.mark.parametrize("family", ["bernstein", "armtd", "grasp"])
def test_fused_solve_matches_the_eager_solve_on_the_card(family):
    """The solve with K14 (its phases in K7's / K8's finish) against the
    eager solve (K7 / K8 and the plain bookkeeping) on the same problem:
    k, feasible, cost and viol bit for bit, with and without the cull and
    from one start (k0); in both families and with the grasp group (a
    dumbbell plan, F = 7 of J = 9).  The fused solve launches K14 twice
    (the cull and the selection) and runs every other phase in a row
    pass."""
    from armour_tpu_torch import kernels

    dev = _card()
    if family == "grasp":
        from test_torch_kernel_geometry import _grasp_problem

        _, cfg, basis, prob = _grasp_problem(dev)
    else:
        cfg, basis, prob = _port_problem(family, torch.float32, 3, dev)
    kernels.reset_counts()
    tnlp.solve(prob, cfg, basis)
    assert kernels.counts()["alm_loop"] == 2
    assert sum(kernels.IN_FINISH.values()) == (kernels.counts()["alm_newton"]
                                               + kernels.counts()["alm_values"] - 2)
    for c, k0 in ((cfg, None), (dataclasses.replace(cfg, solver_cull_after=0), None),
                  (cfg, torch.zeros(prob.q_des.shape, device=dev))):
        a = tnlp.solve(prob, c, basis, k0=k0)
        b = tnlp.solve(prob, c, basis, k0=k0, eager=True)
        for f in ("k", "feasible", "cost", "viol"):
            assert _bits_equal(getattr(a, f), getattr(b, f)), f
        assert not bool(torch.isfinite(a.k[~a.feasible]).any())
        assert math.isfinite(float(a.cost[a.feasible].sum()))

"""The grasp path of the PyTorch port on the CPU (float64): the Kinova with
the dumbbell payload (J = 9 bodies, F = 7 actuated joints).

Against the JAX package at 1e-9: bpz.mul (in the order kernel K16 sums in)
on random PZs with and without slop, and the warp order of its sums; the PZ RNEA's
contact wrench (rnea_pz_sets(wrench_at=)) for the dumbbell and the Fetch
arm (both F < J) and on the uncertain-COM route; contact_wrench_frs,
grasp_frs and grasp_constraint_intervals; the numeric rnea(wrench_at=); a
grasp plan's constraint stack, Jacobian and full-set violations (the slice
as a whole).  Then the port's versions of tests/test_grasp.py: numeric
contact wrenches inside the wrench sets, the constraint bounds above every
sampled constraint value, and the planner gate (permissive contact
parameters feasible, a near-zero friction cone all NaN) at T = 16.  The
kernels against their plain versions on the card are in
tests/test_torch_kernel_geometry.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu import dynamics as j_dyn, grasp as j_grasp, nlp as j_nlp
from armour_tpu import rnea_numeric as j_rn
from armour_tpu.collision import build_hyperplanes as j_hyp, pad_obstacles as j_pad
from armour_tpu.collision import screen_collision as j_screen
from armour_tpu.config import ArmourConfig as JConfig
from armour_tpu.dynamics import torque_frs as j_torque_frs
from armour_tpu.jrs import build_jrs as j_build_jrs
from armour_tpu.kinematics import forward_occupancy as j_fo, reduce_links as j_rl
from armour_tpu.models import zoo as j_zoo
from armour_tpu.pz import basis as j_basis, bpz as j_bpz
from armour_tpu_torch import bezier, convert, dynamics, grasp, nlp, rnea_numeric
from armour_tpu_torch.collision import pad_obstacles, stack_obstacles
from armour_tpu_torch.config import ArmourConfig, derive_ultimate_bound
from armour_tpu_torch.jrs import build_jrs
from armour_tpu_torch.models import zoo
from armour_tpu_torch.planner import make_planner, problem_from_jrs
from armour_tpu_torch.pz import bpz
from armour_tpu_torch.pz.basis import error_layout, make_basis

T = 8
J_ROBOT = j_zoo.load_zoo_robot("kinova_dumbbell")
ROBOT = zoo.kinova_dumbbell()
F = ROBOT.num_factors
J_CFG = JConfig.for_robot(J_ROBOT, derive_ub=False, num_time_steps=T, dtype=jnp.float64)
CFG = ArmourConfig.for_robot(ROBOT, derive_ub=False, num_time_steps=T, dtype=torch.float64)
J_BASIS = j_basis.make_basis(F, 3)
BASIS = make_basis(F, 3)
Q0 = np.linspace(-0.4, 0.4, F)
QD0 = np.full(F, 0.1)
QDD0 = np.zeros(F)
PARAMS = ((0.6, 0.06, 2), (1.5, 0.5, 1))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small: one torch thread each, so that the
    six workers of a full run do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t_robot(jrobot):
    return convert.robot_from_fields({f.name: getattr(jrobot, f.name)
                                      for f in dataclasses.fields(jrobot)})


def _close(got, want, rtol=1e-9):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * 1e-3 * scale)


def _close_pz(got, want, rtol=1e-9):
    for f in ("coef", "egen", "rad"):
        _close(getattr(got, f), getattr(want, f), rtol)


def _j_setup(name):
    jr = j_zoo.load_zoo_robot(name)
    return jr, JConfig.for_robot(jr, derive_ub=False, num_time_steps=T, dtype=jnp.float64)


@functools.lru_cache(maxsize=4)
def _j_wrench(name, com):
    """The JAX package's JRS and its (u, f, n) after the last body, from
    Q0 / QD0 at rest acceleration, once per robot (one jitted program:
    cheaper than the eager scans)."""
    jr, jcfg = _j_setup(name)
    jr = dataclasses.replace(jr, com_uncertainty=com)
    n = jr.num_factors
    basis = j_basis.make_basis(n, 3)

    @jax.jit
    def run(q0, qd0):
        jrs = j_build_jrs(q0, qd0, jnp.zeros_like(q0), jr, jcfg, basis)
        return jrs, j_dyn.rnea_pz_sets(jrs, jr, jcfg, basis, wrench_at=jr.num_joints - 1)

    return run(jnp.linspace(-0.4, 0.4, n), jnp.full((n,), 0.1))


def _t_jrs(robot, cfg, basis):
    n = robot.num_factors
    q0, qd0 = np.linspace(-0.4, 0.4, n), np.full(n, 0.1)
    return build_jrs(torch.as_tensor(q0)[None], torch.as_tensor(qd0)[None],
                     torch.zeros(1, n, dtype=torch.float64), robot, cfg, basis)


@pytest.fixture(scope="module")
def jrs():
    return _t_jrs(ROBOT, CFG, BASIS)


def _random_pz(rng, shape, basis, E):
    return (rng.normal(size=shape + (basis.size,)) * rng.uniform(0, 2, shape + (basis.size,)),
            rng.normal(size=shape + (E,)) * 0.1, rng.uniform(0, 0.05, shape))


@pytest.mark.parametrize("slop", [0.0, 1e-6])
def test_mul_matches_jax(slop):
    """bpz.mul (K16's order) against the JAX bilinear on random PZs:
    independent operands, a square, and a broadcast operand."""
    rng = np.random.default_rng(3)
    E = error_layout(F)["size"]
    a, b = _random_pz(rng, (4, 5), BASIS, E), _random_pz(rng, (4, 5), BASIS, E)
    c = _random_pz(rng, (1, 5), BASIS, E)
    for x, y in ((a, b), (a, a), (a, c)):
        want = j_bpz.mul(j_bpz.BPZ(*map(jnp.asarray, x)), j_bpz.BPZ(*map(jnp.asarray, y)),
                         J_BASIS, slop)
        tx, ty = convert.bpz_from_numpy(*x), convert.bpz_from_numpy(*y)
        _close_pz(bpz.mul(tx, ty, BASIS, slop), want)


@pytest.mark.parametrize("n", [1, 31, 38, 64, 120])
def test_warp_sum_repeats_a_warp_reduction(n):
    """utils.warp_sum_in_order gives the bits of a warp's sum in pz_ops.cuh,
    lane by lane in float32: lane l sums x[l], x[l + 32], ... from 0, then
    the butterfly adds lane l ^ 16, ^ 8, ^ 4, ^ 2, ^ 1."""
    from armour_tpu_torch.utils import warp_sum_in_order

    x = np.abs(np.random.default_rng(n).normal(size=(3, n))).astype(np.float32) * 1e3
    for row, got in zip(x, warp_sum_in_order(torch.as_tensor(x))):
        lanes = [np.float32(0.0)] * 32
        for i, v in enumerate(row):
            lanes[i % 32] = np.float32(lanes[i % 32] + v)
        for off in (16, 8, 4, 2, 1):
            lanes = [np.float32(lanes[l] + lanes[l ^ off]) for l in range(32)]
        assert got.dtype == torch.float32 and got.item() == lanes[0]


@pytest.mark.parametrize("name, com", [("kinova_dumbbell", 0.0), ("fetch_arm", 0.0),
                                       ("kinova_dumbbell", 0.05)],
                         ids=["dumbbell", "fetch_arm", "dumbbell_com_0.05"])
def test_rnea_wrench_matches_jax(name, com):
    """The torque and the wrench after the last body for F < J robots, on
    the plain chain and on the uncertain-COM route (K1 / K2's loops)."""
    jr, jcfg = _j_setup(name)
    robot = t_robot(dataclasses.replace(jr, com_uncertainty=com))
    cfg = convert.config_from_fields({f.name: getattr(jcfg, f.name)
                                      for f in dataclasses.fields(jcfg)})
    basis = make_basis(robot.num_factors, 3)
    wj = robot.num_joints - 1
    want = _j_wrench(name, com)[1]
    got = dynamics.rnea_pz_sets(_t_jrs(robot, cfg, basis), robot, cfg, basis, wrench_at=wj)
    for g, w in zip(got, want):
        _close_pz(bpz.BPZ(coef=g.coef[0], egen=g.egen[0], rad=g.rad[0]), w)
    # the torque alone is the same pass
    u = dynamics.rnea_pz_sets(_t_jrs(robot, cfg, basis), robot, cfg, basis)
    assert torch.equal(u.coef, got[0].coef) and torch.equal(u.rad, got[0].rad)


@pytest.mark.parametrize("mu, r, axis", PARAMS)
def test_grasp_sets_match_jax(jrs, mu, r, axis):
    """contact_wrench_frs, grasp_frs (the plain K16 route) and
    grasp_constraint_intervals (bpz.mul) against the JAX package; the JAX
    rows are grasp_frs's (armour_tpu/grasp.py:131-140) on the JAX wrench
    (its RNEA formed once for the module; grasp_frs itself runs in
    test_grasp_problem_matches_jax)."""
    jp = j_grasp.GraspParams(mu=mu, support_radius=r, normal_axis=axis)
    tp = grasp.GraspParams(mu=mu, support_radius=r, normal_axis=axis)
    _, jf, jn = _j_wrench("kinova_dumbbell", 0.0)[1]

    def pick(p, i):
        return j_bpz.BPZ(coef=p.coef[i], egen=p.egen[i], rad=p.rad[i])

    jw = j_grasp.ContactWrenchFRS(f_nom=pick(jf, 0), n_nom=pick(jn, 0), f_int=pick(jf, 1),
                                  n_int=pick(jn, 1))
    tw = grasp.contact_wrench_frs(jrs, ROBOT, CFG, BASIS)
    # the JAX wrench carried across as numpy
    back = convert.contact_wrench_from_numpy(*[
        tuple(np.asarray(getattr(getattr(jw, f), x)) for x in ("coef", "egen", "rad"))
        for f in ("f_nom", "n_nom", "f_int", "n_int")])
    for f in ("f_nom", "n_nom", "f_int", "n_int"):
        g = getattr(tw, f)
        _close_pz(bpz.BPZ(coef=g.coef[0], egen=g.egen[0], rad=g.rad[0]), getattr(jw, f))
        _close_pz(bpz.BPZ(coef=g.coef[0], egen=g.egen[0], rad=g.rad[0]), getattr(back, f))
    jrows = [j_bpz.reduce_(p) for p in j_grasp._contact_constraint_pzs(jw, jp, J_BASIS, J_CFG)]
    jrows = j_grasp.GraspFRS(g_coef=jnp.stack([p.coef for p in jrows], axis=1),
                             g_rad=jnp.stack([p.rad for p in jrows], axis=1))
    trows = grasp.grasp_frs(jrs, ROBOT, CFG, BASIS, tp)
    _close(trows.g_coef[0], jrows.g_coef)
    _close(trows.g_rad[0], jrows.g_rad)
    for g, w in zip(grasp.grasp_constraint_intervals(tw, tp, BASIS, CFG),
                    j_grasp.grasp_constraint_intervals(jw, jp, J_BASIS, J_CFG)):
        _close(g[0], w)
    # the carried-across JAX rows are the port's
    back = convert.grasp_frs_from_numpy(np.asarray(jrows.g_coef), np.asarray(jrows.g_rad))
    _close(trows.g_coef[0], back.g_coef.numpy())


def test_numeric_wrench_matches_jax():
    """rnea(wrench_at=) at sampled states with perturbed masses."""
    rng = np.random.default_rng(4)
    q, qd, qda, qdd = (rng.uniform(-1, 1, (5, F)) for _ in range(4))
    mass = ROBOT.mass * (1.0 + rng.uniform(-0.03, 0.03, (5, ROBOT.num_joints)))
    for j in (ROBOT.num_joints - 1, 4):
        want = j_rn.rnea(J_ROBOT, *(jnp.asarray(x) for x in (q, qd, qda, qdd)),
                         mass=jnp.asarray(mass), wrench_at=j)
        got = rnea_numeric.rnea(ROBOT, *(torch.as_tensor(x) for x in (q, qd, qda, qdd)),
                                mass=torch.as_tensor(mass), wrench_at=j)
        for g, w in zip(got, want):
            _close(g, w)


def _sample_traj(rng, t_ind, cfg=CFG):
    ds = 1.0 / cfg.num_time_steps
    s = rng.uniform(t_ind * ds, (t_ind + 1) * ds)
    k = rng.uniform(-1, 1, F)
    k_act = torch.as_tensor(k * np.asarray(cfg.k_range))
    args = [torch.as_tensor(x) for x in (Q0, QD0 * cfg.duration, QDD0 * cfg.duration ** 2)]
    q = bezier.q_des(*args, k_act, s)
    qd = bezier.qd_des(*args, k_act, s) / cfg.duration
    qdd = bezier.qdd_des(*args, k_act, s) / cfg.duration ** 2
    return q, qd, qdd, torch.as_tensor(k)


def _slice(p, t, phi):
    """(centre, radius) of PZ p[0, t] sliced at phi(k)."""
    c = (p.coef[0, t] * phi).sum(-1)
    return c, p.egen[0, t].abs().sum(-1) + p.rad[0, t]


@pytest.mark.parametrize("which", ["nom", "int"])
def test_contact_wrench_containment(jrs, which):
    """Numeric contact wrenches at sampled states (nominal parameters, or
    masses and inertias within their uncertainty) lie in the sliced wrench
    sets."""
    w = grasp.contact_wrench_frs(jrs, ROBOT, CFG, BASIS)
    j = ROBOT.num_joints - 1
    rng = np.random.default_rng(12 if which == "nom" else 13)
    for _ in range(20):
        t_ind = int(rng.integers(0, T))
        q, qd, qdd, k = _sample_traj(rng, t_ind)
        kw = {}
        if which == "int":
            dm = 1.0 + rng.uniform(-1, 1, ROBOT.num_joints) * ROBOT.mass_uncertainty
            dI = 1.0 + rng.uniform(-1, 1, (ROBOT.num_joints, 1, 1)) * ROBOT.inertia_uncertainty
            kw = dict(mass=torch.as_tensor(ROBOT.mass * dm),
                      inertia=torch.as_tensor(ROBOT.inertia * dI))
        _, f_true, n_true = rnea_numeric.rnea(ROBOT, q, qd, qd, qdd, wrench_at=j, **kw)
        phi = BASIS.phi(k)
        for p, truth in ((getattr(w, "f_" + which), f_true), (getattr(w, "n_" + which), n_true)):
            c, r = _slice(p, t_ind, phi)
            assert bool(((truth - c).abs() <= r + 1e-10).all()), (t_ind, truth, c, r)


@pytest.mark.parametrize("mu, r, axis", PARAMS)
def test_grasp_bounds_are_sound(jrs, mu, r, axis):
    """The interval bounds and the k-sliced rows g_coef . phi(k) + g_rad
    upper-bound every sampled numeric separation / slipping / tipping value."""
    params = grasp.GraspParams(mu=mu, support_radius=r, normal_axis=axis)
    w = grasp.contact_wrench_frs(jrs, ROBOT, CFG, BASIS)
    bounds = grasp.grasp_constraint_intervals(w, params, BASIS, CFG)
    rows = grasp.grasp_frs(jrs, ROBOT, CFG, BASIS, params)
    t_axes = [i for i in range(3) if i != axis]
    rng = np.random.default_rng(14)
    for _ in range(20):
        t_ind = int(rng.integers(0, T))
        q, qd, qdd, k = _sample_traj(rng, t_ind)
        _, f, n = rnea_numeric.rnea(ROBOT, q, qd, qd, qdd, wrench_at=ROBOT.num_joints - 1)
        truth = torch.stack([
            -f[axis],
            f[t_axes[0]] ** 2 + f[t_axes[1]] ** 2 - mu ** 2 * f[axis] ** 2,
            n[t_axes[0]] ** 2 + n[t_axes[1]] ** 2 - r ** 2 * f[axis] ** 2])
        upper = torch.stack([b[0, t_ind] for b in bounds])
        assert bool((truth <= upper + 1e-8).all()), (t_ind, truth, upper)
        g = rows.g_coef[0, t_ind] @ BASIS.phi(k) + rows.g_rad[0, t_ind]
        assert bool((truth <= g + 1e-8).all()), (t_ind, truth, g)


def _j_problem(q_des, obs, cfg):
    """The JAX package's grasp plan from the module's JRS (Q0, QD0 at rest
    acceleration; the JRS reads no grasp, obstacle or screen setting), its
    stages in one jitted program."""
    @jax.jit
    def build(jrs, q_des, obs):
        frs = j_rl(j_fo(jrs, J_ROBOT, cfg, J_BASIS), J_BASIS)
        hyp = j_hyp(frs, obs)
        return j_nlp.PlanProblem(
            traj=jrs.traj, q_des=q_des, torque=j_torque_frs(jrs, J_ROBOT, cfg, J_BASIS),
            frs=frs, hyp=hyp, obs=obs,
            screened=j_screen(hyp, obs, frs, cfg.screen_k, cfg.screen_obstacle_quota),
            grasp=j_grasp.grasp_frs(jrs, J_ROBOT, cfg, J_BASIS, j_grasp.GraspParams(
                mu=cfg.grasp_mu, support_radius=cfg.grasp_support_radius,
                normal_axis=cfg.grasp_normal_axis)))

    return build(_j_wrench("kinova_dumbbell", 0.0)[0], q_des, obs)


@pytest.mark.parametrize("smooth", [False, True], ids=["off", "on"])
def test_grasp_problem_matches_jax(smooth):
    """The slice as a whole: a grasp plan's constraint stack (torque, grasp,
    collision, state rows), its Jacobian and the full-set violations at
    sampled k, through planner.problem_from_jrs against the JAX package's
    stages, in the hard and the smooth collision mode."""
    jcfg = dataclasses.replace(J_CFG, grasp_constraints=True, grasp_mu=1.5,
                               grasp_support_radius=0.5, max_obstacles=4, screen_k=64,
                               smooth_obstacle_constraints=smooth)
    cfg = convert.config_from_fields({f.name: getattr(jcfg, f.name)
                                      for f in dataclasses.fields(jcfg)})
    c = np.array([[0.5, 0.4, 0.6], [2.0, 2.0, 2.0]])
    g = np.stack([np.diag([0.05, 0.06, 0.07])] * 2)
    q_des = Q0 + 0.05
    jobs = j_pad(c, g, 4, jnp.float64)
    jprob = _j_problem(jnp.asarray(q_des), jobs, jcfg)
    obs = stack_obstacles([pad_obstacles(c, g, 4, torch.float64)])
    tprob = problem_from_jrs(_t_jrs(ROBOT, cfg, BASIS), torch.as_tensor(q_des)[None], obs,
                             ROBOT, cfg, BASIS)
    assert tprob.grasp.g_coef.shape == (1, T, 3, BASIS.size)
    rng = np.random.default_rng(5)
    ks = rng.uniform(-1, 1, (3, F))
    ks[0] = 0.0
    for k in ks:
        jc, jJ = j_nlp.constraint_stack(jnp.asarray(k), jprob, J_ROBOT, jcfg, J_BASIS)
        tc, tJ = nlp.constraint_stack(torch.as_tensor(k)[None, None], tprob, cfg, BASIS)
        _close(tc[0, 0], jc)
        _close(tJ[0, 0], jJ)
        jv = j_nlp.max_violations(jnp.asarray(k), jprob, J_ROBOT, jcfg, J_BASIS)
        tv = nlp.max_violations(torch.as_tensor(k)[None, None], tprob, cfg, BASIS)
        for a, b in zip(tv, jv):
            _close(a[0, 0], b)
    assert nlp._stack_thresholds(tprob, cfg).shape[0] == tc.shape[-1]


def test_grasp_rows_gate_the_planner():
    """The port's planner on the CPU (the plain versions of every kernel):
    with permissive contact parameters a feasible k whose grasp rows hold;
    with a near-zero friction cone the same problem is rejected (NaN k) though
    it is feasible without grasp rows (tests/test_grasp.py:127-173 at the
    same settings)."""
    q0 = torch.as_tensor(np.linspace(-0.3, 0.3, F))
    qd0 = torch.full((F,), 0.1, dtype=torch.float64)
    qdd0 = torch.zeros(F, dtype=torch.float64)
    obs = pad_obstacles(np.array([[2.0, 2.0, 2.0]]), np.stack([np.diag([0.05] * 3)]), 8,
                        torch.float64)
    base = dict(derive_ub=False, ub=derive_ultimate_bound(ROBOT, v_max=5e-4),
                num_time_steps=16, dtype=torch.float64, max_obstacles=8, screen_k=256)
    res = {}
    for name, kw in (("off", {}),
                     ("ok", dict(grasp_constraints=True, grasp_mu=1.5,
                                 grasp_support_radius=0.5)),
                     ("tight", dict(grasp_constraints=True, grasp_mu=1e-4,
                                    grasp_support_radius=1e-4))):
        cfg = ArmourConfig.for_robot(ROBOT, **base, **kw)
        res[name] = make_planner(ROBOT, cfg, device="cpu")(q0, qd0, qdd0, q0 + 0.05, obs)
    assert bool(res["off"].feasible), "baseline (no grasp rows) must be feasible"
    assert bool(res["ok"].feasible), "permissive contact parameters must stay feasible"
    assert bool(torch.isfinite(res["ok"].k).all())
    assert float(res["ok"].viol[3]) <= 1e-4
    assert not bool(res["tight"].feasible)
    assert bool(torch.isnan(res["tight"].k).all())


@pytest.mark.slow
def test_float32_grasp_solves_meet_failed_cholesky_in_both_packages(monkeypatch):
    """In float32 the grasp plan's Gauss-Newton H can lose its 1e-3
    regulariser to rounding (rows carry rho up to 1e6), so its Cholesky
    fails: the JAX package's solve meets such factors too, its cho_factor
    giving the all-NaN step that nlp.newton_step gives.  The dumbbell's
    grasp plan in the smooth mode at T = 48 (contact (1.5, 0.5), V_max 5e-4,
    screen_k 512) on six saved worlds whose full-size plan failed on the
    card: both packages' float32 solves meet failed factors (on which
    (world, seed) is a matter of rounding), give every world the same
    verdict, and the port's failed steps are NaN."""
    import glob

    import jax.scipy.linalg as jsl

    from armour_tpu.config import derive_ultimate_bound as j_dub
    from armour_tpu.planner import make_planner as j_make_planner
    from armour_tpu.worlds import load_world_csv, straight_line_waypoint
    from armour_tpu_torch.planner import make_batch_planner

    paths = sorted(glob.glob("saved_worlds/random/*.csv"))
    worlds = [load_world_csv(paths[i]) for i in (12, 19, 22, 37, 52, 54)]
    jcfg = JConfig.for_robot(J_ROBOT, derive_ub=False, ub=j_dub(J_ROBOT, v_max=5e-4),
                             dtype=jnp.float32, num_time_steps=48, screen_k=512,
                             grasp_constraints=True, grasp_mu=1.5, grasp_support_radius=0.5,
                             smooth_obstacle_constraints=True)
    q0 = np.stack([w.start for w in worlds]).astype(np.float32)
    q_des = np.stack([straight_line_waypoint(w.start, w.goal,
                                             continuous=J_ROBOT.continuous_joints)
                      for w in worlds]).astype(np.float32)
    z = np.zeros_like(q0)

    j_failed = []
    cho_factor = jsl.cho_factor

    def recording_cho_factor(H, *args, **kwargs):
        c = cho_factor(H, *args, **kwargs)
        jax.debug.callback(lambda L: j_failed.append(bool(np.isnan(np.asarray(L)).any())), c[0])
        return c

    monkeypatch.setattr(jsl, "cho_factor", recording_cho_factor)
    j_step = j_make_planner(J_ROBOT, jcfg)
    j_feas = []
    for i, w in enumerate(worlds):
        obs = j_pad(w.obstacle_centers, w.obstacle_generators, jcfg.max_obstacles, jnp.float32)
        j_feas.append(bool(j_step(q0[i], z[i], z[i], q_des[i], obs).feasible))
    jax.effects_barrier()

    t_failed = []
    newton_step = nlp.newton_step

    def recording_newton_step(H, g):
        step = newton_step(H, g)
        bad = torch.linalg.cholesky_ex(H)[1] != 0
        assert bool(torch.isnan(step[bad]).all()) and bool(torch.isfinite(step[~bad]).all())
        t_failed.append(int(bad.sum()))
        return step

    monkeypatch.setattr(nlp, "newton_step", recording_newton_step)
    cfg = convert.config_from_fields({f.name: getattr(jcfg, f.name)
                                      for f in dataclasses.fields(jcfg)})
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    obs = stack_obstacles([pad_obstacles(w.obstacle_centers, w.obstacle_generators,
                                         cfg.max_obstacles, torch.float32) for w in worlds])
    res = make_batch_planner(t_robot(J_ROBOT), cfg, device="cpu")(q0, z, z, q_des, obs)
    assert sum(j_failed) > 0 and sum(t_failed) > 0, (sum(j_failed), sum(t_failed))
    assert res.feasible.tolist() == j_feas

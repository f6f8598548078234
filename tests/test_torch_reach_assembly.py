"""The reach sets' assembly after the chain kernels (kernel K15,
csrc/reach_assembly.cu: the torque_frs assembly and reduce_links) on the
CPU.

reach_assembly_plain, K15's plain version, against the JAX package's
torque_frs and reduce_links in float64 (1e-9), for the Kinova and for a
centre of mass uncertain by 5% (the K1 / K2 route of the RNEA); its sums
against a numpy loop that adds left to right in float32 (bit for bit), and
against the torch.sum route it replaced, to float32 rounding; torque_frs
and reduce_links alone against it; a planning step through
planner.problem_from_jrs against the JAX planner.  All at T = 16.  K15
against its plain version on the card is
tests/test_torch_kernel_geometry.py::test_k15_matches_its_plain_version_on_the_card."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu.collision import pad_obstacles as j_pad
from armour_tpu.config import ArmourConfig as JConfig
from armour_tpu.dynamics import torque_frs as j_torque_frs
from armour_tpu.jrs import build_jrs as j_build_jrs
from armour_tpu.kinematics import forward_occupancy as j_fo, reduce_links as j_rl
from armour_tpu.models.kinova import kinova_gen3 as j_kinova
from armour_tpu.planner import make_planner as j_make_planner
from armour_tpu.pz.basis import make_basis as j_make_basis
from armour_tpu_torch import convert, dynamics, kinematics
from armour_tpu_torch.collision import pad_obstacles, stack_obstacles
from armour_tpu_torch.jrs import build_jrs
from armour_tpu_torch.planner import make_batch_planner, problem_from_jrs
from armour_tpu_torch.pz import bpz
from armour_tpu_torch.pz.basis import error_layout, make_basis
from armour_tpu_torch.worlds import load_world_csv, straight_line_waypoint

T = 16
J_ROBOT = j_kinova()
J_CFG = JConfig(num_time_steps=T, dtype=jnp.float64, max_obstacles=16, screen_k=256,
                solver_outer_iters=3, solver_inner_iters=3)
J_BASIS = j_make_basis(7, 3)
BASIS = make_basis(7, 3)
T_CFG = convert.config_from_fields({f.name: getattr(J_CFG, f.name)
                                    for f in dataclasses.fields(J_CFG)})
STATES = (
    (np.array([0.6543, -0.0876, -0.4837, -1.2278, -1.5735, -1.0720, 0.0]),
     np.zeros(7), np.zeros(7)),
    (np.array([0.1, 0.4, -0.3, -1.0, 0.8, 0.5, -2.0]),
     np.array([0.3, -0.2, 0.25, 0.1, -0.4, 0.35, 0.2]),
     np.array([0.5, 0.3, -0.6, 0.2, 0.1, -0.3, 0.4])),
)
SCENES = ("scene_013_001", "scene_013_002")


def t_robot(jrobot):
    return convert.robot_from_fields({f.name: getattr(jrobot, f.name)
                                      for f in dataclasses.fields(jrobot)})


def _chains(robot, dtype=torch.float64, T_steps=T):
    """The port's plain FK links and RNEA u_both of the two STATES (W = 2)."""
    q0, qd0, qdd0 = (torch.as_tensor(np.stack([s[i] for s in STATES]), dtype=dtype)
                     for i in range(3))
    cfg = dataclasses.replace(T_CFG, dtype=dtype, num_time_steps=T_steps)
    jrs = build_jrs(q0, qd0, qdd0, robot, cfg, BASIS)
    return (jrs, kinematics.forward_occupancy_plain(jrs, robot, cfg, BASIS),
            dynamics.rnea_pz_sets_plain(jrs, robot, cfg, BASIS), cfg)


@functools.lru_cache(maxsize=2)
def _j_stages(com_uncertainty):
    """The JAX package's reduce_links and torque_frs of one state, jitted
    once per COM uncertainty."""
    jrobot = dataclasses.replace(J_ROBOT, com_uncertainty=com_uncertainty)

    @jax.jit
    def stages(q0, qd0, qdd0):
        jrs = j_build_jrs(q0, qd0, qdd0, jrobot, J_CFG, J_BASIS)
        return j_rl(j_fo(jrs, jrobot, J_CFG, J_BASIS), J_BASIS), \
            j_torque_frs(jrs, jrobot, J_CFG, J_BASIS)

    return stages


@pytest.fixture(scope="module", params=[0.0, 0.05], ids=["kinova", "com_0.05"])
def assembled(request):
    """(JAX (frs, torque) per state, the port's reach_assembly_plain, robot)."""
    robot = t_robot(dataclasses.replace(J_ROBOT, com_uncertainty=request.param))
    _, links, u_both, cfg = _chains(robot)
    want = [_j_stages(request.param)(*(jnp.asarray(x) for x in s)) for s in STATES]
    return want, dynamics.reach_assembly_plain(links, u_both, robot, cfg, BASIS)


def _close(got, want, rtol=1e-9):
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * 1e-3 * scale)


def test_reach_assembly_plain_matches_jax(assembled):
    want, (frs, torque) = assembled
    for w, (j_frs, j_tq) in enumerate(want):
        _close(torque.u_coef[w], j_tq.u_coef)
        _close(torque.torque_radius[w], j_tq.torque_radius)
        for f in ("center_coef", "shape_gens", "radius"):
            _close(getattr(frs, f)[w], getattr(j_frs, f))


@pytest.mark.parametrize("com_uncertainty", [0.0, 0.05])
def test_public_functions_give_the_assembly(com_uncertainty):
    """torque_frs and reduce_links alone (the CPU route) give
    reach_assembly_plain's bits (T = 4); u_coef and center_coef are
    views."""
    robot = t_robot(dataclasses.replace(J_ROBOT, com_uncertainty=com_uncertainty))
    jrs, links, u_both, cfg = _chains(robot, T_steps=4)
    frs, torque = dynamics.reach_assembly_plain(links, u_both, robot, cfg, BASIS)
    tq = dynamics.torque_frs(jrs, robot, cfg, BASIS)
    fr = kinematics.reduce_links(links, BASIS)
    assert torch.equal(tq.torque_radius, torque.torque_radius)
    assert torch.equal(tq.u_coef, torque.u_coef)
    for f in ("center_coef", "shape_gens", "radius"):
        assert torch.equal(getattr(fr, f), getattr(frs, f))
    assert frs.center_coef.data_ptr() == links.coef.data_ptr()
    assert torque.u_coef.data_ptr() == u_both.coef.data_ptr()


def _numpy_in_order(links, u_both, robot, cfg):
    """The assembly in float32 numpy, every sum a Python loop left to right
    from 0, each operation rounded to float32 as K15 rounds it."""
    f32 = np.float32
    c, e, r = (x.numpy() for x in (u_both.coef, u_both.egen, u_both.rad))
    Wn, _, Tn, F = r.shape
    ub = cfg.ub
    c0 = f32(ub.alpha * (ub.m_max - ub.m_min) * ub.eps)
    fr = np.asarray(robot.friction[:F], np.float64).astype(f32)
    tr = np.zeros((Wn, Tn, F), f32)
    for w in range(Wn):
        for t in range(Tn):
            sq, dmax, nrad = [], [], []
            for f in range(F):
                dcf = c[w, 1, t, f] - c[w, 0, t, f]
                def_ = e[w, 1, t, f] - e[w, 0, t, f]
                s1 = f32(0)
                for x in dcf[1:]:
                    s1 = f32(s1 + abs(x))
                s2 = f32(0)
                for x in def_:
                    s2 = f32(s2 + abs(x))
                dr = f32(f32(s1 + s2) + f32(r[w, 1, t, f] + r[w, 0, t, f]))
                lo, hi = f32(dcf[0] - dr), f32(dcf[0] + dr)
                dmax.append(max(abs(lo), abs(hi)))
                sq.append(max(f32(lo * lo), f32(hi * hi)))
                s = f32(0)
                for x in e[w, 0, t, f]:
                    s = f32(s + abs(x))
                nrad.append(f32(r[w, 0, t, f] + s))
            rho_sq = sq[0]
            for x in sq[1:]:
                rho_sq = f32(rho_sq + x)
            rho = f32(np.sqrt(rho_sq))
            for f in range(F):
                tr[w, t, f] = f32(f32(f32(f32(c0 + f32(0.5) * dmax[f]) + f32(0.5) * rho)
                                      + nrad[f]) + fr[f])
    sh = error_layout(BASIS.nf)["shape"]
    le, lr = links.egen.numpy(), links.rad.numpy()
    radius = np.zeros(lr.shape, f32)
    for idx in np.ndindex(*lr.shape):
        s = f32(0)
        for x in np.concatenate([le[idx][: sh.start], le[idx][sh.stop:]]):
            s = f32(s + abs(x))
        radius[idx] = f32(lr[idx] + s)
    return tr, radius


@pytest.fixture(scope="module")
def chains32():
    """The Kinova's plain chains of the two STATES in float32, and the robot."""
    robot = t_robot(J_ROBOT)
    return _chains(robot, torch.float32), robot


def test_sums_run_left_to_right(chains32):
    """In float32 the plain version gives, bit for bit, a numpy loop that
    adds every term left to right from 0 (the order K15 sums in)."""
    (_, links, u_both, cfg), robot = chains32
    links = bpz.BPZ(coef=links.coef[:, :4], egen=links.egen[:, :4], rad=links.rad[:, :4])
    u_both = bpz.BPZ(coef=u_both.coef[:, :, :4], egen=u_both.egen[:, :, :4],
                     rad=u_both.rad[:, :, :4])
    frs, torque = dynamics.reach_assembly_plain(links, u_both, robot, cfg, BASIS)
    tr, radius = _numpy_in_order(links, u_both, robot, cfg)
    assert np.array_equal(torque.torque_radius.numpy(), tr)
    assert np.array_equal(frs.radius.numpy(), radius)


def test_sums_match_the_torch_sum_route_to_float32_rounding(chains32):
    """Against the torch.sum route the port took before K15 (bpz.to_interval,
    bpz.reduce_, torch.sum over F and over the other egen slots), in
    float32: the radii, sums of at most 157 nonnegative terms, agree within
    160 float32 ulps of their size."""
    (_, links, u_both, cfg), robot = chains32
    frs, torque = dynamics.reach_assembly_plain(links, u_both, robot, cfg, BASIS)

    u_nom = bpz.BPZ(coef=u_both.coef[:, 0], egen=u_both.egen[:, 0], rad=u_both.rad[:, 0])
    u_int = bpz.BPZ(coef=u_both.coef[:, 1], egen=u_both.egen[:, 1], rad=u_both.rad[:, 1])
    d_c, d_r = bpz.to_interval(bpz.sub(u_int, u_nom))
    d_lo, d_hi = d_c - d_r, d_c + d_r
    ub = cfg.ub
    rho = torch.sqrt(torch.sum(torch.maximum(d_lo * d_lo, d_hi * d_hi), dim=-1))
    friction = torch.as_tensor(robot.friction[:7], dtype=torch.float32)
    old_tr = (ub.alpha * (ub.m_max - ub.m_min) * ub.eps
              + 0.5 * torch.maximum(torch.abs(d_lo), torch.abs(d_hi))
              + 0.5 * rho[..., None] + bpz.reduce_(u_nom).rad + friction)
    sh = error_layout(BASIS.nf)["shape"]
    other = torch.cat([links.egen[..., : sh.start], links.egen[..., sh.stop:]], dim=-1)
    old_radius = links.rad + torch.sum(torch.abs(other), dim=-1)
    ulp = 2.0 ** -23
    for got, old in ((torque.torque_radius, old_tr), (frs.radius, old_radius)):
        assert bool(((got - old).abs() <= 160 * ulp * old.abs()).all())
    assert torch.equal(frs.shape_gens, links.egen[..., sh])


@pytest.fixture(scope="module")
def steps():
    """Two saved scenes at rest through the JAX planner (one world a call)
    and the port's batched planner on the CPU, whose problem is built by
    problem_from_jrs."""
    worlds = [load_world_csv(f"saved_worlds/random/{n}.csv") for n in SCENES]
    robot = t_robot(J_ROBOT)
    q0 = np.stack([w.start for w in worlds])
    q_des = np.stack([straight_line_waypoint(w.start, w.goal,
                                             continuous=robot.continuous_joints)
                      for w in worlds])
    j_step = j_make_planner(J_ROBOT, J_CFG)
    z = jnp.zeros(7)
    want = [j_step(jnp.asarray(q0[i]), z, z, jnp.asarray(q_des[i]),
                   j_pad(w.obstacle_centers, w.obstacle_generators, J_CFG.max_obstacles,
                         jnp.float64))
            for i, w in enumerate(worlds)]
    obs = stack_obstacles([pad_obstacles(w.obstacle_centers, w.obstacle_generators,
                                         T_CFG.max_obstacles, torch.float64) for w in worlds])
    zt = np.zeros_like(q0)
    got = make_batch_planner(robot, T_CFG, device="cpu")(q0, zt, zt, q_des, obs)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)   # noqa: E731
    jrs = build_jrs(t(q0), t(zt), t(zt), robot, T_CFG, BASIS)
    prob = problem_from_jrs(jrs, t(q_des), obs, robot, T_CFG, BASIS)
    return want, got, prob, q0


def test_planner_step_matches_jax(steps):
    """Feasibility and cost of the step, and the problem's torque radius and
    link radii against the JAX stages."""
    want, got, prob, q0 = steps
    z = jnp.zeros(7)
    for w, res in enumerate(want):
        assert bool(got.feasible[w]) == bool(res.feasible)
        if bool(res.feasible):
            assert abs(float(got.cost[w]) - float(res.cost)) <= 1e-6 + 1e-6 * abs(float(res.cost))
        j_frs, j_tq = _j_stages(0.0)(jnp.asarray(q0[w]), z, z)
        _close(prob.torque.torque_radius[w], j_tq.torque_radius)
        _close(prob.frs.radius[w], j_frs.radius)
        _close(prob.frs.shape_gens[w], j_frs.shape_gens)

"""Parity of the PyTorch port's reachable-set stages with the JAX package,
float64 on the CPU at num_time_steps = 8: build_jrs, forward_occupancy +
reduce_links and torque_frs, every field within 1e-9 relative.  The CPU
branch of the K1/K2 wrappers is the plain version, so this checks the
plain PZ products inside the whole FK/RNEA chains."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu.config import ArmourConfig as JConfig
from armour_tpu.dynamics import torque_frs as j_torque_frs
from armour_tpu.jrs import build_jrs as j_build_jrs
from armour_tpu.kinematics import forward_occupancy as j_fo, reduce_links as j_rl
from armour_tpu.models.kinova import kinova_gen3 as j_kinova
from armour_tpu.pz.basis import make_basis as j_make_basis
from armour_tpu_torch import convert
from armour_tpu_torch.dynamics import torque_frs
from armour_tpu_torch.jrs import JRS, TrajectoryCoeffs, build_jrs
from armour_tpu_torch.kinematics import forward_occupancy, reduce_links
from armour_tpu_torch.pz.basis import make_basis

T = 8
J_ROBOT = j_kinova()
J_CFG = JConfig(num_time_steps=T, dtype=jnp.float64)
J_BASIS = j_make_basis(7, 3)
T_BASIS = make_basis(7, 3)
T_CFG = convert.config_from_fields({f.name: getattr(J_CFG, f.name)
                                    for f in dataclasses.fields(J_CFG)})


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


def _stages_fn(jrobot, cfg):
    @jax.jit
    def stages(q0, qd0, qdd0):
        jrs = j_build_jrs(q0, qd0, qdd0, jrobot, cfg, J_BASIS)
        frs = j_rl(j_fo(jrs, jrobot, cfg, J_BASIS), J_BASIS)
        return jrs, frs, j_torque_frs(jrs, jrobot, cfg, J_BASIS)
    return stages


J_STAGES = _stages_fn(J_ROBOT, J_CFG)

STATES = {
    "rest": (np.array([0.6543, -0.0876, -0.4837, -1.2278, -1.5735, -1.0720, 0.0]),
             np.zeros(7), np.zeros(7)),
    "moving": (np.array([0.1, 0.4, -0.3, -1.0, 0.8, 0.5, -2.0]),
               np.array([0.3, -0.2, 0.25, 0.1, -0.4, 0.35, 0.2]),
               np.array([0.5, 0.3, -0.6, 0.2, 0.1, -0.3, 0.4])),
    "braking": (np.array([-2.5, 1.2, 2.9, -2.0, -0.7, 1.6, 3.0]),
                np.array([-1.1, 0.9, 0.6, -0.8, 1.0, -0.9, 0.7]),
                np.zeros(7)),
}


def close(t, j, rtol=1e-9):
    t = t.detach().numpy()
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    scale = max(1.0, float(np.max(np.abs(j)))) if j.size else 1.0
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * 1e-3 * scale)


def close_bpz(tp, jp):
    # the port carries a leading worlds axis (W = 1 here)
    close(tp.coef[0], jp.coef)
    close(tp.egen[0], jp.egen)
    close(tp.rad[0], jp.rad)


def run_both(name, jstages=J_STAGES, robot=None, cfg=T_CFG):
    q0, qd0, qdd0 = STATES[name]
    jrs, frs, tq = jstages(jnp.asarray(q0), jnp.asarray(qd0), jnp.asarray(qdd0))
    robot = robot or t_robot(J_ROBOT)
    args = [torch.as_tensor(x)[None] for x in (q0, qd0, qdd0)]
    t_jrs = build_jrs(*args, robot, cfg, T_BASIS)
    t_frs = reduce_links(forward_occupancy(t_jrs, robot, cfg, T_BASIS), T_BASIS)
    return (jrs, frs, tq), (t_jrs, t_frs, torque_frs(t_jrs, robot, cfg, T_BASIS))


@pytest.fixture(scope="module", params=sorted(STATES))
def stages(request):
    return run_both(request.param)


def test_jrs_matches_jax(stages):
    (jrs, _, _), (t_jrs, _, _) = stages
    for f in ("R", "Rt", "qd", "qda", "qdda"):
        close_bpz(getattr(t_jrs, f), getattr(jrs, f))
    for f in ("q0", "qd0", "qdd0", "Tqd0", "TTqdd0", "k_scale"):
        close(getattr(t_jrs.traj, f)[0], getattr(jrs.traj, f))


def test_link_frs_matches_jax(stages):
    (_, frs, _), (_, t_frs, _) = stages
    for f in ("center_coef", "shape_gens", "radius"):
        close(getattr(t_frs, f)[0], getattr(frs, f))


def test_torque_frs_matches_jax(stages):
    (_, _, tq), (_, _, t_tq) = stages
    close(t_tq.u_coef[0], tq.u_coef)
    close(t_tq.torque_radius[0], tq.torque_radius)


def test_batched_worlds_match_single():
    """Three worlds in one batch give what each gives alone."""
    robot = t_robot(J_ROBOT)
    names = sorted(STATES)
    args = [torch.as_tensor(np.stack([STATES[n][i] for n in names])) for i in range(3)]
    jrs = build_jrs(*args, robot, T_CFG, T_BASIS)
    frs = reduce_links(forward_occupancy(jrs, robot, T_CFG, T_BASIS), T_BASIS)
    tq = torque_frs(jrs, robot, T_CFG, T_BASIS)
    for w, n in enumerate(names):
        _, (_, f1, t1) = run_both(n)
        torch.testing.assert_close(frs.center_coef[w], f1.center_coef[0], rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(frs.radius[w], f1.radius[0], rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(tq.torque_radius[w], t1.torque_radius[0],
                                   rtol=1e-12, atol=1e-12)


def test_uncertain_com_branch_matches_jax():
    """With COM uncertainty the RNEA takes the PZ x PZ cross products with
    the COM PZ (the com_uncertain branch)."""
    jrobot = dataclasses.replace(J_ROBOT, com_uncertainty=0.05)
    cfg = JConfig(num_time_steps=4, dtype=jnp.float64)
    tcfg = convert.config_from_fields({f.name: getattr(cfg, f.name)
                                       for f in dataclasses.fields(cfg)})
    jstages = _stages_fn(jrobot, cfg)
    (_, _, tq), (_, _, t_tq) = run_both("moving", jstages, t_robot(jrobot), tcfg)
    close(t_tq.u_coef[0], tq.u_coef)
    close(t_tq.torque_radius[0], tq.torque_radius)


def test_stages_run_on_the_jax_jrs():
    """The JAX JRS carried into the port (convert.bpz_from_numpy): the
    port's FK and RNEA on it give the JAX LinkFRS and TorqueFRS."""
    q0, qd0, qdd0 = STATES["moving"]
    jrs, frs, tq = J_STAGES(jnp.asarray(q0), jnp.asarray(qd0), jnp.asarray(qdd0))

    def carry(p):
        return convert.bpz_from_numpy(np.array(p.coef)[None], np.array(p.egen)[None],
                                      np.array(p.rad)[None])

    traj = TrajectoryCoeffs(**{f: torch.as_tensor(np.array(getattr(jrs.traj, f)))[None]
                               for f in ("q0", "qd0", "qdd0", "Tqd0", "TTqdd0", "k_scale")})
    t_jrs = JRS(R=carry(jrs.R), Rt=carry(jrs.Rt), qd=carry(jrs.qd), qda=carry(jrs.qda),
                qdda=carry(jrs.qdda), traj=traj)
    robot = t_robot(J_ROBOT)
    t_frs = reduce_links(forward_occupancy(t_jrs, robot, T_CFG, T_BASIS), T_BASIS)
    for f in ("center_coef", "shape_gens", "radius"):
        close(getattr(t_frs, f)[0], getattr(frs, f))
    t_tq = torque_frs(t_jrs, robot, T_CFG, T_BASIS)
    close(t_tq.u_coef[0], tq.u_coef)
    close(t_tq.torque_radius[0], tq.torque_radius)


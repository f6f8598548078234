"""The port's binding of the native runtime (armour_tpu_torch/runtime/
native.py over native/armour_rt.cpp) against the port's float64 twins on
the CPU, as tests/test_native_runtime.py holds the JAX binding against the
JAX twins: the RNEA to 1e-12, with parameter overrides too; the robust
controller's u, tau and v to 1e-10; a 100-step closed-loop move (RK4 under
zero-order-hold control at 1 kHz) against rollout_plain, the final state to
1e-8 and every input to 1e-7."""

import numpy as np
import pytest
import torch

from armour_tpu_torch.config import ArmourConfig
from armour_tpu_torch.controller import robust_control
from armour_tpu_torch.models.kinova import kinova_gen3
from armour_tpu_torch.rnea_numeric import rnea
from armour_tpu_torch.runtime import native
from armour_tpu_torch.runtime.native import NativeRuntime
from armour_tpu_torch.simulator import TrueParams, rollout_plain
from armour_tpu_torch.trajectory import desired_state, initial_plan


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small: one torch thread each, so that the
    six workers of a full run do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(x):
    return torch.as_tensor(np.asarray(x, float))


@pytest.fixture(scope="module")
def setup():
    robot = kinova_gen3()
    cfg = ArmourConfig(dtype=torch.float64)
    return robot, cfg, NativeRuntime(robot, cfg)


def test_library_builds_into_the_ports_build_directory():
    lib = native.build_library()
    assert lib.parent == native.BUILD and lib.exists()
    assert lib.parent.name == "_build" and lib.parent.parent.name == "armour_tpu_torch"
    assert native.build_library() == lib     # reused while the source is unchanged


def test_native_rnea_matches_port(setup):
    robot, _, rt = setup
    rng = np.random.default_rng(3)
    for _ in range(5):
        q, qd, qa, qdd = (rng.uniform(-a, a, 7) for a in (2, 1, 1, 2))
        ref = rnea(robot, t(q), t(qd), t(qa), t(qdd)).numpy()
        np.testing.assert_allclose(rt.rnea(q, qd, qa, qdd), ref, rtol=1e-12, atol=1e-12)


def test_native_rnea_param_overrides(setup):
    robot, _, rt = setup
    rng = np.random.default_rng(4)
    q = rng.uniform(-1, 1, 7)
    qd = rng.uniform(-1, 1, 7)
    mass = robot.mass * (1 + 0.03 * rng.uniform(-1, 1, 7))
    inertia = robot.inertia * (1 + 0.03 * rng.uniform(-1, 1, 7))[:, None, None]
    ref = rnea(robot, t(q), t(qd), t(qd), torch.zeros(7, dtype=torch.float64), mass=t(mass),
               inertia=t(inertia), set_gravity=True, include_armature=False).numpy()
    got = rt.rnea(q, qd, qd, np.zeros(7), mass=mass, inertia=inertia, include_armature=False)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_native_robust_control_matches_port(setup):
    robot, cfg, rt = setup
    rng = np.random.default_rng(5)
    for _ in range(5):
        q = rng.uniform(-1.5, 1.5, 7)
        q_des = q + rng.uniform(-0.01, 0.01, 7)
        qd = rng.uniform(-0.5, 0.5, 7)
        qd_des = qd + rng.uniform(-0.02, 0.02, 7)
        qdd_des = rng.uniform(-1, 1, 7)
        u_ref, tau_ref, v_ref = robust_control(robot, cfg, t(q), t(qd), t(q_des), t(qd_des),
                                               t(qdd_des))
        u, tau, v = rt.control(q, qd, q_des, qd_des, qdd_des)
        np.testing.assert_allclose(tau, tau_ref.numpy(), atol=1e-10)
        np.testing.assert_allclose(v, v_ref.numpy(), atol=1e-10)
        np.testing.assert_allclose(u, u_ref.numpy(), atol=1e-10)


def test_native_rollout_matches_rollout_plain(setup):
    """A 100-step move from rest toward a held reference under perturbed
    true parameters."""
    robot, cfg, rt = setup
    rng = np.random.default_rng(6)
    q0 = rng.uniform(-0.5, 0.5, 7)
    qd0 = np.zeros(7)
    mass, inertia = robot.mass * 1.02, robot.inertia * 0.98
    dt, n = 1e-3, 100
    ref = initial_plan(t(q0)[None], torch.float64)
    q_des, qd_des, qdd_des = (x.contiguous() for x in
                              desired_state(ref, torch.arange(n, dtype=torch.float64) * dt, cfg))
    tp = TrueParams(mass=t(mass)[None], inertia=t(inertia)[None], com=t(robot.com)[None])
    q, qd, _, _, u_log = rollout_plain(robot, cfg, t(q0)[None], t(qd0)[None], q_des, qd_des,
                                       qdd_des, tp, dt)
    q_log, qd_log, u_nat = rt.rollout(q0, qd0, q_des[0], qd_des[0], qdd_des[0], mass, inertia,
                                      dt=dt)
    np.testing.assert_allclose(q_log[-1], q[0].numpy(), atol=1e-8)
    np.testing.assert_allclose(qd_log[-1], qd[0].numpy(), atol=1e-8)
    np.testing.assert_allclose(u_nat, u_log[0].numpy(), atol=1e-7)


def test_native_runtime_refuses_arrays_of_the_wrong_shape(setup):
    """The C side reads a fixed count of values from each pointer: a wrong
    shape raises before the call."""
    robot, _, rt = setup
    with pytest.raises(ValueError, match="shape"):
        rt.rnea(np.zeros(6), np.zeros(7), np.zeros(7), np.zeros(7))
    with pytest.raises(ValueError, match="shape"):
        rt.rollout(np.zeros(7), np.zeros(7), np.zeros((10, 7)), np.zeros((9, 7)),
                   np.zeros((10, 7)), robot.mass, robot.inertia)

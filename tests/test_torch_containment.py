"""Monte-Carlo containment of numeric ground truth in the port's reachable
sets, float64 on the CPU at T = 16 (the port's counterparts of the
containment tests in test_pipeline_reachsets.py): the true trajectory's
velocity, acceleration and joint rotations inside the JRS, the numeric link
centres inside the link FRS hull and inside its centre set alone, the
numeric passivity RNEA torque inside the nominal band, torques under
perturbed mass / inertia inside the interval band, and, with an uncertain
centre of mass, torques under perturbed COMs too.  On the CPU every set
comes from the plain versions of K9 / K10."""

import dataclasses

import numpy as np
import pytest
import torch

from armour_tpu_torch import bezier, dynamics, kinematics, rnea_numeric
from armour_tpu_torch.config import ArmourConfig
from armour_tpu_torch.jrs import build_jrs
from armour_tpu_torch.models.kinova import kinova_gen3
from armour_tpu_torch.pz.basis import make_basis

ROBOT = kinova_gen3()
CFG = ArmourConfig(num_time_steps=16, dtype=torch.float64)
BASIS = make_basis(7, 3)

Q0 = np.array([0.6543, -0.0876, -0.4837, -1.2278, -1.5735, -1.0720, 0.0])
QD0 = np.array([0.1, -0.2, 0.15, 0.3, -0.1, 0.05, 0.2])
QDD0 = np.array([0.3, 0.1, -0.2, 0.1, 0.2, -0.1, 0.0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small: one torch thread each, so that the
    six workers of a full run do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


@pytest.fixture(scope="module")
def jrs():
    return build_jrs(_t(Q0)[None], _t(QD0)[None], _t(QDD0)[None], ROBOT, CFG, BASIS)


def _samples(seed, n):
    """n random (sub-interval, s inside it, k): t_ind [n], q, qd, qdd [n, F],
    phi(k) [n, B]."""
    rng = np.random.default_rng(seed)
    T = CFG.num_time_steps
    t_ind = rng.integers(0, T, n)
    s = _t((t_ind + rng.uniform(0.0, 1.0, n)) / T)[:, None]
    k = _t(rng.uniform(-1, 1, (n, 7)))
    k_act = k * _t(CFG.k_range)
    dur = CFG.duration
    q0, Tqd0, TTqdd0 = _t(Q0), _t(QD0) * dur, _t(QDD0) * dur ** 2
    q = bezier.q_des(q0, Tqd0, TTqdd0, k_act, s)
    qd = bezier.qd_des(q0, Tqd0, TTqdd0, k_act, s) / dur
    qdd = bezier.qdd_des(q0, Tqd0, TTqdd0, k_act, s) / dur ** 2
    return torch.as_tensor(t_ind), q, qd, qdd, BASIS.phi(k)


def _slice(p, t_ind, phi):
    """(centre, radius) of the BPZ p [1, T, ...] at sub-interval t_ind [n]
    sliced at phi [n, B]: centre = coef . phi, radius = sum |egen| + rad."""
    coef, egen, rad = p.coef[0, t_ind], p.egen[0, t_ind], p.rad[0, t_ind]
    extra = coef.dim() - 2
    c = (coef * phi.reshape(phi.shape[0], *([1] * extra), -1)).sum(-1)
    return c, egen.abs().sum(-1) + rad


def _assert_inside(truth, c, r, slack):
    excess = (truth - c).abs() - r
    assert float(excess.max()) <= slack, float(excess.max())


def test_jrs_velocity_acceleration_containment(jrs):
    t_ind, q, qd, qdd, phi = _samples(1, 100)
    for pz, truth in ((jrs.qd, qd), (jrs.qdda, qdd)):
        _assert_inside(truth, *_slice(pz, t_ind, phi), 1e-12)


def test_jrs_rotation_containment(jrs):
    t_ind, q, _, _, phi = _samples(2, 50)
    R_true = rnea_numeric.joint_rotations(ROBOT, q)                 # [n, J, 3, 3]
    J = ROBOT.num_joints
    c, r = _slice(jrs.R, t_ind, phi)                                # [n, J+1, 3, 3]
    _assert_inside(R_true, c[:, :J], r[:, :J], 1e-12)


def test_fk_numeric_containment(jrs):
    """True link centres along the trajectory lie inside the link FRS hull."""
    frs = kinematics.reduce_links(
        kinematics.forward_occupancy(jrs, ROBOT, CFG, BASIS), BASIS)
    t_ind, q, _, _, phi = _samples(3, 100)
    _, _, centers = rnea_numeric.forward_kinematics(ROBOT, q)      # [n, J, 3]
    c = (frs.center_coef[0, t_ind] * phi[:, None, None]).sum(-1)
    hull = frs.shape_gens[0, t_ind].abs().sum(-1) + frs.radius[0, t_ind]
    _assert_inside(centers, c, hull, 1e-12)


def test_fk_link_centre_in_the_centre_set(jrs):
    """The link box's own centre takes the shape generators at 0: the true
    centre lies in the sliced centre set alone (k-polynomial + radius), a
    far tighter test than the hull (the box extent dominates it)."""
    frs = kinematics.reduce_links(
        kinematics.forward_occupancy(jrs, ROBOT, CFG, BASIS), BASIS)
    t_ind, q, _, _, phi = _samples(7, 200)
    _, _, centers = rnea_numeric.forward_kinematics(ROBOT, q)
    c = (frs.center_coef[0, t_ind] * phi[:, None, None]).sum(-1)
    _assert_inside(centers, c, frs.radius[0, t_ind], 1e-12)


def test_rnea_numeric_containment(jrs):
    """Numeric passivity RNEA torque along the trajectory lies inside the
    sliced nominal torque band."""
    u_nom = dynamics.rnea_pz(jrs, ROBOT, CFG, BASIS, uncertain=False)
    t_ind, q, qd, qdd, phi = _samples(4, 60)
    tau = rnea_numeric.rnea(ROBOT, q, qd, qd, qdd)
    _assert_inside(tau, *_slice(u_nom, t_ind, phi), 1e-10)


def test_rnea_interval_contains_perturbed_params(jrs):
    """The interval RNEA covers torques under the robot's mass and inertia
    uncertainty (one factor per link each)."""
    u_int = dynamics.rnea_pz(jrs, ROBOT, CFG, BASIS, uncertain=True)
    t_ind, q, qd, qdd, phi = _samples(5, 30)
    rng = np.random.default_rng(5)
    n = q.shape[0]
    dm = 1.0 + _t(rng.uniform(-1, 1, (n, 7))) * ROBOT.mass_uncertainty
    dI = 1.0 + _t(rng.uniform(-1, 1, (n, 7, 1, 1))) * ROBOT.inertia_uncertainty
    tau = rnea_numeric.rnea(ROBOT, q, qd, qd, qdd, mass=_t(ROBOT.mass) * dm,
                            inertia=_t(ROBOT.inertia) * dI)
    _assert_inside(tau, *_slice(u_int, t_ind, phi), 1e-10)


def test_rnea_interval_contains_com_uncertainty(jrs):
    """With com_uncertainty on, the interval RNEA (the op-level route, not
    K10) also covers torques under perturbed centres of mass (the whole COM
    vector scaled by one factor per link)."""
    robot_c = dataclasses.replace(ROBOT, com_uncertainty=0.05)
    u_int = dynamics.rnea_pz(jrs, robot_c, CFG, BASIS, uncertain=True)
    t_ind, q, qd, qdd, phi = _samples(9, 20)
    rng = np.random.default_rng(9)
    n = q.shape[0]
    dm = 1.0 + _t(rng.uniform(-1, 1, (n, 7))) * robot_c.mass_uncertainty
    dI = 1.0 + _t(rng.uniform(-1, 1, (n, 7, 1, 1))) * robot_c.inertia_uncertainty
    dc = 1.0 + _t(rng.uniform(-1, 1, (n, 7, 1))) * robot_c.com_uncertainty
    tau = rnea_numeric.rnea(ROBOT, q, qd, qd, qdd, mass=_t(ROBOT.mass) * dm,
                            inertia=_t(ROBOT.inertia) * dI, com=_t(ROBOT.com) * dc)
    _assert_inside(tau, *_slice(u_int, t_ind, phi), 1e-10)


def test_nominal_set_of_the_pair_is_the_single_nominal_set(jrs):
    """The two parameter sets share the kinematics: the nominal set of
    (nom, int), which the planner and K10 compute, equals rnea_pz's
    single nominal set."""
    both = dynamics.rnea_pz_sets(jrs, ROBOT, CFG, BASIS)
    one = dynamics.rnea_pz(jrs, ROBOT, CFG, BASIS, uncertain=False)
    for f in ("coef", "egen", "rad"):
        assert torch.equal(getattr(both, f)[:, 0], getattr(one, f))

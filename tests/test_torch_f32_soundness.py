"""float32 soundness of the port's reach sets (the port's counterpart of
tests/test_f32_soundness.py): the port's plain bands in float32 on the CPU,
in-process, at the default float_slop (JRS qd and qdda, the nominal PZ RNEA
torque u, the link FRS's sliced centre and hull) must contain the float64
truth of the JAX package's numeric Bezier trajectory, RNEA and forward
kinematics at the same 32 samples (T = 16) as the JAX test.  Interval
arithmetic without directed rounding is sound only with the outward slop
budget; the kernels K9 / K10 repeat the plain versions' slop term by term
(chip_smoke.py phases 3 and 9 hold them there on the card)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armour_tpu import bezier, rnea_numeric
from armour_tpu.config import ArmourConfig as JConfig
from armour_tpu.models.kinova import kinova_gen3 as j_kinova
from armour_tpu_torch import dynamics, kinematics
from armour_tpu_torch.config import ArmourConfig
from armour_tpu_torch.jrs import build_jrs
from armour_tpu_torch.models.kinova import kinova_gen3
from armour_tpu_torch.pz.basis import make_basis

N_T, N_SAMPLES = 16, 32
Q0 = np.array([0.6543, -0.0876, -0.4837, -1.2278, -1.5735, -1.0720, 0.0])
QD0 = np.array([0.1, -0.2, 0.15, 0.3, -0.1, 0.05, 0.2])
QDD0 = np.array([0.3, 0.1, -0.2, 0.1, 0.2, -0.1, 0.0])
BANDS = ("qd", "qdda", "u", "fk")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small: one torch thread each, so that the
    six workers of a full run do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f32(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)[None]


@pytest.fixture(scope="module")
def bands():
    """(t_inds, ks, {name_c, name_r}) as scripts/f32_bands_worker.py writes
    them, from the port's float32 plain versions."""
    rng = np.random.default_rng(7)
    t_inds = rng.integers(0, N_T, N_SAMPLES)
    ks = rng.uniform(-1, 1, (N_SAMPLES, 7))
    robot, cfg = kinova_gen3(), ArmourConfig(num_time_steps=N_T, dtype=torch.float32)
    assert cfg.float_slop > 0.0
    basis = make_basis(robot.num_factors, cfg.max_poly_degree)
    jrs = build_jrs(_f32(Q0), _f32(QD0), _f32(QDD0), robot, cfg, basis)
    links = kinematics.forward_occupancy(jrs, robot, cfg, basis)
    frs = kinematics.reduce_links(links, basis)
    u_nom = dynamics.rnea_pz(jrs, robot, cfg, basis, uncertain=False)
    phis = basis.phi(torch.as_tensor(ks, dtype=torch.float32))        # [S, B]
    t = torch.as_tensor(t_inds)
    out = {}
    for name, p in (("qd", jrs.qd), ("qdda", jrs.qdda), ("u", u_nom)):
        coef, egen, rad = p.coef[0, t], p.egen[0, t], p.rad[0, t]     # [S, F, B]
        out[f"{name}_c"] = torch.einsum("sfb,sb->sf", coef, phis).numpy()
        out[f"{name}_r"] = (egen.abs().sum(-1) + rad).numpy()
    out["fk_c"] = torch.einsum("sjab,sb->sja", frs.center_coef[0, t], phis).numpy()
    out["fk_r"] = (frs.shape_gens[0, t].abs().sum(-1) + frs.radius[0, t]).numpy()
    return t_inds, ks, out


def _truth(t_ind, k, rng):
    cfg = JConfig(num_time_steps=N_T, dtype=jnp.float64)
    ds = 1.0 / N_T
    s = rng.uniform(t_ind * ds, (t_ind + 1) * ds)
    k_act = k * np.asarray(cfg.k_range)
    Tqd0, TTqdd0 = QD0 * cfg.duration, QDD0 * cfg.duration ** 2
    q = np.asarray(bezier.q_des(Q0, Tqd0, TTqdd0, k_act, s))
    qd = np.asarray(bezier.qd_des(Q0, Tqd0, TTqdd0, k_act, s)) / cfg.duration
    qdd = np.asarray(bezier.qdd_des(Q0, Tqd0, TTqdd0, k_act, s)) / cfg.duration ** 2
    return q, qd, qdd


@pytest.fixture(scope="module")
def excess(bands):
    """The worst (|truth - centre| - radius) per band over the samples."""
    t_inds, ks, b = bands
    robot = j_kinova()
    rng = np.random.default_rng(8)
    worst = {name: -np.inf for name in BANDS}
    for i, (t_ind, k) in enumerate(zip(t_inds, ks)):
        q, qd, qdd = _truth(int(t_ind), k, rng)
        tau = np.asarray(rnea_numeric.rnea(robot, jnp.asarray(q), jnp.asarray(qd),
                                           jnp.asarray(qd), jnp.asarray(qdd)))
        _, _, centers = rnea_numeric.forward_kinematics(robot, jnp.asarray(q))
        for name, truth in (("qd", qd), ("qdda", qdd), ("u", tau), ("fk", np.asarray(centers))):
            v = np.max(np.abs(truth - b[f"{name}_c"][i]) - b[f"{name}_r"][i])
            worst[name] = max(worst[name], float(v))
    return worst


def test_bands_are_float32_and_finite(bands):
    _, _, b = bands
    for name in BANDS:
        for part in ("c", "r"):
            a = b[f"{name}_{part}"]
            assert a.dtype == np.float32 and np.isfinite(a).all(), (name, part)
        assert (b[f"{name}_r"] >= 0).all(), name


@pytest.mark.parametrize("name", BANDS)
def test_f32_band_contains_f64_truth(excess, name):
    assert excess[name] <= 0.0, (f"the port's float32 {name} band must contain the float64 "
                                 f"truth at the default slop: {excess}")

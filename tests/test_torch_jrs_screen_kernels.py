"""Kernels K12 (jrs_bernstein, csrc/jrs_bernstein.cu) and K13
(screen_collision, csrc/screen_collision.cu), and the port's scalar
divisions; the writer K11 (jrs_armtd) shares with K12.

On the CPU: the launchers' pure-Python parts (K12's constants, each a Python
double rounded once to float32 as the plain version rounds it; the
refusals; K13's launch geometry and shared memory against the source's
constants), the screen's selection order against a lexicographic sort, and
utils.div.  The cuda-marked tests hold K12 and K13 against their plain
versions on the card (K12: the velocity PZs and trajectory scalars bit for
bit, R within 1e-6 (1 + |plain|) where cos / sin or the 3x3 products round
differently; K12 and K11 also at the flagship size, at J = 9 and at F = 6;
K13: the same indices and bits in every field, with quota 0
and 8 and planted ties, against the plain screen of K3's hyperplanes and
against tests/data/screen_hyperplanes.cu, the screen that reads K3's
tensors, built there with the port's flags), each twice for the same
bits, and every repaired division on the card against the CPU bit for
bit.  They skip where there is no card; this file imports no JAX, so on
the card it runs with
`python3 -m pytest --noconftest tests/test_torch_jrs_screen_kernels.py -m cuda`."""

import ctypes
import re

import numpy as np
import pytest
import torch

from armour_tpu_torch import collision as col
from armour_tpu_torch.config import ArmourConfig
from armour_tpu_torch.jrs import QDD_K_DEP_MAXIMA, QDD_K_DEP_MINIMA
from armour_tpu_torch.kernels import build, collision as kcol, jrs as kjrs
from armour_tpu_torch.models.kinova import kinova_gen3
from armour_tpu_torch.pz.basis import make_basis
from armour_tpu_torch.utils import div

f32 = np.float32
BLOCK_SMEM = 232448          # an H100 block's shared memory with the opt-in, bytes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small: one torch thread each, so that the
    six workers of a full run do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _define(name, src):
    return int(re.search(r"#define %s (\d+)" % name, (build.CSRC / src).read_text()).group(1))


def test_k12_template_rounds_each_constant_once():
    """1 / T, duration, duration * duration, the acceleration's extrema,
    k_range and the ultimate bound's radii are the plain version's Python
    doubles, each rounded once to float32 (duration^2 is not the square of
    the rounded duration); the template is kept in basis.kernel_args."""
    robot, basis = kinova_gen3(), make_basis(7, 3)
    cfg = ArmourConfig(num_time_steps=14, duration=0.7, t_plan=0.35)
    a = kjrs._template_k12(robot, cfg, basis)
    assert a is kjrs._template_k12(robot, cfg, basis)
    assert f32(a.ds) == f32(1.0 / 14) and f32(a.dur) == f32(0.7)
    assert f32(a.dur2) == f32(0.7 * 0.7) and f32(a.dur2) != f32(0.7) * f32(0.7)
    assert f32(a.acc_max) == f32(QDD_K_DEP_MAXIMA) and f32(a.acc_min) == f32(QDD_K_DEP_MINIMA)
    assert all(f32(a.k_range[f]) == f32(cfg.k_range[f]) for f in range(7))
    ub = cfg.ub
    assert [f32(x) for x in (a.qe, a.qde, a.qdae, a.qddae)] == [
        f32(x) for x in (ub.qe, ub.qde, ub.qdae, ub.qddae)]
    assert (a.J, a.F, a.B, a.E) == (7, 7, basis.size, 38)
    assert [a.lin[f] for f in range(7)] == [int(x) for x in basis.lin_idx[:7]]


def test_k12_refuses_what_it_does_not_take():
    """CPU tensors, and robots or configs beyond the kernel's tables."""
    robot, basis = kinova_gen3(), make_basis(7, 3)
    cfg = ArmourConfig(num_time_steps=4)
    z = torch.zeros(2, 7)
    with pytest.raises(ValueError, match="CUDA"):
        kjrs.jrs_bernstein(z, z, z, robot, cfg, basis)
    with pytest.raises(ValueError, match="k_range"):
        kjrs._template_k12(robot, ArmourConfig(num_time_steps=4, k_range=(0.1,) * 6), basis)
    with pytest.raises(ValueError, match="basis factors"):
        kjrs._template_k12(robot, cfg, make_basis(6, 3))


@pytest.mark.parametrize("K", [1, 7, 100, 4096, 8192, 8193, 40000])
def test_k13_geometry_covers_and_fits(K):
    """The bound pass covers every row, the sort length is the least power
    of two >= K, the sort sits in shared memory up to K13_SMEM_SORT_MAX and
    fits a block with the select pass's static shared memory, else it goes
    to the global scratch; the gather covers every (world, chosen row)."""
    Wn, N = 3, 35840
    geo = kcol.k13_geometry(Wn, N, K)
    assert geo.bound_grid == (-(-N // kcol.K13_BOUND_THREADS), Wn)
    assert (geo.bound_grid[0] - 1) * kcol.K13_BOUND_THREADS < N
    assert geo.Kp >= K and geo.Kp & (geo.Kp - 1) == 0 and (geo.Kp == 1 or geo.Kp // 2 < K)
    static = 4 * (256 + kcol.K13_SELECT_THREADS // 32 + 4)      # K13Shared
    if geo.Kp * 8 <= kcol.K13_SMEM_SORT_MAX:
        assert geo.smem_bytes == geo.Kp * 8 and geo.smem_bytes + static <= BLOCK_SMEM
    else:
        assert geo.smem_bytes == 0
    assert geo.gather_blocks * kcol.K13_GATHER_THREADS >= Wn * K
    assert (geo.gather_blocks - 1) * kcol.K13_GATHER_THREADS < Wn * K


def test_k13_constants_match_the_source():
    assert kcol.K13_BOUND_THREADS == _define("K13_BOUND_THREADS", "screen_collision.cu")
    assert kcol.K13_SELECT_THREADS == _define("K13_SELECT_THREADS", "screen_collision.cu")
    assert kcol.K13_GATHER_THREADS == _define("K13_GATHER_THREADS", "screen_collision.cu")
    assert "#define K13_BIG 1e8f" in (build.CSRC / "screen_collision.cu").read_text()
    assert col.BIG == 1e8


def test_k13_refuses_what_it_does_not_take():
    """CPU tensors, and obstacles of another count than the mask's (before
    any launch)."""
    Wn, T, J, O, B = 1, 2, 7, 4, 120
    args = [torch.zeros(Wn, T, J, 3, 3), torch.zeros(Wn, T, J, 3), torch.zeros(Wn, O, 3),
            torch.zeros(Wn, O, 3, 3), torch.zeros(Wn, T, J, 3, B), torch.zeros(Wn, T, J, 3),
            torch.ones(Wn, O, dtype=torch.bool)]
    with pytest.raises(ValueError, match="CUDA"):
        kcol.screen_collision(*args, 16)
    args[6] = torch.ones(Wn, O + 1, dtype=torch.bool)
    with pytest.raises(ValueError, match="the mask's 5 obstacles"):
        kcol.screen_collision(*args, 16)


def _lex_top(x, k):
    """Reference order: value descending, the lower index first."""
    return np.lexsort((np.arange(x.size), -x))[:k]


@pytest.mark.parametrize("quota", [0, 2])
def test_screen_rows_take_the_lower_index_among_ties(quota):
    """collision.screen_rows on values with many ties (and -0.0 beside
    +0.0, which rank as equal) against a lexicographic sort, per obstacle
    for the quota and globally for the rest."""
    rng = np.random.default_rng(3)
    Wn, TJ, O, K = 2, 24, 5, 40
    g = rng.integers(-3, 3, (Wn, TJ * O)).astype(np.float64) * 0.5
    g[g == 0] = np.where(rng.random(int((g == 0).sum())) < 0.5, -0.0, 0.0)
    idx = col.screen_rows(torch.as_tensor(g), O, K, quota).numpy()
    for w in range(Wn):
        x = g[w].copy() + 0.0
        want = []
        if quota:
            for o in range(O):
                want += [int(t) * O + o for t in _lex_top(x[o::O], quota)]
            x[want] = -np.inf
        want += [int(n) for n in _lex_top(x, K - len(want))]
        assert idx[w].tolist() == want


def test_div_divides_by_a_tensor_formed_once():
    x = torch.linspace(-3, 3, 11, dtype=torch.float32)
    assert torch.equal(div(x, 3.0), x / 3.0)
    assert torch.equal(div(x.double(), 0.7), x.double() / 0.7)
    div(x, 5.0)
    from armour_tpu_torch import utils

    assert (5.0, torch.float32, x.device) in utils._DIVISORS


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels are built with nvcc there)")
    return torch.device("cuda")


def _odd_config(T):
    """A config at T sub-intervals: ArmourConfig asks for an even T (the
    ARMTD family's phase boundary lies on the grid); the Bernstein JRS
    takes any T >= 1."""
    cfg = ArmourConfig(num_time_steps=T + T % 2, dtype=torch.float32)
    object.__setattr__(cfg, "num_time_steps", T)
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("start, T", [("rest", 16), ("moving", 16), ("moving", 7)])
def test_k12_matches_its_plain_version_on_the_card(start, T):
    """K12 against build_jrs_plain on the card: the velocity PZs and the
    trajectory scalars bit for bit, R and Rt within 1e-6 (1 + |plain|); a
    repeat gives the same bits."""
    from armour_tpu_torch import jrs, kernels

    dev = _card()
    robot, basis = kinova_gen3(), make_basis(7, 3)
    cfg = _odd_config(T)
    rng = np.random.default_rng(T)
    W = 5

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    q0 = t(rng.uniform(-2.5, 2.5, (W, 7)))
    if start == "rest":
        qd0, qdd0 = t(np.zeros((W, 7))), t(np.zeros((W, 7)))
    else:
        qd0, qdd0 = t(rng.uniform(-1.5, 1.5, (W, 7))), t(rng.uniform(-4, 4, (W, 7)))
    kernels.reset_counts()
    got = jrs.build_jrs(q0, qd0, qdd0, robot, cfg, basis)
    again = jrs.build_jrs(q0, qd0, qdd0, robot, cfg, basis)
    assert kernels.counts()["jrs_bernstein"] == 2
    ref = jrs.build_jrs_plain(q0, qd0, qdd0, robot, cfg, basis)
    for f in ("R", "Rt", "qd", "qda", "qdda"):
        for g in ("coef", "egen", "rad"):
            a, b = getattr(getattr(got, f), g), getattr(getattr(ref, f), g)
            assert a.shape == b.shape and torch.equal(a, getattr(getattr(again, f), g))
            if f in ("R", "Rt"):
                assert bool(((a - b).abs() <= 1e-6 * (1 + b.abs())).all()), (f, g)
            else:
                assert torch.equal(a, b), (f, g)
    for n in ("q0", "qd0", "qdd0", "Tqd0", "TTqdd0", "k_scale"):
        assert torch.equal(getattr(got.traj, n), getattr(ref.traj, n)), n


def _jrs_robot(which):
    """(robot, cfg, basis, W) of a path's JRS widths: the flagship (the
    Kinova, T = 128, W = 64), the dumbbell (J = 9 bodies, F = 7) and the
    UR5 (F = 6), these two at W = 8, T = 32."""
    from armour_tpu_torch.models import zoo

    if which == "flagship":
        return kinova_gen3(), ArmourConfig(dtype=torch.float32), make_basis(7, 3), 64
    robot = zoo.kinova_dumbbell() if which == "J9" else zoo.ur5()
    F = robot.num_factors
    cfg = ArmourConfig.for_robot(robot, derive_ub=False, num_time_steps=32, dtype=torch.float32)
    return robot, cfg, make_basis(F, 3), 8


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["bernstein", "armtd"])
@pytest.mark.parametrize("which", ["flagship", "J9", "F6"])
def test_jrs_writer_gives_the_plain_versions_entries_on_the_card(family, which):
    """K12 (Bernstein) and K11 (ARMTD), both on the flat 16-byte writer, at
    the flagship size, at J = 9 and at F = 6 from moving starts: the
    velocity PZs and the trajectory scalars the plain version's bits, R
    within 1e-6 (1 + |plain|) (its cos / sin and 3x3 products may round
    differently) and exactly zero wherever the plain R is; the same bits
    on a repeat, one launch a call."""
    import dataclasses

    from armour_tpu_torch import armtd, jrs, kernels

    dev = _card()
    robot, cfg, basis, W = _jrs_robot(which)
    cfg = dataclasses.replace(cfg, traj_family=family)
    F = robot.num_factors
    rng = np.random.default_rng(F + W)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    q0, qd0, qdd0 = (t(rng.uniform(-lim, lim, (W, F))) for lim in (2.5, 0.6, 2.0))
    if family == "armtd":
        def kern():
            return armtd.build_jrs_armtd(q0, qd0, robot, cfg, basis)
        ref = armtd.build_jrs_armtd_plain(q0, qd0, robot, cfg, basis)
        name = "jrs_armtd"
    else:
        def kern():
            return jrs.build_jrs(q0, qd0, qdd0, robot, cfg, basis)
        ref = jrs.build_jrs_plain(q0, qd0, qdd0, robot, cfg, basis)
        name = "jrs_bernstein"
    kernels.reset_counts()
    got, again = kern(), kern()
    assert kernels.counts()[name] == 2
    for f in ("R", "qd", "qda", "qdda"):
        for g in ("coef", "egen", "rad"):
            a, b = getattr(getattr(got, f), g), getattr(getattr(ref, f), g)
            assert a.shape == b.shape and torch.equal(a, getattr(getattr(again, f), g)), (f, g)
            if f == "R":
                assert bool(((a - b).abs() <= 1e-6 * (1 + b.abs())).all()), (f, g)
                assert bool((a[b == 0] == 0).all()), (f, g)
            else:
                assert torch.equal(a, b), (f, g)
    for n in ("Tqd0", "TTqdd0", "k_scale"):
        assert torch.equal(getattr(got.traj, n), getattr(ref.traj, n)), n


def _screen_inputs(dev, dup):
    """Hyperplanes, obstacles and link sets of a T = 16 plan of three saved
    worlds on the card (K12, K9, K10, K15, K3); dup: every other real
    obstacle is a copy of the one before it, so that real rows tie."""
    import glob

    from armour_tpu_torch.collision import build_hyperplanes, pad_obstacles, stack_obstacles
    from armour_tpu_torch.dynamics import reach_assembly, rnea_pz_sets
    from armour_tpu_torch.jrs import build_jrs
    from armour_tpu_torch.kinematics import forward_occupancy
    from armour_tpu_torch.worlds import load_world_csv

    robot, basis = kinova_gen3(), make_basis(7, 3)
    cfg = ArmourConfig(dtype=torch.float32, num_time_steps=16, max_obstacles=24)
    ws = [load_world_csv(p) for p in sorted(glob.glob("saved_worlds/random/*.csv"))[:3]]
    sets = []
    for w in ws:
        c, g = np.array(w.obstacle_centers), np.array(w.obstacle_generators)
        if dup:
            c[1::2], g[1::2] = c[0::2][:len(c[1::2])], g[0::2][:len(g[1::2])]
        sets.append(pad_obstacles(c, g, cfg.max_obstacles, cfg.dtype))
    obs = stack_obstacles(sets)
    obs = type(obs)(centers=obs.centers.to(dev), generators=obs.generators.to(dev),
                    mask=obs.mask.to(dev))
    q0 = torch.as_tensor(np.stack([w.start for w in ws]), dtype=torch.float32, device=dev)
    z = torch.zeros_like(q0)
    jrs = build_jrs(q0, z, z, robot, cfg, basis)
    frs, _ = reach_assembly(forward_occupancy(jrs, robot, cfg, basis),
                            rnea_pz_sets(jrs, robot, cfg, basis), robot, cfg, basis)
    return build_hyperplanes(frs, obs), obs, frs


@pytest.mark.cuda
@pytest.mark.parametrize("quota, dup", [(0, False), (8, False), (0, True), (8, True)])
def test_k13_matches_its_plain_version_on_the_card(quota, dup):
    """K13 against screen_collision_plain on the card: the same rows in the
    same order and the same bits in every field (K = 512 of 2,688 rows;
    K = 3,000 takes padded rows tied at -BIG too); a repeat gives the same
    bits."""
    from armour_tpu_torch import kernels

    dev = _card()
    hyp, obs, frs = _screen_inputs(dev, dup)
    g_up, _ = col._screen_bound(hyp, obs, frs)
    assert int(g_up.numel() - torch.unique(g_up).numel()) > 0      # ties present
    for K in (512, 3000):
        kernels.reset_counts()
        got = col.screen_collision(hyp, obs, frs, K, quota)
        again = col.screen_collision(hyp, obs, frs, K, quota)
        assert kernels.counts()["screen_collision"] == 2
        ref = col.screen_collision_plain(hyp, obs, frs, K, quota)
        for f in ("A", "d", "delta", "row", "mask"):
            a, b = getattr(got, f), getattr(ref, f)
            assert a.dtype == b.dtype and torch.equal(a, getattr(again, f)), (K, f)
            assert torch.equal(a, b), (K, f)


@pytest.mark.cuda
def test_scalar_divisions_are_ieee_on_the_card():
    """Every repaired division by a Python number gives on the card the
    CPU's bits: g_k_adaptive, the Bezier closed forms (the beta's / 5 and /
    20, the k-independent parts' / duration), the velocity extrema's /
    duration and both families' desired states, at duration 0.7 (where
    dividing and multiplying by the float32 reciprocal differ).  Inputs are
    seeded float32; the Bezier forms are taken at s in {0, 1/2, 1} and the
    velocity extrema at a rest start and k_act = k in {+-1/4, +-1/2}, where
    their powers and square roots are exact on both devices (the CPU's
    vectorised pow and sqrt are not correctly rounded), so that the
    divisions decide the bits."""
    import dataclasses

    from armour_tpu_torch import bezier, nlp, trajectory
    from armour_tpu_torch.armtd import g_k_adaptive
    from armour_tpu_torch.jrs import TrajectoryCoeffs

    dev = _card()
    rng = np.random.default_rng(11)
    cfg = ArmourConfig(duration=0.7, t_plan=0.35, dtype=torch.float32)

    def both(fn, *xs):
        cpu = fn(*(torch.as_tensor(x, dtype=torch.float32) for x in xs))
        card = fn(*(torch.as_tensor(x, dtype=torch.float32, device=dev) for x in xs))
        cpu, card = (cpu, card) if isinstance(cpu, tuple) else ((cpu,), (card,))
        for a, b in zip(cpu, card):
            assert torch.equal(a, b.cpu()), fn

    n = 4096
    x = [rng.uniform(-3, 3, n) for _ in range(4)]
    s = rng.choice([0.0, 0.5, 1.0], n)
    both(g_k_adaptive, x[0])
    for fn in (bezier.q_des, bezier.qd_des, bezier.qdd_des):
        both(fn, *x, s)
    sr = rng.uniform(0, 1, n)
    for fn in (bezier.qd_des_k_indep, bezier.qdd_des_k_indep):
        both(lambda q0, T, TT, s_, fn=fn: fn(q0, T, TT, s_, duration=0.7), x[0], x[1], x[2], sr)

    def vel_extrema(q0, k):
        z = torch.zeros_like(q0)
        traj = TrajectoryCoeffs(q0=q0, qd0=z, qdd0=z, Tqd0=z, TTqdd0=z,
                                k_scale=torch.ones_like(q0))
        return nlp.joint_velocity_extrema(k[:, None], traj, cfg)

    both(vel_extrema, rng.uniform(-3, 3, (64, 7)),
         rng.choice([-0.5, -0.25, 0.25, 0.5], (64, 7)))

    for fam in ("bernstein", "armtd"):
        cfg_f = dataclasses.replace(cfg, traj_family=fam)
        W = 64
        q0, qd0, qdd0 = (rng.uniform(-1, 1, (W, 7)) for _ in range(3))
        k_new = rng.uniform(-1, 1, (W, 7))
        # s = t / duration and (t + t_plan) / duration in {0, 1/2, 1}
        tt = np.array([0.0, 0.35, 0.7, 0.9], dtype=np.float32)

        def state(q0_, qd0_, qdd0_, k_, t_, cfg_f=cfg_f):
            ref = trajectory.initial_plan(q0_[0], device=q0_.device)
            ref = trajectory.advance_plan(ref, k_, q0_, qd0_, qdd0_, cfg_f)
            ref = trajectory.advance_plan(ref, k_, q0_, qd0_, qdd0_, cfg_f)
            return trajectory.desired_state(ref, t_, cfg_f)

        both(state, q0, qd0, qdd0, k_new, tt)


class _ReferenceK13Args(ctypes.Structure):
    """The argument struct of tests/data/screen_hyperplanes.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "A", "d", "delta", "center", "env", "obs_mask", "g", "idx", "sort", "A_out", "d_out",
        "delta_out", "row", "mask")] + [(n, ctypes.c_int) for n in (
            "W", "C", "N", "TJ", "O", "B", "K", "quota", "Kp", "smem_sort")]


def _reference_screen(hyp, obs, frs, K, quota):
    """tests/data/screen_hyperplanes.cu (the screen that reads K3's tensors),
    built with the port's nvcc flags into a library named by a hash of the
    source and the flags, on hyp: (A, d, delta, row, mask)."""
    import hashlib
    import os
    import subprocess
    from pathlib import Path

    src = Path(__file__).resolve().parent / "data" / "screen_hyperplanes.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(build.FLAGS).encode()).hexdigest()[:16]
    out = build.BUILD / f"libscreen_hyperplanes_reference-{key}.so"
    if not out.exists():
        build.BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        subprocess.run([build.nvcc(), *build.FLAGS, "-o", str(tmp), str(src)], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    fn = ctypes.CDLL(str(out)).k13_launch
    fn.argtypes = [ctypes.POINTER(_ReferenceK13Args), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    A, d, delta = hyp.A, hyp.d, hyp.delta
    Wn, _, C, N = A.shape
    T, J, _, B = frs.center_coef.shape[1:]
    O = obs.mask.shape[1]
    Kk = min(K, N)
    q = quota if quota > 0 and quota * O < Kk else 0
    geo = kcol.k13_geometry(Wn, N, Kk)
    dev = A.device
    env = col.screen_envelope(frs.center_coef)
    g = torch.empty(Wn, N, device=dev)
    idx = torch.empty(Wn, Kk, device=dev, dtype=torch.int32)
    sort = torch.empty(Wn, geo.Kp, device=dev, dtype=torch.int64) if geo.smem_bytes == 0 else None
    outs = (torch.empty(Wn, 3, C, Kk, device=dev), torch.empty(Wn, C, Kk, device=dev),
            torch.empty(Wn, C, Kk, device=dev), torch.empty(Wn, Kk, device=dev, dtype=torch.int32),
            torch.empty(Wn, Kk, device=dev, dtype=torch.bool))
    args = _ReferenceK13Args(A.data_ptr(), d.data_ptr(), delta.data_ptr(),
                             frs.center_coef.data_ptr(), env.data_ptr(), obs.mask.data_ptr(),
                             g.data_ptr(), idx.data_ptr(),
                             sort.data_ptr() if sort is not None else None,
                             *(t.data_ptr() for t in outs), Wn, C, N, T * J, O, B, Kk, q,
                             geo.Kp, int(geo.smem_bytes > 0))
    err = fn(ctypes.byref(args), geo.smem_bytes,
             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    assert err == 0
    torch.cuda.synchronize(dev)
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("quota, dup", [(0, False), (8, False), (0, True), (8, True)])
def test_k13_matches_the_screen_of_k3s_tensors_on_the_card(quota, dup):
    """K13, which forms its rows again from the cells, against the screen
    that reads K3's hyperplane tensors (tests/data/screen_hyperplanes.cu) on
    the same K3 output: the same rows and the same bits in every field."""
    dev = _card()
    hyp, obs, frs = _screen_inputs(dev, dup)
    for K in (512, 3000):
        got = col.screen_collision(hyp, obs, frs, K, quota)
        ref = _reference_screen(hyp, obs, frs, K, quota)
        for f, b in zip(("A", "d", "delta", "row", "mask"), ref):
            assert torch.equal(getattr(got, f), b), (K, f)

"""Time the redesigned kernels on the card: K7 (alm_newton) and K8
(alm_values) launch by launch, K9 (fk_chain) and K10 (rnea_chain) beside
other launch geometries.

    python3 chip_probe.py

Runs one 64-world planning step (Kinova Gen3, the flagship config, the
first 64 saved worlds, as chip_smoke.py) and records its K7, K8, K9 and K10
calls:

  - every K7 and K8 call: the median of 20 calls (CUDA events) and the
    device time of each of its three launches (torch.profiler over 10
    calls);
  - K9 and K10 at W = 64 and at W = 1 (the first world): the median of 20
    calls with the geometry that kernels/reach.py:k9_geometry /
    k10_geometry picks and with other (threads per element, elements per
    block) pairs.  Neither result depends on the geometry: every variant
    must give the default's bits, or the script fails.

    python3 chip_probe.py --times

only times K7, K8, K9 and K10 on every shape of the step (W = 64), the
rescue profile's solve and a one-world step (W = 1), median of 20 calls each
(K7 also by device launch), K5 (rollout) on the first move of a one-
iteration closed loop over the same 64 worlds (median of 5), K6
(oracle_check) on that move (CUDA-event median of 20, its device time a
call by queued_ms, and torch.profiler's split), and the uncertain-centre-
of-mass route: the PZ RNEA of the step's JRS for the Kinova with
com_uncertainty = 0.05 (dynamics.rnea_pz_sets, median of 5, with its K1 /
K2 launches and those of one W = 64 planning step of that robot) and each
K1 / K2 call shape it makes, with K1's third shape, the transposed FK
product of joint 1 (matmul_linear_right), formed from the same JRS (median
of 20, and its device time), through the public launchers alone, so that
the same script can time an older checkout of the port beside this one on
one card, in turns (older, this, this, older).  It also prints a digest of
every K1, K2, K9 and K10 result's bits, of the uncertain-COM torque, and
of K6's flags and overlap counts on the move and on four copies with
planted faults (chip_smoke.planted_oracle_inputs), so that two checkouts
that must agree bit for bit can be held to it; where kernels/pz.py has
k2_geometry (k1_geometry), K2 (K1) also runs under the launch geometries of
K2_VARIANTS (K1_VARIANTS), each result's digest printed, and must give the
default's bits.  Last, it runs the --assembly part below.

Prints the card line and, last, one JSON line of the times.  Needs one
card; exits non-zero without one.

    python3 chip_probe.py --assembly

times K15 (reach_assembly) on every shape the planning paths give it: the
W = 64 step of the flagship Kinova in both trajectory families, of the
Kinova with an uncertain centre of mass (u_both from the K1 / K2 loops)
and the dumbbell's grasp step (J = 9); and K16 (grasp_rows) on that grasp
step, with its ablations where its source has the K16_ABLATE macro (a
copy built here with K16_ABLATE 1: the loads and stores alone; 2: with
the five squares).  Each: its bits against the plain version (not the ablations),
the median of 20 calls by CUDA events, its device time a call
(queued_ms), its bound, a digest of its outputs and its launch geometry;
the two kernels' ptxas reports.  --times runs it too.  Copied into an
older checkout, it times and digests that one in turns with this one.

    python3 chip_probe.py --variants

rebuilds K15 and K16 with other tile, stage and warp counts
(K15_VARIANTS, K16_VARIANTS: their #defines replaced in a copy of the
source), K15 also with its sums cut (its copies alone) and K16 with its
K16_ABLATE parts, holds each that computes the outputs to the plain
version's bits and times each (queued_ms) on the W = 64 flagship and
grasp steps' inputs, beside one torch sum and one torch copy of u_both's
coefficients as a yardstick of the card's memory rate.

    python3 chip_probe.py --step

times the W = 64 planning step of both trajectory families (the first 64
saved worlds; ARMTD with chip_smoke.armtd_inputs' start velocities) through
make_batch_planner alone, median of 7 after two warm-up steps, with its
device time and activities (torch.profiler; K12's / K11's, K14's and the
K7 / K8 finish kernels' share), K14's launches and the solve's host
launcher calls, and batch-1 p50 / p99 over 32 worlds (make_planner); K12
and K11 alone at W = 64 (median of 20, and device time); the dumbbell's
W = 64 grasp step (chip_smoke.py phase 13's configuration) under both
contact parameter sets; a W = 1,024 step (the 64 worlds 16 times, the
bench's width): its time and peak device memory, as each W = 64 step's;
and prints a digest of each result, of K10's torque and of K3's
hyperplanes of that step's cells (a direct K3 call): the links of K9 (the
FK chain) split here, in this script, with a left-to-right sum (so that two
checkouts whose reduce_links sum in other orders still hand K3 the same
cells).  Copied into an older checkout, it times and digests that one in
turns with this one (older, this, this, older).

    python3 chip_probe.py --k4

times K4 (collision_rows) on the screened rows of one plain solve of the
W = 64 flagship step (the first 64 saved worlds; nlp.constraint_stack
takes them from K4), in the hard mode and in the smooth one (smooth_tau =
chip_smoke.SMOOTH_TAU): every call shape through the public launcher
kernels/collision.py:collision_rows, the median of 20 calls (CUDA events),
its device time a call (queued_ms) and a digest of g / dg, and their sums;
and the seconds one nvcc takes to build csrc/collision_rows.cu alone (the
build's flags), with the ptxas report's entry functions and spills.
Copied into an older checkout, it times and digests that one in turns with
this one (older, this, this, older): the digests must agree.

    python3 chip_probe.py --nonfinite

plans the dumbbell's W = 64 grasp step (chip_smoke.py phase 13's
configuration, contact (1.5, 0.5)) in the hard and the smooth collision mode
and solves each plan three ways: plain (nlp.newton_step's float32 Cholesky,
on the card), eager (K7 / K8 with the plain bookkeeping: the fused solve's
bits) and fused.  For the plain solve it lists every (call, world, seed)
whose Cholesky fails, with the float64 eigenvalues of that float32 H and
whether a float64 Cholesky of it succeeds; for the eager solve every K7
step that is not finite; for both the line-search points that are not
finite and the feasible count, beside the fused solve's.

    python3 chip_probe.py --ops

runs on the CPU (no card): the torch ops that one uncertain-COM RNEA call
dispatches (dynamics._rnea_loops for the Kinova with com_uncertainty =
0.05, both parameter sets, the first 4 saved worlds at T = 128), with the
K1 / K2 calls and everything their plain versions dispatch left out, so
that what is counted is the glue the card runs around its 63 kernel
launches; by op name, and without the views (which launch nothing).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys

import torch

VARIANTS = {  # (threads per element, elements per block) beside each default
    ("fk_chain", "W=64"): ((32, 4), (32, 6), (64, 2), (128, 1), (256, 1)),
    ("fk_chain", "W=1"): ((128, 1), (64, 1), (32, 1)),
    ("rnea_chain", "W=64"): ((32, 4), (32, 3), (64, 2), (128, 1)),
    ("rnea_chain", "W=1"): ((256, 1), (128, 1), (64, 1)),
}
K2_VARIANTS = ((32, 4), (64, 2), (96, 2), (128, 1), (256, 1))
K1_VARIANTS = ((32, 1), (32, 4), (64, 2), (96, 2), (256, 1))
# the kernels' times before their current designs (PERF.md's kernel history;
# NVIDIA H100 80GB HBM3, 700 W), printed beside this run's
BEFORE_MS = {"oracle_check": "0.259", "pz_cross": "2.073 over its 4 shapes",
             "pz_matmul_linear": "2.295 over its 3 shapes",
             "reach_assembly": "0.1468 event / 0.0729 device at the flagship step, "
                               "0.1348 / 0.0764 at the grasp step",
             "grasp_rows": "0.1462 event / 0.1025 device"}
K16_ABLATIONS = {1: "loads and stores", 2: "loads, the five squares, stores"}
ITERS = 20
COM_UNCERTAINTY = 0.05     # the uncertain-COM route (tests/test_torch_reachsets.py)


def fail(msg: str) -> None:
    print(f"chip_probe: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


@contextlib.contextmanager
def chain_geometry(name: str, G: int, NG: int):
    """K9 (name fk_chain) or K10 (rnea_chain) launched with G threads per
    element and NG elements per block."""
    from armour_tpu_torch.kernels import reach

    attr, smem = {"fk_chain": ("k9_geometry", reach.k9_smem),
                  "rnea_chain": ("k10_geometry", reach.k10_smem)}[name]
    default = getattr(reach, attr)

    def fixed(n, ld, ldl, sms=reach.H100_SMS):
        return reach.chain_geometry(n, G, NG, smem(ld, ldl, NG), sms)

    setattr(reach, attr, fixed)
    try:
        yield
    finally:
        setattr(reach, attr, default)


def launch_split(fn, n: int = 10) -> dict:
    """Device ms per call of each kernel fn launches (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0]: e.self_device_time_total / 1e3 / n
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def queued_ms(fn, dev, n: int = 20, reps: int = 5) -> float:
    """Device ms per call of fn with its host work hidden: n calls are
    queued behind two float32 4096 x 4096 matrix products (several ms of
    work) and timed by CUDA events from the end of the products to the end
    of the last call; the median of reps.  (torch.profiler has returned 0
    ms for a whole session on that machine.)"""
    fn()
    a = torch.ones(4096, 4096, device=dev)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        a @ a
        a @ a
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return sorted(times)[reps // 2]


def same_bits(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("coef", "egen", "rad"))


def _drop_uploads(name: str) -> None:
    """Forget that library `name`'s basis tables were uploaded, on every
    card (kernels/pz.py:upload_tables keys by (device index, library)): a
    swapped-in library gets its own upload."""
    from armour_tpu_torch.kernels import pz as kpz

    for key in [k for k in kpz._UPLOADED if k[1] == name]:
        del kpz._UPLOADED[key]


def digest(p) -> str:
    """sha256 of a BPZ's coef, egen and rad bytes, or of a tuple of tensors."""
    import hashlib

    h = hashlib.sha256()
    ts = p if isinstance(p, tuple) else tuple(getattr(p, f) for f in ("coef", "egen", "rad"))
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def count_ops() -> dict:
    """--ops: the torch ops of one uncertain-COM RNEA call on the CPU, the
    K1 / K2 calls left out (see the module docstring)."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    from chip_smoke import scenes
    from armour_tpu_torch import dynamics
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.jrs import build_jrs
    from armour_tpu_torch.models.kinova import kinova_gen3
    from armour_tpu_torch.pz import bpz
    from armour_tpu_torch.pz.basis import make_basis

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops, self.views, self.paused = Counter(), 0, 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not self.paused:
                self.ops[func.overloadpacket.__name__] += 1
                self.views += bool(func.is_view)
            return func(*args, **(kwargs or {}))

    mode, calls = Count(), Counter()

    def left_out(fn, name):
        def call(*a, **k):
            mode.paused += 1
            calls[name] += 1
            try:
                return fn(*a, **k)
            finally:
                mode.paused -= 1
        return call

    robot = dataclasses.replace(kinova_gen3(), com_uncertainty=COM_UNCERTAINTY)
    cfg = ArmourConfig(dtype=torch.float32)
    basis = make_basis(robot.num_factors, cfg.max_poly_degree)
    q0, qd0, qdd0, _, _ = scenes(robot, cfg, 4)
    jrs = build_jrs(*(torch.as_tensor(x, dtype=cfg.dtype) for x in (q0, qd0, qdd0)), robot,
                    cfg, basis)
    with mode:
        dynamics._rnea_loops(jrs, robot, cfg, basis, ("nom", "int"),
                             left_out(bpz.matmul_linear_plain, "pz_matmul_linear"),
                             left_out(bpz.cross_plain, "pz_cross"))
    total = sum(mode.ops.values())
    out = {"torch_ops": total, "views": mode.views, "non_view_ops": total - mode.views,
           "kernel_calls_left_out": dict(calls), "by_op": dict(mode.ops.most_common())}
    print(f"uncertain-COM RNEA call (W = 4, T = 128, on the CPU): {total} torch ops "
          f"({mode.views} views, {total - mode.views} others) beside the kernel calls "
          f"{dict(calls)}; by op: " + ", ".join(f"{k} {v}" for k, v in mode.ops.most_common()))
    print(json.dumps(out))
    return out


def main() -> None:
    if "--ops" in sys.argv[1:]:
        count_ops()
        return
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs the card")
    if "--step" in sys.argv[1:]:
        step_only()
        return
    if "--nonfinite" in sys.argv[1:]:
        nonfinite_only()
        return
    if "--k4" in sys.argv[1:]:
        k4_only()
        return
    if "--assembly" in sys.argv[1:]:
        assembly_only()
        return
    if "--variants" in sys.argv[1:]:
        variants_only()
        return
    import armour_tpu_torch  # noqa: F401  (precision pins)
    from chip_smoke import card_line, scenes
    from armour_tpu_torch import kernels
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.kernels import reach, solver as ks
    from armour_tpu_torch.kernels.build import build_all
    from armour_tpu_torch.models.kinova import kinova_gen3
    from armour_tpu_torch.planner import make_batch_planner
    from armour_tpu_torch.pz.bpz import BPZ
    from armour_tpu_torch.utils.timing import median_ms

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    build_all()
    robot = kinova_gen3()
    cfg = ArmourConfig(dtype=torch.float32)
    step = make_batch_planner(robot, cfg)
    with kernels.capture() as captured:
        step(*scenes(robot, cfg, 64))
    torch.cuda.synchronize()
    if "--times" in sys.argv[1:]:
        times_only(captured, robot, cfg, card, dev)
        return
    out = {"card": card, "alm_newton": [], "alm_values": [], "fk_chain": {}, "rnea_chain": {}}

    for (name, key), inputs in captured.items():
        if name == "alm_newton":
            def fn(i=inputs):
                return ks.alm_newton(*i)
        elif name == "alm_values":
            def fn(i=inputs):
                return _k8(ks, i)
        else:
            continue
        ms = median_ms(fn, dev, ITERS)
        split = launch_split(fn)
        print(f"{'K7' if name == 'alm_newton' else 'K8'} {key}: {ms:.4f} ms a call (median of "
              f"{ITERS}); device ms a launch: " + ", ".join(f"{k} {v:.4f}"
                                                          for k, v in split.items()))
        out[name].append({"shape": list(key), "ms": ms, "launch_ms": split})

    jrs, _, _, basis, sets, _ = next(v for k, v in captured.items() if k[0] == "rnea_chain")

    def first(p):
        return BPZ(coef=p.coef[:1].contiguous(), egen=p.egen[:1].contiguous(),
                   rad=p.rad[:1].contiguous())

    jrs1 = dataclasses.replace(jrs, R=first(jrs.R), Rt=first(jrs.Rt), qd=first(jrs.qd),
                               qda=first(jrs.qda), qdda=first(jrs.qdda))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    E = jrs.R.egen.shape[-1]
    ld, ldl = basis.size + E + 1, reach.lin_ld(basis.nf, E)
    for name, label, j in (("fk_chain", "W=64", jrs), ("fk_chain", "W=1", jrs1),
                           ("rnea_chain", "W=64", jrs), ("rnea_chain", "W=1", jrs1)):
        if name == "fk_chain":
            def chain(j=j):
                return reach.fk_chain(j, robot, cfg, basis)
            geo = reach.k9_geometry
        else:
            def chain(j=j):
                return reach.rnea_chain(j, robot, cfg, basis, sets)
            geo = reach.k10_geometry

        ref = chain()
        g = geo(j.R.rad.shape[0] * j.R.rad.shape[1], ld, ldl, sms)
        times = {f"default G={g.G} NG={g.NG}": median_ms(chain, dev, ITERS)}
        for G, NG in VARIANTS[(name, label)]:
            with chain_geometry(name, G, NG):
                times[f"G={G} NG={NG}"] = median_ms(chain, dev, ITERS)
                if not same_bits(chain(), ref):
                    fail(f"{name} at {label} with G={G} NG={NG} differs from the default "
                         "geometry")
        print(f"{'K9' if name == 'fk_chain' else 'K10'} {label}: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
              + f" (medians of {ITERS}; every geometry gives the same bits)")
        out[name][label] = times
    print(card)
    print(json.dumps(out))


def _k8(ks, inputs):
    """K8 on its recorded inputs: the row passes (rows, kq, lam, rho,
    seed_of_q, want_c) or the max mode (rows, kq, "maxima")."""
    if inputs[-1] == "maxima":
        return ks.alm_maxima(*inputs[:2])
    return ks.alm_values(*inputs)


def device_profile(fn, dev) -> tuple:
    """(device ms, device activities, {name: device ms}) of one call of fn
    (torch.profiler: a warm-up call, then the recorded one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize(dev)
            prof.step()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
          and not e.name.startswith("ProfilerStep")]
    by = {}
    for e in ev:
        by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return sum(by.values()), len(ev), by


def _part(by, *keys) -> float:
    return sum(ms for n, ms in by.items() if any(k in n for k in keys))


W_BENCH = 1024   # the bench's largest width (armour_tpu_torch.bench, ARMOUR_BENCH_BATCH)


def step_peak_gb(fn, dev) -> float:
    """The peak device memory of one call of fn, GB: torch's
    max_memory_allocated after a reset (what was held before it included)."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev) / 1e9


def step_only() -> None:
    """--step: the W = 64 step of both families timed through
    make_batch_planner, its device time and activities (and K12's / K11's,
    K14's and the K7 / K8 finish kernels' device time in it), its K14
    launches and the solve's host launcher calls, the digest of each
    family's result (k, feasible, cost, viol), batch-1 p50 / p99 over 32
    worlds through make_planner, the dumbbell's W = 64 grasp step under
    both contact parameter sets (feasible counts, digests), K12 and K11
    alone at W = 64 (median of 20 calls, CUDA events, and device time), the
    digest of K10's torque and of K3's hyperplanes of the step's cells (a
    direct K3 call: no step launches it since K4 forms its rows from the
    cells), each step's K3 launches and peak device memory, and a W = 1,024
    step's (the bench's width) time, peak memory and digest."""
    import statistics

    import numpy as np

    import armour_tpu_torch  # noqa: F401  (precision pins)
    from chip_smoke import armtd_inputs, card_line, scenes
    from armour_tpu_torch import kernels
    from armour_tpu_torch.armtd import build_jrs_armtd
    from armour_tpu_torch.collision import ObstacleSet
    from armour_tpu_torch.config import ArmourConfig, derive_ultimate_bound
    from armour_tpu_torch.dynamics import rnea_pz_sets
    from armour_tpu_torch.jrs import build_jrs
    from armour_tpu_torch.kernels import collision as kcol
    from armour_tpu_torch.kernels.build import build_all
    from armour_tpu_torch.kinematics import forward_occupancy
    from armour_tpu_torch.models import zoo
    from armour_tpu_torch.models.kinova import kinova_gen3
    from armour_tpu_torch.planner import make_batch_planner, make_planner
    from armour_tpu_torch.pz.basis import make_basis
    from armour_tpu_torch.utils.timing import median_ms, wall_s

    dev = torch.device("cuda")
    card = card_line()
    build_all()
    robot = kinova_gen3()
    cfg = ArmourConfig(dtype=torch.float32)
    basis = make_basis(robot.num_factors, cfg.max_poly_degree)
    q0, qd0, qdd0, q_des, obs = scenes(robot, cfg, 64)
    q0d, q_des_d = (torch.as_tensor(x, dtype=cfg.dtype).to(dev) for x in (q0, q_des))
    obs_d = type(obs)(centers=obs.centers.to(dev), generators=obs.generators.to(dev),
                      mask=obs.mask.to(dev))
    z = torch.zeros_like(q0d)
    out = {"card": card}
    for family, qd in (("bernstein", z), ("armtd", armtd_inputs(q0d, cfg, 64, dev))):
        fcfg = dataclasses.replace(cfg, traj_family=family)
        step = make_batch_planner(robot, fcfg)
        for _ in range(2):
            wall_s(lambda: step(q0d, qd, z, q_des_d, obs_d), dev)
        ts = [wall_s(lambda: step(q0d, qd, z, q_des_d, obs_d), dev)[0] for _ in range(7)]
        out[f"{family}_step_ms"] = statistics.median(ts) * 1e3
        kernels.reset_counts()
        res = step(q0d, qd, z, q_des_d, obs_d)
        n = kernels.counts()
        out[f"{family}_k14_launches"] = n["alm_loop"]
        out[f"{family}_k3_launches"] = n["build_hyperplanes"]
        out[f"{family}_peak_gb"] = step_peak_gb(lambda: step(q0d, qd, z, q_des_d, obs_d), dev)
        out[f"{family}_solve_host_calls"] = n["alm_newton"] + n["alm_values"] + n["alm_loop"]
        out[f"{family}_result_digest"] = digest((res.k, res.feasible, res.cost, res.viol))
        dms, nact, by = device_profile(lambda: step(q0d, qd, z, q_des_d, obs_d), dev)
        out[f"{family}_device_ms"], out[f"{family}_activities"] = dms, nact
        out[f"{family}_jrs_device_ms"] = _part(by, "k12_", "k11_")
        out[f"{family}_k14_device_ms"] = _part(by, "k14_")
        out[f"{family}_finish_device_ms"] = _part(by, "k7_finish", "k8_finish")
        one = make_planner(robot, fcfg)
        batch1 = [(q0d[i], qd[i], z[i], q_des_d[i],
                   ObstacleSet(centers=obs_d.centers[i], generators=obs_d.generators[i],
                               mask=obs_d.mask[i])) for i in range(32)]
        wall_s(lambda: one(*batch1[0]), dev)
        lats = [wall_s(lambda a=a: one(*a), dev)[0] for a in batch1]
        out[f"{family}_batch1_p50_ms"] = float(np.percentile(lats, 50)) * 1e3
        out[f"{family}_batch1_p99_ms"] = float(np.percentile(lats, 99)) * 1e3
    for name, fn in (("k12", lambda: build_jrs(q0d, z, z, robot, cfg, basis)),
                     ("k11", lambda: build_jrs_armtd(q0d, armtd_inputs(q0d, cfg, 64, dev), robot,
                                                     dataclasses.replace(cfg, traj_family="armtd"),
                                                     basis))):
        out[f"{name}_event_ms"] = median_ms(fn, dev, ITERS)
        out[f"{name}_device_ms"] = _part(device_profile(fn, dev)[2], name + "_")
    jrs = build_jrs(q0d, z, z, robot, cfg, basis)
    out["k10_digest"] = digest(rnea_pz_sets(jrs, robot, cfg, basis))
    links = forward_occupancy(jrs, robot, cfg, basis)
    sh0 = links.egen.shape[-1] - 3
    radius = torch.zeros_like(links.rad)
    for i in range(sh0):
        radius = radius + links.egen[..., i].abs()
    radius = links.rad + radius
    hyp = kcol.build_hyperplanes(links.egen[..., sh0:].contiguous(), radius, obs_d.centers,
                                 obs_d.generators)
    out["k3_digest"] = digest(tuple(hyp))
    del jrs, links, hyp
    # the bench's width: W = 1,024 (the 64 worlds 16 times), its peak memory
    # and result digest
    reps = W_BENCH // 64
    big = (q0d.repeat(reps, 1), z.repeat(reps, 1), z.repeat(reps, 1), q_des_d.repeat(reps, 1),
           ObstacleSet(centers=obs_d.centers.repeat(reps, 1, 1),
                       generators=obs_d.generators.repeat(reps, 1, 1, 1),
                       mask=obs_d.mask.repeat(reps, 1)))
    step = make_batch_planner(robot, cfg)
    wall_s(lambda: step(*big), dev)
    out["w1024_step_ms"] = wall_s(lambda: step(*big), dev)[0] * 1e3
    out["w1024_peak_gb"] = step_peak_gb(lambda: step(*big), dev)
    res = step(*big)
    out["w1024_result_digest"] = digest((res.k, res.feasible, res.cost, res.viol))
    del big, res, step
    # the dumbbell's grasp step (chip_smoke.py phase 13's configuration)
    dumbbell = zoo.kinova_dumbbell()
    ub = derive_ultimate_bound(dumbbell, v_max=5e-4)
    for label, (mu, r) in (("grasp", (1.5, 0.5)), ("grasp_tight", (1e-4, 1e-4))):
        gcfg = ArmourConfig.for_robot(dumbbell, derive_ub=False, ub=ub, dtype=torch.float32,
                                      grasp_constraints=True, grasp_mu=mu, grasp_support_radius=r)
        g = [torch.as_tensor(x, dtype=gcfg.dtype).to(dev)
             for x in scenes(dumbbell, gcfg, 64)[:4]]
        gstep = make_batch_planner(dumbbell, gcfg)
        wall_s(lambda: gstep(*g, obs_d), dev)
        ts = [wall_s(lambda: gstep(*g, obs_d), dev)[0] for _ in range(3)]
        res = gstep(*g, obs_d)
        out[f"{label}_step_ms"] = statistics.median(ts) * 1e3
        out[f"{label}_feasible"] = int(res.feasible.sum())
        out[f"{label}_result_digest"] = digest((res.k, res.feasible, res.cost, res.viol))
    print("step: " + ", ".join(
        f"{f} {out[f + '_step_ms']:.3f} ms (device {out[f + '_device_ms']:.3f} ms in "
        f"{out[f + '_activities']} activities; JRS {out[f + '_jrs_device_ms']:.4f}, K14 "
        f"{out[f + '_k14_device_ms']:.4f} in {out[f + '_k14_launches']} launches, K7 / K8 "
        f"finish {out[f + '_finish_device_ms']:.4f}; {out[f + '_solve_host_calls']} host "
        f"launcher calls in the solve; K3 x{out[f + '_k3_launches']}; peak "
        f"{out[f + '_peak_gb']:.3f} GB; batch-1 p50 {out[f + '_batch1_p50_ms']:.3f} / p99 "
        f"{out[f + '_batch1_p99_ms']:.3f} ms; digest {out[f + '_result_digest']})"
        for f in ("bernstein", "armtd")))
    print(f"  K12 {out['k12_event_ms']:.4f} ms event / {out['k12_device_ms']:.4f} ms device, K11 "
          f"{out['k11_event_ms']:.4f} / {out['k11_device_ms']:.4f} (W = 64, medians of {ITERS}); "
          f"K10 digest {out['k10_digest']}, K3 digest {out['k3_digest']}")
    print(f"  W = {W_BENCH} step {out['w1024_step_ms']:.1f} ms, peak {out['w1024_peak_gb']:.3f} GB, "
          f"digest {out['w1024_result_digest']}")
    print("  dumbbell grasp step: " + ", ".join(
        f"{lb} {out[lb + '_step_ms']:.3f} ms, {out[lb + '_feasible']} of 64 feasible, digest "
        f"{out[lb + '_result_digest']}" for lb in ("grasp", "grasp_tight")))
    print(card)
    print(json.dumps(out))


def k4_only() -> None:
    """--k4: K4's screened rows of one plain solve at the W = 64 step, hard
    and smooth, through the public launcher; and collision_rows.cu's nvcc
    time.  See the module docstring."""
    import os
    import re
    import subprocess
    import tempfile
    import time

    import armour_tpu_torch  # noqa: F401  (precision pins)
    from chip_smoke import SMOOTH_TAU, card_line, scenes
    from armour_tpu_torch import kernels, nlp
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.kernels import build
    from armour_tpu_torch.kernels import collision as kcol
    from armour_tpu_torch.models.kinova import kinova_gen3
    from armour_tpu_torch.planner import plan_problem
    from armour_tpu_torch.pz.basis import make_basis
    from armour_tpu_torch.utils.timing import median_ms

    dev = torch.device("cuda")
    card = card_line()
    fd, tmp = tempfile.mkstemp(suffix=".so")
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([build.nvcc(), *build.FLAGS, "-o", tmp,
                           str(build.CSRC / build.SOURCES["collision_rows"])],
                          capture_output=True, text=True)
    nvcc_s = time.perf_counter() - t0
    os.unlink(tmp)
    if proc.returncode:
        fail(f"nvcc failed for collision_rows.cu:\n{proc.stdout}{proc.stderr}")
    report = proc.stdout + proc.stderr
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", report)]
    out = {"card": card, "nvcc_collision_rows_s": nvcc_s,
           "entry_functions": report.count("Compiling entry function"),
           "max_spill_store_bytes": max(spills, default=0), "digest": {}}
    build.build_all()
    robot = kinova_gen3()
    cfg = ArmourConfig(dtype=torch.float32)
    basis = make_basis(robot.num_factors, cfg.max_poly_degree)
    q0, _, _, q_des, obs = scenes(robot, cfg, 64)
    q0d, q_des_d = (torch.as_tensor(x, dtype=cfg.dtype).to(dev) for x in (q0, q_des))
    obs_d = type(obs)(centers=obs.centers.to(dev), generators=obs.generators.to(dev),
                      mask=obs.mask.to(dev))
    z = torch.zeros_like(q0d)
    for mode, mcfg in (("hard", cfg), ("smooth", dataclasses.replace(
            cfg, smooth_obstacle_constraints=True, smooth_tau=SMOOTH_TAU))):
        prob = plan_problem(q0d, z, z, q_des_d, obs_d, robot, mcfg, basis)
        with kernels.capture() as cap:
            nlp.solve(prob, mcfg, basis, plain=True)
        torch.cuda.synchronize(dev)
        tot = {"event_ms": 0.0, "device_ms": 0.0, "shapes": 0}
        for (name, key), inputs in cap.items():
            if name != "collision_rows" or len(inputs) != 8:
                continue
            A, d, delta, row, mask, p_all, dp_all, tau = inputs

            def fn(i=inputs):
                return kcol.collision_rows(*i[:7], smooth_tau=i[7])

            ms, dms = median_ms(fn, dev, ITERS), queued_ms(fn, dev)
            dig = digest(tuple(t for t in fn() if t is not None))
            out["digest"][f"{mode} {key}"] = dig
            out[f"{mode} {key}"] = {"event_ms": ms, "device_ms": dms}
            print(f"K4 {mode} {key}: {ms:.4f} ms (median of {ITERS}), device {dms:.4f} ms a "
                  f"call (queued_ms), digest {dig}")
            for f, x in (("event_ms", ms), ("device_ms", dms), ("shapes", 1)):
                tot[f] += x
        cap.clear()
        del prob
        out[f"{mode}_total"] = tot
        print(f"K4 {mode} screened rows of one plain solve: {tot['event_ms']:.4f} ms of CUDA-event "
              f"time, {tot['device_ms']:.4f} ms of device time over {tot['shapes']} shapes")
    print(f"nvcc collision_rows.cu alone: {nvcc_s:.1f} s, {out['entry_functions']} entry "
          f"functions, largest spill store {out['max_spill_store_bytes']} bytes")
    print(card)
    print(json.dumps(out))


def nonfinite_only() -> None:
    """--nonfinite: where the dumbbell's grasp solve meets a failed float32
    Cholesky (see the module docstring)."""
    import numpy as np

    import armour_tpu_torch  # noqa: F401  (precision pins)
    from chip_smoke import GRASP_PERMISSIVE, GRASP_V_MAX, SMOOTH_TAU, card_line, scenes
    from armour_tpu_torch import nlp
    from armour_tpu_torch.collision import ObstacleSet
    from armour_tpu_torch.config import ArmourConfig, derive_ultimate_bound
    from armour_tpu_torch.kernels.build import build_all
    from armour_tpu_torch.models import zoo
    from armour_tpu_torch.planner import plan_problem
    from armour_tpu_torch.pz.basis import make_basis

    dev = torch.device("cuda")
    card = card_line()
    build_all()
    robot = zoo.kinova_dumbbell()
    mu, r = GRASP_PERMISSIVE
    ub = derive_ultimate_bound(robot, v_max=GRASP_V_MAX)
    basis = make_basis(robot.num_factors, 3)
    log = {}
    newton_step, alm_newton = nlp.newton_step, nlp.alm_newton
    alm_values, alm_values_plain = nlp.alm_values, nlp.alm_values_plain

    def rec_step(H, g):
        step = newton_step(H, g)
        _, info = torch.linalg.cholesky_ex(H)
        bad = torch.nonzero(info != 0).tolist()
        log["calls"] += 1
        for w, s_ in bad:
            H64 = H[w, s_].double()
            ev = torch.linalg.eigvalsh(H64)
            log["fails"].append({"call": log["calls"], "world": w, "seed": s_,
                                 "eig_min": float(ev[0]), "eig_max": float(ev[-1]),
                                 "f64_cholesky_ok": int(torch.linalg.cholesky_ex(H64)[1]) == 0})
        return step

    def rec_newton(*a, **kw):
        out = alm_newton(*a, **kw)
        log["calls"] += 1
        for w, s_ in torch.nonzero(~torch.isfinite(out[0]).all(-1)).tolist():
            log["fails"].append({"call": log["calls"], "world": w, "seed": s_})
        return out

    def rec_values(fn):
        def wrapped(kq, *a, **kw):
            bad = ~torch.isfinite(kq).all(-1)
            log["nan_points"] += int(bad.sum())
            log["nan_worlds"] |= set(torch.nonzero(bad.any(-1)).flatten().tolist())
            return fn(kq, *a, **kw)
        return wrapped

    out = {"card": card}
    for mode in ("hard", "smooth"):
        cfg = ArmourConfig.for_robot(robot, derive_ub=False, ub=ub, dtype=torch.float32,
                                     grasp_constraints=True, grasp_mu=mu, grasp_support_radius=r,
                                     smooth_obstacle_constraints=mode == "smooth",
                                     smooth_tau=SMOOTH_TAU)
        q = scenes(robot, cfg, 64)
        args = [torch.as_tensor(x, dtype=cfg.dtype).to(dev) for x in q[:4]]
        obs = ObstacleSet(centers=q[4].centers.to(dev), generators=q[4].generators.to(dev),
                          mask=q[4].mask.to(dev))
        prob = plan_problem(*args, obs, robot, cfg, basis)
        fused = nlp.solve(prob, cfg, basis)
        for how in ("plain", "eager"):
            log.update(calls=0, fails=[], nan_points=0, nan_worlds=set())
            nlp.newton_step, nlp.alm_newton = rec_step, rec_newton
            nlp.alm_values_plain, nlp.alm_values = rec_values(alm_values_plain), \
                rec_values(alm_values)
            try:
                res = nlp.solve(prob, cfg, basis, **{how: True})
            finally:
                nlp.newton_step, nlp.alm_newton = newton_step, alm_newton
                nlp.alm_values_plain, nlp.alm_values = alm_values_plain, alm_values
            torch.cuda.synchronize(dev)
            fails = log["fails"]
            entry = {"newton_calls": log["calls"], "failed_steps": len(fails),
                     "failed_worlds": sorted({f["world"] for f in fails}),
                     "nan_query_points": log["nan_points"],
                     "nan_query_worlds": sorted(log["nan_worlds"]),
                     "feasible": int(res.feasible.sum()),
                     "fused_feasible": int(fused.feasible.sum()),
                     "verdicts_differ_from_fused": int((res.feasible != fused.feasible).sum())}
            if how == "plain" and fails:
                eig_min = np.array([f["eig_min"] for f in fails])
                eig_max = np.array([f["eig_max"] for f in fails])
                entry.update(eig_min_range=[float(eig_min.min()), float(eig_min.max())],
                             eig_max_range=[float(eig_max.min()), float(eig_max.max())],
                             cond_min=float((eig_max / np.abs(eig_min)).min()),
                             f64_cholesky_ok=sum(f["f64_cholesky_ok"] for f in fails),
                             failures=fails[:24])
            out[f"{mode}_{how}"] = entry
            print(f"{mode} grasp plan, {how} solve: {len(fails)} of the (call, world, seed) "
                  f"Newton steps not finite ({'failed float32 Cholesky' if how == 'plain' else 'K7'}"
                  f") in worlds {entry['failed_worlds']}, {log['nan_points']} line-search points "
                  f"not finite in worlds {entry['nan_query_worlds']}; feasible {entry['feasible']} "
                  f"(fused {entry['fused_feasible']}, {entry['verdicts_differ_from_fused']} "
                  f"verdicts differ)")
            if how == "plain" and fails:
                print(f"  the failing float32 H in float64: min eigenvalue "
                      f"{entry['eig_min_range'][0]:.4g} .. {entry['eig_min_range'][1]:.4g}, max "
                      f"{entry['eig_max_range'][0]:.4g} .. {entry['eig_max_range'][1]:.4g}, "
                      f"smallest max / |min| {entry['cond_min']:.4g}; a float64 Cholesky "
                      f"succeeds on {entry['f64_cholesky_ok']} of {len(fails)}")
    print(card)
    print(json.dumps(out))


def times_only(captured, robot, cfg, card, dev) -> None:
    """Medians of 20 calls of K7, K8, K9 and K10 on every recorded shape of
    the step, the rescue profile's solve and a one-world step (K7 also by device
    launch), of 5 calls of K5 and 20 of K6 on the first move of a one-iteration
    closed loop over the step's 64 worlds (K6 also by device time), and the
    uncertain-COM route (the RNEA call, its K1 / K2 launches and call
    shapes)."""
    import glob

    from chip_smoke import planted_oracle_inputs, scenes
    from armour_tpu_torch import kernels, nlp
    from armour_tpu_torch.batch_sim import run_trials_batched
    from armour_tpu_torch.collision import ObstacleSet
    from armour_tpu_torch.kernels import reach, sim as ksim, solver as ks
    from armour_tpu_torch.worlds import load_world_csv
    from armour_tpu_torch.planner import make_batch_planner, plan_problem, strong_config
    from armour_tpu_torch.pz.basis import make_basis
    from armour_tpu_torch.utils.timing import median_ms

    q0, qd0, qdd0, q_des, obs = scenes(robot, cfg, 64)
    args = [torch.as_tensor(x, dtype=cfg.dtype).to(dev) for x in (q0, qd0, qdd0, q_des)]
    obs = ObstacleSet(centers=obs.centers.to(dev), generators=obs.generators.to(dev),
                      mask=obs.mask.to(dev))
    basis = make_basis(robot.num_factors, cfg.max_poly_degree)
    strong = strong_config(cfg)
    with kernels.capture() as rescue:
        nlp.solve(plan_problem(*args, obs, robot, strong, basis), strong, basis)
    step1 = make_batch_planner(robot, cfg)
    with kernels.capture() as one:
        step1(*scenes(robot, cfg, 1))
    worlds = [load_world_csv(p) for p in sorted(glob.glob("saved_worlds/random/*.csv"))[:64]]
    with kernels.capture() as loop:
        run_trials_batched(worlds, robot, cfg, max_iterations=1, true_param_scale=1.0, seed=0,
                           rescue_solver=True, guidance="straight", stats={})
    torch.cuda.synchronize()
    out = {"card": card, "alm_newton": {}, "alm_newton_launch_ms": {}, "alm_values": {},
           "fk_chain": {}, "rnea_chain": {}, "rollout": {}, "oracle_check": {},
           "uncertain_com": {}, "pz_matmul_linear": {}, "pz_cross": {}, "digest": {}}
    for (name, key), inputs in loop.items():
        if name == "rollout":
            def k5(i=inputs):
                return ksim.rollout(robot, cfg, **i)

            ms = median_ms(k5, dev, 5)
            out["rollout"][f"move {key}"] = ms
            print(f"rollout move {key}: {ms:.3f} ms (median of 5)")
        elif name == "oracle_check":
            def k6(i=inputs):
                return ksim.oracle_check(robot, cfg, **i)

            ms = median_ms(k6, dev, ITERS)
            dev_ms = queued_ms(k6, dev)
            split = launch_split(k6)
            out["oracle_check"][f"move {key}"] = {"event_ms": ms, "device_ms": dev_ms,
                                                   "profiler_ms_by_kernel": split}
            print(f"oracle_check move {key}: {ms:.4f} ms a call (CUDA events, median of "
                  f"{ITERS}; before: {BEFORE_MS['oracle_check']} ms); device {dev_ms:.4f} ms a "
                  f"call (queued_ms); torch.profiler over 10 calls: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
            for label, x in [("as logged", inputs)] + planted_oracle_inputs(robot, cfg, inputs):
                flags, overlaps = ksim.oracle_check(robot, cfg, **x)
                out["digest"][f"oracle_check {label}"] = digest((flags, overlaps))
                print(f"oracle_check {label}: flags raised {flags.sum(0).tolist()}, overlaps "
                      f"{int(overlaps.sum())}, digest {out['digest'][f'oracle_check {label}']}")
    for label, rec in (("step", captured), ("rescue", rescue), ("W=1", one)):
        for (name, key), inputs in rec.items():
            if name == "alm_newton":
                def fn(i=inputs):
                    return ks.alm_newton(*i)

                out["alm_newton_launch_ms"][f"{label} {key}"] = launch_split(fn)
            elif name == "alm_values":
                def fn(i=inputs):
                    return _k8(ks, i)
            elif name == "fk_chain":
                def fn(i=inputs):
                    return reach.fk_chain(*i)
            elif name == "rnea_chain":
                def fn(i=inputs):
                    return reach.rnea_chain(*i[:5], wrench_at=i[5])
            else:
                continue
            ms = median_ms(fn, dev, ITERS)
            out[name][f"{label} {key}"] = ms
            print(f"{name} {label} {key}: {ms:.4f} ms (median of {ITERS})")
            if name in ("fk_chain", "rnea_chain"):
                out["digest"][f"{name} {label} {key}"] = digest(fn())
    uncertain_com(captured, robot, cfg, basis, args, obs, dev, out)
    out["assembly"] = assembly_times(dev)
    print(card)
    print(json.dumps(out))


def assembly_only() -> None:
    """--assembly: K15 and K16 alone (assembly_times), after the build."""
    import armour_tpu_torch  # noqa: F401  (precision pins)
    from chip_smoke import card_line
    from armour_tpu_torch.kernels.build import build_all

    card = card_line()
    print(f"card: {card}")
    build_all()
    out = {"card": card, "assembly": assembly_times(torch.device("cuda"))}
    print(card)
    print(json.dumps(out))


K15_VARIANTS = ((4, 2, False), (8, 2, False), (2, 2, False), (4, 3, False), (4, 2, True),
                (8, 2, True))   # (K15_TILE, K15_STAGES, copies alone)
K16_VARIANTS = ((8, 2, 0), (4, 5, 0), (8, 2, 1), (8, 2, 2))   # (K16_NG, blocks an SM, K16_ABLATE)


def _variant_library(src: str, subs, tag: str):
    """csrc/src with each #define of `subs` replaced, built with the
    kernels' flags beside their libraries (reused while the text, the
    headers and the flags are the same); (path, ptxas lines)."""
    import hashlib
    import subprocess

    from armour_tpu_torch.kernels import build

    text = (build.CSRC / src).read_text()
    for old, new in subs:
        if old not in text:
            fail(f"{src} has no {old!r} to vary")
        text = text.replace(old, new)
    h = hashlib.sha256(text.encode())
    for hdr in sorted(build.CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(build.FLAGS).encode())
    out = build.BUILD / "variants"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"lib{tag}-{h.hexdigest()[:16]}.so"
    log = path.with_suffix(".log")
    if not path.exists():
        (out / f"{tag}.cu").write_text(text)
        r = subprocess.run([build.nvcc(), *build.FLAGS, f"-I{build.CSRC}", "-o", str(path),
                            str(out / f"{tag}.cu")], capture_output=True, text=True)
        if r.returncode:
            fail(f"nvcc failed for the variant {tag}:\n{r.stdout}{r.stderr}")
        log.write_text(r.stdout + r.stderr)
    return path, [ln.strip() for ln in log.read_text().splitlines()
                  if "registers" in ln or "spill" in ln]


def variants_only() -> None:
    """--variants: K15 and K16 rebuilt with other tile, stage and warp
    counts (K15_VARIANTS, K16_VARIANTS; K15 also with its sums cut, its
    copies alone), each held to the committed kernel's bits where it
    computes them and timed (queued_ms) on the W = 64 flagship and grasp
    steps' inputs, beside torch's own reads of K15's largest input (one
    sum, one copy) as a yardstick of the card's rate."""
    import ctypes

    import armour_tpu_torch  # noqa: F401  (precision pins)
    from chip_smoke import card_line, scenes
    from armour_tpu_torch import dynamics, grasp, kernels
    from armour_tpu_torch.collision import ObstacleSet
    from armour_tpu_torch.config import ArmourConfig, derive_ultimate_bound
    from armour_tpu_torch.kernels import build, pz as kpz, reach
    from armour_tpu_torch.kernels import grasp as kgrasp
    from armour_tpu_torch.kernels.build import build_all
    from armour_tpu_torch.models import zoo
    from armour_tpu_torch.models.kinova import kinova_gen3
    from armour_tpu_torch.planner import make_batch_planner

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    build_all()
    robot, cfg = kinova_gen3(), ArmourConfig(dtype=torch.float32)
    q0, _, _, q_des, obs = scenes(robot, cfg, 64)
    q0d, q_des_d = (torch.as_tensor(x, dtype=cfg.dtype).to(dev) for x in (q0, q_des))
    obs_d = ObstacleSet(centers=obs.centers.to(dev), generators=obs.generators.to(dev),
                        mask=obs.mask.to(dev))
    z = torch.zeros_like(q0d)
    dumbbell = zoo.kinova_dumbbell()
    gcfg = ArmourConfig.for_robot(dumbbell, derive_ub=False,
                                  ub=derive_ultimate_bound(dumbbell, v_max=5e-4),
                                  dtype=torch.float32, grasp_constraints=True, grasp_mu=1.5,
                                  grasp_support_radius=0.5)
    g = [torch.as_tensor(x, dtype=gcfg.dtype).to(dev) for x in scenes(dumbbell, gcfg, 64)[:4]]
    with kernels.capture() as rec:
        make_batch_planner(robot, cfg)(q0d, z, z, q_des_d, obs_d)
        make_batch_planner(dumbbell, gcfg)(*g, obs_d)
    torch.cuda.synchronize(dev)
    k15 = {("flagship" if k[1][0][2] == robot.num_joints else "grasp"): v
           for k, v in rec.items() if k[0] == "reach_assembly"}
    k16 = next(v for k, v in rec.items() if k[0] == "grasp_rows")
    del rec
    out = {"card": card}
    coef = k15["flagship"][1].coef
    copy = torch.empty_like(coef)
    nb = coef.numel() * coef.element_size()
    for name, fn, moved in (("torch sum", lambda: coef.sum(), nb),
                            ("torch copy_", lambda: copy.copy_(coef), 2 * nb)):
        ms = queued_ms(fn, dev)
        out[name] = {"device_ms": ms, "TB_per_s": moved / ms / 1e9}
        print(f"yardstick {name} of u_both's coef ({nb / 1e6:.1f} MB): {ms:.4f} ms device, "
              f"{moved / ms / 1e9:.2f} TB/s")
    want = {lab: dynamics.reach_assembly_plain(*x) for lab, x in k15.items()}
    keep = (build.library("reach_assembly"), reach.K15_TILE, reach.K15_THREADS, reach.K15_STAGES)
    try:
        for tile, stages, copies in K15_VARIANTS:
            tag = f"k15_tile{tile}_stages{stages}{'_copies' if copies else ''}"
            subs = [("#define K15_TILE 4 ", f"#define K15_TILE {tile} "),
                    ("#define K15_STAGES 2", f"#define K15_STAGES {stages}")]
            if copies:
                subs.append(("    if (t0 + s < T) {", "    if (false && t0 + s < T) {"))
            path, ptxas = _variant_library("reach_assembly.cu", subs, tag)
            build._LIBS["reach_assembly"] = ctypes.CDLL(str(path))
            reach.K15_TILE, reach.K15_THREADS, reach.K15_STAGES = tile, 32 * tile, stages
            reach.k15_geometry.cache_clear()
            row = {"ptxas": ptxas}
            for lab, x in k15.items():
                got = reach.reach_assembly(*x)
                ref = want[lab]
                bits = None if copies else all(torch.equal(a, b) for a, b in (
                    (got[0].shape_gens, ref[0].shape_gens), (got[0].radius, ref[0].radius),
                    (got[1].torque_radius, ref[1].torque_radius)))
                if bits is False:
                    fail(f"K15 variant {tag} differs from its plain version at the {lab} step")
                row[lab] = queued_ms(lambda x=x: reach.reach_assembly(*x), dev)
            out[tag] = row
            print(f"{tag}: device ms flagship {row['flagship']:.4f}, grasp {row['grasp']:.4f}"
                  f"{'' if copies else ', bits of the plain version'}; {ptxas}")
    finally:
        build._LIBS["reach_assembly"] = keep[0]
        reach.K15_TILE, reach.K15_THREADS, reach.K15_STAGES = keep[1:]
        reach.k15_geometry.cache_clear()
    want16 = grasp.grasp_rows_plain(*k16)
    keep = (build.library("grasp_rows"), kgrasp.K16_NG, kgrasp.K16_THREADS,
            kgrasp.K16_BLOCKS_PER_SM)
    try:
        for ng, per_sm, ablate in K16_VARIANTS:
            tag = f"k16_warps{ng}_blocks{per_sm}_ablate{ablate}"
            path, ptxas = _variant_library("grasp_rows.cu", [
                ("#define K16_NG 8 ", f"#define K16_NG {ng} "),
                ("#define K16_THREADS 256", f"#define K16_THREADS {32 * ng}"),
                ("#define K16_BLOCKS_PER_SM 2", f"#define K16_BLOCKS_PER_SM {per_sm}"),
                ("#define K16_ABLATE 0", f"#define K16_ABLATE {ablate}")], tag)
            build._LIBS["grasp_rows"] = ctypes.CDLL(str(path))
            _drop_uploads("grasp_rows")
            kgrasp.K16_NG, kgrasp.K16_THREADS, kgrasp.K16_BLOCKS_PER_SM = ng, 32 * ng, per_sm
            kgrasp.k16_geometry.cache_clear()
            got = kgrasp.grasp_rows(*k16)
            if not ablate and not (torch.equal(got.g_coef, want16.g_coef)
                                   and torch.equal(got.g_rad, want16.g_rad)):
                fail(f"K16 variant {tag} differs from its plain version")
            out[tag] = {"device_ms": queued_ms(lambda: kgrasp.grasp_rows(*k16), dev),
                        "ptxas": ptxas}
            print(f"{tag}: device ms {out[tag]['device_ms']:.4f}"
                  f"{'' if ablate else ', bits of the plain version'}; {ptxas}")
    finally:
        build._LIBS["grasp_rows"] = keep[0]
        _drop_uploads("grasp_rows")
        kgrasp.K16_NG, kgrasp.K16_THREADS, kgrasp.K16_BLOCKS_PER_SM = keep[1:]
        kgrasp.k16_geometry.cache_clear()
    print(card)
    print(json.dumps(out))


def _ablation_libraries() -> dict:
    """{level: path} of grasp_rows.cu built with K16_ABLATE = level for
    each level of K16_ABLATIONS, or {} where this checkout's source has no
    such macro."""
    from armour_tpu_torch.kernels import build

    if "#define K16_ABLATE 0" not in (build.CSRC / "grasp_rows.cu").read_text():
        return {}
    return {level: _variant_library("grasp_rows.cu", [
        ("#define K16_ABLATE 0", f"#define K16_ABLATE {level}")], f"k16_ablate{level}")[0]
        for level in K16_ABLATIONS}


def assembly_times(dev) -> dict:
    """K15 (reach_assembly) on every recorded shape: the W = 64 step of the
    flagship Kinova (Bernstein and ARMTD), of the Kinova with an uncertain
    centre of mass (u_both from the K1 / K2 loops) and the dumbbell's grasp
    step (J = 9); K16 (grasp_rows) on that grasp step, and its ablations
    (K16_ABLATIONS, where the source has them).  Each: its bits against the
    plain version (chip_smoke.check_reach_assembly / check_grasp; an
    ablation is not checked), the median of ITERS calls by CUDA events, its
    device time a call (queued_ms), its byte / operation bound and a digest
    of its outputs; the kernels' ptxas reports and, where this checkout has
    them, their launch geometries."""
    import ctypes

    from chip_smoke import (_bound_ms, armtd_inputs, check_grasp, check_reach_assembly,
                            scenes)
    from armour_tpu_torch import kernels
    from armour_tpu_torch.collision import ObstacleSet
    from armour_tpu_torch.config import ArmourConfig, derive_ultimate_bound
    from armour_tpu_torch.kernels import build, pz as kpz, reach
    from armour_tpu_torch.kernels import grasp as kgrasp
    from armour_tpu_torch.models import zoo
    from armour_tpu_torch.models.kinova import kinova_gen3
    from armour_tpu_torch.planner import make_batch_planner
    from armour_tpu_torch.utils.timing import median_ms

    for name, log in build.build_all(["reach_assembly", "grasp_rows"]).items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    robot = kinova_gen3()
    cfg = ArmourConfig(dtype=torch.float32)
    q0, _, _, q_des, obs = scenes(robot, cfg, 64)
    q0d, q_des_d = (torch.as_tensor(x, dtype=cfg.dtype).to(dev) for x in (q0, q_des))
    obs_d = ObstacleSet(centers=obs.centers.to(dev), generators=obs.generators.to(dev),
                        mask=obs.mask.to(dev))
    z = torch.zeros_like(q0d)
    dumbbell = zoo.kinova_dumbbell()
    gcfg = ArmourConfig.for_robot(dumbbell, derive_ub=False,
                                  ub=derive_ultimate_bound(dumbbell, v_max=5e-4),
                                  dtype=torch.float32, grasp_constraints=True, grasp_mu=1.5,
                                  grasp_support_radius=0.5)
    g = [torch.as_tensor(x, dtype=gcfg.dtype).to(dev) for x in scenes(dumbbell, gcfg, 64)[:4]]
    steps = (("flagship", lambda: make_batch_planner(robot, cfg)(q0d, z, z, q_des_d, obs_d)),
             ("armtd", lambda: make_batch_planner(
                 robot, dataclasses.replace(cfg, traj_family="armtd"))(
                 q0d, armtd_inputs(q0d, cfg, 64, dev), z, q_des_d, obs_d)),
             ("uncertain_com", lambda: make_batch_planner(
                 dataclasses.replace(robot, com_uncertainty=COM_UNCERTAINTY), cfg)(
                 q0d, z, z, q_des_d, obs_d)),
             ("grasp", lambda: make_batch_planner(dumbbell, gcfg)(*g, obs_d)))
    out = {"reach_assembly": {}, "grasp_rows": {}}
    for label, step in steps:
        with kernels.capture() as rec:
            step()
        torch.cuda.synchronize(dev)
        for (name, key), inputs in rec.items():
            if name not in out:
                continue
            check = check_reach_assembly if name == "reach_assembly" else check_grasp
            ok, err, kern, _, nbytes, flops, note = check(inputs, dev)
            if not ok:
                fail(f"{name} at the {label} step: {note}")
            got = kern()
            ts = ((got[0].shape_gens, got[0].radius, got[1].torque_radius)
                  if name == "reach_assembly" else (got.g_coef, got.g_rad))
            row = {"shape": str(key), "event_ms": median_ms(kern, dev, ITERS),
                   "device_ms": queued_ms(kern, dev), "bound_ms": _bound_ms(nbytes, flops),
                   "bytes": nbytes, "digest": digest(ts)}
            geo = None
            if name == "reach_assembly" and hasattr(reach, "k15_geometry"):
                links = inputs[0]
                Wn, T, J = links.rad.shape[:3]
                geo = reach.k15_geometry(Wn, T, inputs[1].rad.shape[-1], 3 * J,
                                         links.coef.shape[-1], links.egen.shape[-1],
                                         torch.cuda.get_device_properties(dev)
                                         .multi_processor_count)
            elif name == "grasp_rows":
                f_c = inputs[0]
                sms = torch.cuda.get_device_properties(dev).multi_processor_count
                ld = f_c.coef.shape[-1] + f_c.egen.shape[-1] + 1
                geo = (kgrasp.k16_geometry(f_c.rad.shape[0], f_c.rad.shape[2], ld, sms)
                       if hasattr(kgrasp, "K16_STAGES")   # tiles of steps
                       else kgrasp.k16_geometry(f_c.rad.shape[0] * f_c.rad.shape[2], ld, sms))
            row["geometry"] = str(geo)
            if name == "grasp_rows":
                default = build._LIBS.get("grasp_rows")
                try:
                    for level, path in _ablation_libraries().items():
                        build._LIBS["grasp_rows"] = ctypes.CDLL(str(path))
                        _drop_uploads("grasp_rows")
                        row[f"ablate{level}"] = {"what": K16_ABLATIONS[level],
                                                 "event_ms": median_ms(kern, dev, ITERS),
                                                 "device_ms": queued_ms(kern, dev)}
                finally:
                    build._LIBS["grasp_rows"] = default
                    _drop_uploads("grasp_rows")
            out[name][label] = row
            parts = "".join(f"; ablation {lv} ({v['what']}): {v['event_ms']:.4f} event / "
                            f"{v['device_ms']:.4f} device" for lv, v in
                            ((k[6:], v) for k, v in row.items() if k.startswith("ablate")))
            print(f"{name} {label} {key}: {row['event_ms']:.4f} ms event (median of {ITERS}; "
                  f"before: {BEFORE_MS[name]}), {row['device_ms']:.4f} ms device (queued_ms), "
                  f"bound {row['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB); bits of the plain "
                  f"version; geometry {geo}; digest {row['digest']}{parts}")
        del rec
    for name in out:
        if not out[name]:
            fail(f"no {name} call was recorded")
    return out


def _variants(name, kpz, kernels):
    """(label, geometry function) of every launch geometry K1 (name
    pz_matmul_linear) or K2 (pz_cross) is also held to, where this checkout
    has the kernel's geometry function; else none."""
    if name == "pz_cross" and hasattr(kpz, "k2_geometry"):
        return "k2_geometry", [
            (f"G={G} NG={NG}", lambda n, ld, sms=kernels.H100_SMS, G=G, NG=NG:
             kpz.chain_geometry(n, G, NG, kpz.k2_smem(ld, NG), sms))
            for G, NG in K2_VARIANTS]
    if name == "pz_matmul_linear" and hasattr(kpz, "k1_geometry"):
        return "k1_geometry", [
            (f"G={G} NG={NG}", lambda t, ld, ldl, n, m, sms=kernels.H100_SMS, G=G, NG=NG:
             kpz.chain_geometry(t, G, NG, kpz.k1_smem(ld, ldl, n, m, NG), sms))
            for G, NG in K1_VARIANTS]
    return None, []


def uncertain_com(captured, robot, cfg, basis, args, obs, dev, out) -> None:
    """The uncertain-COM route at W = 64: the K1 / K2 launches of one
    planning step of the Kinova with com_uncertainty = COM_UNCERTAINTY and of
    its RNEA call on the step's JRS, that call timed (median of 5), and each
    K1 / K2 call shape it makes, and K1's transposed FK product of joint 1,
    timed (median of 20, and its device time) with a digest of its result;
    K1 and K2 also under K1_VARIANTS / K2_VARIANTS where this checkout has
    their geometry functions."""
    from armour_tpu_torch import dynamics, kernels
    from armour_tpu_torch.kernels import pz as kpz
    from armour_tpu_torch.planner import make_batch_planner
    from armour_tpu_torch.pz import bpz
    from armour_tpu_torch.utils.timing import median_ms

    robot_c = dataclasses.replace(robot, com_uncertainty=COM_UNCERTAINTY)
    step_c = make_batch_planner(robot_c, cfg)
    step_c(*args, obs)
    torch.cuda.synchronize()
    kernels.reset_counts()
    step_c(*args, obs)
    torch.cuda.synchronize()
    n_step = {k: v for k, v in kernels.counts().items() if k in ("pz_matmul_linear", "pz_cross")}
    jrs = next(v[0] for k, v in captured.items() if k[0] == "rnea_chain")

    def rnea():
        return dynamics.rnea_pz_sets(jrs, robot_c, cfg, basis)

    kernels.reset_counts()
    with kernels.capture() as ops:
        u = rnea()
    torch.cuda.synchronize()
    n_call = {k: v for k, v in kernels.counts().items() if k in ("pz_matmul_linear", "pz_cross")}
    ms = median_ms(rnea, dev, 5)
    out["uncertain_com"] = {"rnea_ms": ms, "launches_rnea_call": n_call,
                            "launches_planning_step": n_step}
    out["digest"]["uncertain_com rnea_pz_sets"] = digest(u)
    print(f"uncertain-COM route (com_uncertainty {COM_UNCERTAINTY}), W = 64: "
          f"dynamics.rnea_pz_sets {ms:.3f} ms (median of 5); K1 / K2 launches of the call "
          f"{n_call}, of one planning step {n_step}; digest {digest(u)}")
    R = jrs.R
    r0, r1 = (bpz.BPZ(coef=R.coef[:, :, j], egen=R.egen[:, :, j], rad=R.rad[:, :, j])
              for j in (0, 1))
    with kernels.capture() as fk:
        bpz.matmul_linear_right(r0, r1, basis, cfg.float_slop)
    ops.update(fk)
    for (name, key), inputs in ops.items():
        if name == "pz_matmul_linear":
            a, b, bs, slop, tr = inputs

            def fn(a=a, b=b, bs=bs, slop=slop, tr=tr):
                return kpz.matmul_linear(a, b, bs, slop, transpose_out=tr)
        elif name == "pz_cross":
            a, b, bs, slop = inputs

            def fn(a=a, b=b, bs=bs, slop=slop):
                return kpz.cross(a, b, bs, slop)
        else:
            continue
        ms = median_ms(fn, dev, ITERS)
        dev_ms = queued_ms(fn, dev)
        ref = fn()
        out[name][str(key)] = {"event_ms": ms, "device_ms": dev_ms}
        out["digest"][f"{name} {key}"] = digest(ref)
        attr, variants = _variants(name, kpz, kernels)
        if variants:
            default = getattr(kpz, attr)
            try:
                for label, geo in variants:
                    setattr(kpz, attr, geo)
                    got = fn()
                    out["digest"][f"{name} {key} {label}"] = digest(got)
                    if not same_bits(got, ref):
                        fail(f"{name} {key} with {label} differs from the default geometry")
                    if name == "pz_matmul_linear":
                        out[name][str(key)][f"device_ms {label}"] = queued_ms(fn, dev)
            finally:
                setattr(kpz, attr, default)
        note = f"; the same bits under {len(variants)} other geometries" if variants else ""
        if name == "pz_matmul_linear" and variants:
            note += " (device ms: " + ", ".join(
                f"{lb} {out[name][str(key)][f'device_ms {lb}']:.4f}" for lb, _ in variants) + ")"
        print(f"{name} uncertain-COM {key}: {ms:.4f} ms (median of {ITERS}; device "
              f"{dev_ms:.4f} ms a call, queued_ms), digest "
              f"{out['digest'][f'{name} {key}']}{note}")
    for name in ("pz_matmul_linear", "pz_cross"):
        k = out[name].values()
        print(f"{name} over its {len(k)} shapes: {sum(v['event_ms'] for v in k):.4f} ms of "
              f"CUDA-event time (before: {BEFORE_MS[name]} ms), "
              f"{sum(v['device_ms'] for v in k):.4f} ms of device time")


if __name__ == "__main__":
    main()

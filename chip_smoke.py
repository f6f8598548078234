"""Drive the PyTorch/CUDA port through one full planning step on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. environment: card name and power limit, torch/CUDA versions, precision
     flags; build the kernels from csrc/ (one nvcc per source, in parallel).
  2. the main path at the flagship width (Kinova Gen3, T = 128, O = 40,
     K = 4096, float32) over the first 64 saved worlds: one warm-up step that
     records each kernel's inputs, then one step with the launch counters set
     to 0, which must launch every kernel.
  3. every recorded kernel call against its plain PyTorch version on the
     same inputs, on the card, with the tolerances below, and both timed
     (median of 20 calls, CUDA events).
  4. planning-step checks and timings: every feasible k passes the plain
     full-set check on the card; the first 8 worlds through the port on the
     CPU (plain versions) agree on feasibility with at most one flip;
     solves/s at W = 64, the reach-set / solver split, the device time of
     one step by kernel name (torch.profiler), and batch-1 p50/p99 latency
     against the 0.5 s budget.

Prints the card line, one JSON line of per-kernel numbers, and last the
contract line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import glob
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12    # float32 outside the tensor cores
TOL = 1e-5                      # relative to the summed |terms|, float32
N_WORLDS = 64
N_LATENCY = 32
N_CPU = 8
TIMING_ITERS = 20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------


def scenes(robot, cfg, n):
    from armour_tpu_torch.collision import pad_obstacles, stack_obstacles
    from armour_tpu_torch.worlds import load_world_csv, straight_line_waypoint

    paths = sorted(glob.glob("saved_worlds/random/*.csv"))
    if len(paths) < n:
        fail(f"need {n} scenes in saved_worlds/random, found {len(paths)}")
    worlds = [load_world_csv(p) for p in paths[:n]]
    q0 = np.stack([w.start for w in worlds])
    q_des = np.stack([straight_line_waypoint(w.start, w.goal,
                                             continuous=robot.continuous_joints)
                      for w in worlds])
    obs = stack_obstacles([pad_obstacles(w.obstacle_centers, w.obstacle_generators,
                                         cfg.max_obstacles, cfg.dtype) for w in worlds])
    zeros = np.zeros_like(q0)
    return q0, zeros, zeros, q_des, obs


def obs_slice(obs, sl):
    from armour_tpu_torch.collision import ObstacleSet

    return ObstacleSet(centers=obs.centers[sl], generators=obs.generators[sl],
                       mask=obs.mask[sl])


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _bpz_bytes(p) -> int:
    return _nbytes(p.coef, p.egen, p.rad)


def _abs_bpz(p):
    from armour_tpu_torch.pz.bpz import BPZ

    return BPZ(coef=p.coef.abs(), egen=p.egen.abs(), rad=p.rad.abs())


def _rel_ratio(got, ref, mag) -> float:
    """max |got - ref| / (TOL * (mag + 1e-6)) over all entries."""
    return float(((got - ref).abs() / (TOL * (mag.abs() + 1e-6))).max())


def check_pz(name, inputs, dev):
    """K1 / K2: kernel vs plain; magnitudes from the plain version on |inputs|."""
    from armour_tpu_torch.kernels import pz as kpz
    from armour_tpu_torch.pz import bpz

    if name == "pz_matmul_linear":
        a, b, basis, slop, tr = inputs

        def kern():
            return kpz.matmul_linear(a, b, basis, slop, transpose_out=tr)

        def plain(x=a, y=b):
            out = bpz.matmul_linear_plain(x, y, basis, slop)
            return bpz._transpose_mat(out) if tr else out

        mag = plain(_abs_bpz(a), _abs_bpz(b))
        n, m = a.rad.shape[-2:]
        p = b.rad.shape[-1]
        elems = max(a.rad.numel() // (n * m), b.rad.numel() // (m * p))
        B, E, nf = basis.size, a.egen.shape[-1], basis.nf
        flops = elems * (n * p * m * (B * (2 + 2 * nf) + 4 * E + 15)
                         + (n * m + m * p) * (2 * B + E) + 2 * n * p * (B + E))
        out_bytes = elems * n * p * (B + E + 1) * 4
    else:
        a, b, basis, slop = inputs

        def kern():
            return kpz.cross(a, b, basis, slop)

        def plain(x=a, y=b):
            return bpz.cross_plain(x, y, basis, slop)

        mag = bpz.bilinear(_abs_bpz(a), _abs_bpz(b), bpz._cross_abs_t, bpz._cross_abs,
                           basis, slop, absprod_t=bpz._cross_abs_t)
        elems = max(a.rad.numel(), b.rad.numel()) // 3
        B, E = basis.size, a.egen.shape[-1]
        flops = elems * (len(basis.pair_i) * 24 + 3 * E * 6 + 12 * (B + E) + 6 * (B + E))
        out_bytes = elems * 3 * (B + E + 1) * 4
    got, ref = kern(), plain()
    torch.cuda.synchronize(dev)
    ratio = max(_rel_ratio(getattr(got, f), getattr(ref, f), getattr(mag, f))
                for f in ("coef", "egen", "rad"))
    err = max(float((getattr(got, f) - getattr(ref, f)).abs().max())
              for f in ("coef", "egen", "rad"))
    nbytes = _bpz_bytes(a) + _bpz_bytes(b) + out_bytes
    return ratio <= 1.0, err, kern, plain, nbytes, flops, f"worst |d|/tol {ratio:.3g}"


def check_hyperplanes(inputs, dev):
    from armour_tpu_torch import collision as col
    from armour_tpu_torch.kernels import collision as kcol
    from armour_tpu_torch.kinematics import LinkFRS

    shape_gens, radius, centers, gens = inputs
    frs = LinkFRS(center_coef=None, shape_gens=shape_gens, radius=radius)
    obs = col.ObstacleSet(centers=centers, generators=gens, mask=None)

    def kern():
        return kcol.build_hyperplanes(shape_gens, radius, centers, gens)

    def plain():
        return col.build_hyperplanes_plain(frs, obs)

    A, d, delta = kern()
    hp = plain()
    G = col._buffered_generators(frs, obs)                     # [W, 3, 9, N]
    absA = hp.A.abs()
    mag_delta = (absA * G.abs().sum(dim=2)[:, :, None, :]).sum(dim=1)
    T, J = radius.shape[1:3]
    mag_d = (absA * col._cell_centers(obs, T, J).abs()[:, :, None, :]).sum(dim=1)
    torch.cuda.synchronize(dev)
    ok_A = float((A - hp.A).abs().max()) <= TOL and torch.equal(A == 0, hp.A == 0)
    ratio = max(_rel_ratio(d, hp.d, mag_d), _rel_ratio(delta, hp.delta, mag_delta))
    err = max(float((A - hp.A).abs().max()), float((d - hp.d).abs().max()),
              float((delta - hp.delta).abs().max()))
    Wn, N = A.shape[0], A.shape[-1]
    nbytes = _nbytes(shape_gens, radius, centers, gens, A, d, delta)
    flops = Wn * N * 36 * 87
    return (ok_A and ratio <= 1.0), err, kern, plain, nbytes, flops, \
        f"|dA| {float((A - hp.A).abs().max()):.3g}, d/delta worst |d|/tol {ratio:.3g}"


def check_rows(inputs, dev):
    """K4 against the plain rows: g within TOL; dg where the best two
    candidates differ by more than TOL (elsewhere the argmax may flip)."""
    from armour_tpu_torch import collision as col
    from armour_tpu_torch.kernels import collision as kcol

    A, d, delta, row, mask, p_all, dp_all = inputs
    Wn, Q = p_all.shape[:2]
    R, C = A.shape[-1], A.shape[2]

    def kern():
        return kcol.collision_rows(A, d, delta, row, mask, p_all, dp_all)

    if row.dim() == 1:
        # the full-set check: against collision_constraints' plain version
        TJ = p_all.shape[-1]
        O = R // TJ
        hyp = col.Hyperplanes(A=A, d=d, delta=delta, dims=(TJ, 1, O))
        obs = col.ObstacleSet(centers=None, generators=None, mask=mask.reshape(Wn, TJ, O)[:, 0])

        def plain():
            return col.collision_constraints_plain(hyp, obs, p_all).reshape(Wn, Q, R), None
    else:
        sc = col.ScreenedCollision(A=A, d=d, delta=delta, row=row, mask=mask)

        def plain():
            return col.screened_rows_plain(sc, p_all, dp_all)

    g, dg = kern()
    g0, dg0 = plain()
    ok = float((g - g0).abs().max()) <= TOL
    err = float((g - g0).abs().max())
    note = f"|dg| {err:.3g}"
    if dp_all is not None:
        # the best two candidates of every row, from the plain arithmetic
        p = col._rows_at(p_all, row)
        Ap = col._dot3(A[:, None], p[:, :, :, None, :], 2)
        okn = (A.abs().sum(dim=1) > 0)[:, None]
        big = torch.full_like(Ap, -col.BIG)
        both = torch.cat([torch.where(okn, Ap - (d + delta)[:, None], big),
                          torch.where(okn, -Ap - (-d + delta)[:, None], big)], dim=-2)
        top2 = torch.topk(both, 2, dim=-2).values
        clear = (top2[:, :, 0] - top2[:, :, 1]) > TOL                  # [W, Q, R]
        dp = col._rows_at(dp_all, row)                                 # [W, Q, 3, F, R]
        mag = (dp.abs().sum(dim=2)).transpose(-1, -2)                  # |A_a| <= 1
        ratio = float(((dg - dg0).abs() / (TOL * (mag + 1e-6)))[clear].max()) \
            if bool(clear.any()) else 0.0
        ok = ok and ratio <= 1.0
        err = max(err, float((dg - dg0)[clear].abs().max()) if bool(clear.any()) else 0.0)
        note += f", dg worst |d|/tol {ratio:.3g} on {int(clear.sum())}/{clear.numel()} clear rows"
    torch.cuda.synchronize(dev)
    F = dp_all.shape[3] if dp_all is not None else 0
    nbytes = _nbytes(A, d, delta, row, mask, p_all, dp_all, g, dg)
    flops = Wn * Q * R * (C * 16 + 6 * F)
    return ok, err, kern, plain, nbytes, flops, note


REPLACES = {
    "pz_matmul_linear": ("armour_tpu_torch/csrc/pz_matmul_linear.cu", "armour_tpu/pz/bpz.py:214"),
    "pz_cross": ("armour_tpu_torch/csrc/pz_cross.cu", "armour_tpu/pz/bpz.py:120"),
    "build_hyperplanes": ("armour_tpu_torch/csrc/build_hyperplanes.cu", "armour_tpu/collision.py:99"),
    "collision_rows": ("armour_tpu_torch/csrc/collision_rows.cu", "armour_tpu/collision.py:255"),
}


def kernel_phase(captured, launches, dev):
    from armour_tpu_torch.kernels import KERNELS
    from armour_tpu_torch.utils.timing import median_ms

    rows = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0, "err": 0.0, "calls": 0}
            for k in KERNELS}
    all_ok = True
    for (name, key), inputs in captured.items():
        if name in ("pz_matmul_linear", "pz_cross"):
            res = check_pz(name, inputs, dev)
        elif name == "build_hyperplanes":
            res = check_hyperplanes(inputs, dev)
        else:
            res = check_rows(inputs, dev)
        ok, err, kern, plain, nbytes, flops, note = res
        ms = median_ms(kern, dev, TIMING_ITERS)
        pms = median_ms(plain, dev, TIMING_ITERS)
        r = rows[name]
        r["ms"] += ms
        r["plain_ms"] += pms
        r["bytes"] += nbytes
        r["flops"] += flops
        r["err"] = max(r["err"], err)
        r["calls"] += 1
        print(f"  {name} {key}: {'ok' if ok else 'MISMATCH'} ({note}); "
              f"kernel {ms:.4f} ms, plain {pms:.4f} ms, {nbytes / 1e6:.1f} MB")
        all_ok &= ok
    out = []
    for name in KERNELS:
        r = rows[name]
        if r["calls"] == 0:
            fail(f"kernel {name} was never called on the main path")
        t_bytes = r["bytes"] / H100_BYTES_PER_S * 1e3
        t_ops = r["flops"] / H100_FP32_FLOP_PER_S * 1e3
        src, rep = REPLACES[name]
        out.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                    "launches": launches[name], "max_abs_err": r["err"],
                    "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": None, "variants": r["calls"]})
    if not all_ok:
        fail("a kernel disagrees with its plain version")
    return out


def profile_step(fn, dev, step_s) -> dict:
    """Device time of one call of fn by kernel name (torch.profiler's
    device-side events only: the host-side operator events carry the same
    time again), the hand kernels' share, the number of device activities
    (kernels, copies, fills), and the device busy share of the unprofiled
    step time step_s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  reverse=True)
    total = sum(r[0] for r in rows)
    if total == 0:
        print("  profiler: no device time recorded (not measured)")
        return {}
    hand = {name: sum(r[0] for r in rows if r[2].startswith(f"{k}_kernel"))
            for name, k in zip(("pz_matmul_linear", "pz_cross", "build_hyperplanes",
                                "collision_rows"), ("k1", "k2", "k3", "k4"))}
    launches = sum(r[1] for r in rows)
    print(f"  profiler: device time {total:.1f} ms in {launches} device activities of one "
          f"W={N_WORLDS} step ({len(rows)} names); top by device time:")
    for ms, n, key in rows[:12]:
        print(f"    {ms:9.3f} ms  x{n:5d}  {key[:90]}")
    print("  hand kernels: " + ", ".join(f"{k} {v:.3f} ms" for k, v in hand.items()))
    return {"device_ms": total, "hand_kernel_ms": sum(hand.values()),
            "device_busy_share": total / (step_s * 1e3), "device_activities": launches}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs the card")
    import armour_tpu_torch  # noqa: F401  (precision pins)
    from armour_tpu_torch import kernels, nlp
    from armour_tpu_torch.collision import ObstacleSet, collision_constraints_plain
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.kernels.build import build_all
    from armour_tpu_torch.models.kinova import kinova_gen3
    from armour_tpu_torch.planner import (make_batch_planner, make_planner,
                                          plan_problem)
    from armour_tpu_torch.pz.basis import make_basis
    from armour_tpu_torch.utils.timing import sync, wall_s

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"precision: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        fail("TF32 is not off")

    t0 = time.perf_counter()
    reports = build_all()
    print(f"phase 1: built {len(reports)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    robot = kinova_gen3()
    cfg = ArmourConfig(dtype=torch.float32)
    basis = make_basis(robot.num_factors, cfg.max_poly_degree)
    q0, qd0, qdd0, q_des, obs = scenes(robot, cfg, N_WORLDS)
    step64 = make_batch_planner(robot, cfg)

    # ---- phase 2: the main path, counted ----
    with kernels.capture() as captured:
        t_first, _ = wall_s(lambda: step64(q0, qd0, qdd0, q_des, obs), dev)
    kernels.reset_counts()
    t_main, res = wall_s(lambda: step64(q0, qd0, qdd0, q_des, obs), dev)
    launches = kernels.counts()
    print(f"phase 2: W={N_WORLDS} planning step {t_main * 1e3:.1f} ms "
          f"(first call {t_first * 1e3:.1f} ms); launches {launches}")
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} was not launched on the main path")

    # ---- phase 3: kernels against their plain versions ----
    print(f"phase 3: {len(captured)} recorded kernel calls against their plain versions")
    krows = kernel_phase(captured, launches, dev)
    captured.clear()

    # ---- phase 4: results and timings ----
    k = res.k
    feas = res.feasible
    if k.shape != (N_WORLDS, robot.num_factors) or feas.shape != (N_WORLDS,):
        fail(f"unexpected result shapes {tuple(k.shape)} {tuple(feas.shape)}")
    kf = k[feas]
    if not bool(torch.isfinite(kf).all()) or bool((kf.abs() > 1.0 + 1e-6).any()):
        fail("a feasible k is not finite or leaves [-1, 1]")
    if bool(torch.isfinite(k[~feas]).any()):
        fail("an infeasible world returned a finite k")
    n_feas = int(feas.sum())
    args_dev = [torch.as_tensor(x, dtype=cfg.dtype).to(dev) for x in (q0, qd0, qdd0, q_des)]
    obs_dev = ObstacleSet(centers=obs.centers.to(dev), generators=obs.generators.to(dev),
                          mask=obs.mask.to(dev))
    prob = plan_problem(*args_dev, obs_dev, robot, cfg, basis)
    k_chk = torch.where(feas[:, None], k, torch.zeros_like(k))[:, None]
    v = torch.stack(nlp.max_violations(k_chk, prob, cfg, basis,
                                       collision_fn=collision_constraints_plain), dim=-1)[:, 0]
    cert = nlp.viol_feasible(v, cfg)
    if not bool(cert[feas].all()):
        fail(f"plain full-set check rejects feasible worlds "
             f"{torch.nonzero(feas & ~cert).flatten().tolist()}")
    print(f"phase 4: {n_feas}/{N_WORLDS} worlds feasible; every feasible k passes the plain "
          f"full-set check (max collision violation {float(v[feas][:, 1].max()) if n_feas else float('nan'):.3g})")
    del prob

    step_cpu = make_batch_planner(robot, cfg, device="cpu")
    t_cpu, res_cpu = wall_s(lambda: step_cpu(q0[:N_CPU], qd0[:N_CPU], qdd0[:N_CPU],
                                             q_des[:N_CPU], obs_slice(obs, slice(0, N_CPU))),
                            "cpu")
    gpu_v = feas[:N_CPU].cpu().tolist()
    cpu_v = res_cpu.feasible.tolist()
    flips = sum(a != b for a, b in zip(gpu_v, cpu_v))
    print(f"  first {N_CPU} worlds feasible: card {gpu_v}, CPU plain {cpu_v} "
          f"({flips} differ; CPU step {t_cpu:.1f} s)")
    if flips > 1:
        fail("card and CPU verdicts differ on more than one world")

    # throughput at W = 64 and the reach-set / solver split
    t_steps = [wall_s(lambda: step64(q0, qd0, qdd0, q_des, obs), dev)[0] for _ in range(3)]
    t_step = statistics.median(t_steps)
    t_rs = statistics.median(
        [wall_s(lambda: plan_problem(*args_dev, obs_dev, robot, cfg, basis), dev)[0]
         for _ in range(3)])

    # where the device time of one W = 64 step goes, by kernel name
    breakdown = profile_step(lambda: step64(q0, qd0, qdd0, q_des, obs), dev, t_step)

    # batch-1 latency over the first N_LATENCY worlds
    step1 = make_planner(robot, cfg)
    one = [(q0[i], qd0[i], qdd0[i], q_des[i], obs_slice(obs, i)) for i in range(N_LATENCY)]
    wall_s(lambda: step1(*one[0]), dev)
    lats = [wall_s(lambda a=a: step1(*a), dev)[0] for a in one]
    p50, p99 = float(np.percentile(lats, 50)), float(np.percentile(lats, 99))
    sync(dev)

    perf = {"card": card, "worlds": N_WORLDS, "feasible": n_feas,
            "solves_per_s": N_WORLDS / t_step, "step_ms": t_step * 1e3,
            "reachset_ms": t_rs * 1e3, "solver_ms": (t_step - t_rs) * 1e3,
            "latency_batch1_p50_ms": p50 * 1e3, "latency_batch1_p99_ms": p99 * 1e3,
            "budget_ms": 500.0, "realtime_ok": p99 < 0.5,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9, **breakdown}
    print("planning: " + json.dumps(perf))
    print(card)
    print(json.dumps({"kernels": krows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

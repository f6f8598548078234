"""Drive the PyTorch/CUDA port on the card: one full planning step, three
iterations of the lockstep closed loop, a rescue-profile solve, the
real-time planner, the containment of sampled true states in the chain
kernels' sets, the two entry points plan_from_armour_in and the rest-FRS
solvability checker, three iterations of a hard scenario, the ARMTD
(constant-acceleration) trajectory family end to end, the grasp path
(the Kinova with the dumbbell payload, contact rows on) with a step of
every zoo robot, the closed loop of the grasp path and of the zoo
(the tray trial, the dumbbell at the full width, every zoo robot), and the
smooth collision mode (cfg.smooth_obstacle_constraints).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. environment: card name and power limit, torch/CUDA versions, precision
     flags; build the sixteen kernels from csrc/ (one nvcc per source, in parallel)
     and print the nvcc flags, every kernel's registers, spills, stack frame
     and static shared memory (ptxas) and K7's / K8's / K9's / K10's dynamic
     shared memory a block.
  2. the main path at the flagship width (Kinova Gen3, T = 128, O = 40,
     K = 4096, float32) over the first 64 saved worlds: one warm-up step that
     records each kernel's inputs, then one step with the launch counters set
     to 0, which must launch every kernel of the step (K12, K13, K4, K7,
     K8, K14, the reach-set chains K9, K10 and their assembly K15; K12, K13
     and K15 once, K14 at most twice: its cull and selection, its other
     phases run in K7's / K8's finish, counted apart) and neither K1, K2
     nor K3 (K13 and K4's cell mode form the rows they need from the
     cells: no planning path makes the [W, 3, 36, N] hyperplane tensors;
     every counted path below is held to that too); prints K14's launches
     and the solve's host launcher calls.
  3. every recorded kernel call against its plain PyTorch version on the
     same inputs, on the card, with the tolerances below, and both timed
     (median of 20 calls, CUDA events); K7, K8, K9 and K10 also run twice
     and must give the same bits, K9, K1 and K2 also under other launch
     geometries (the same bits again), and K1, K2, K7-K10 and K13 are
     printed beside their earlier times (PERF.md's kernel history).  K7 / K8 (the solver's
     rows) on every shape of the step: seeds 4 -> 2, line search S x 3; their
     cost output bit for bit against plan_cost; K8's max mode (the full-set
     check's torque and state maxima) with the state maxima bit for bit; K14
     (the solve loop's bookkeeping) on every phase and shape bit for bit
     against its plain version, and again on a second call (a phase run in
     a K7 / K8 finish through that row pass, against the pass alone then the
     plain phase; its time the pass with it less the pass alone); K13 (passed the
     cells, never K3's hyperplane tensors) against the plain screen of K3's
     hyperplanes of the same cells bit for bit, also at quota 8 and on
     planted ties; K3 by a direct call on the step's cells (no step
     launches it); K4's cell mode (the full-set check) bit for bit against
     K4's row mode (G = 1) over K3's tensors of the same cells and within
     the tolerance of the plain check; K15 bit for bit, twice, its
     outputs' views checked, and
     its launch geometry printed (kernels/reach.py:k15_geometry).  K1
     / K2, which the Kinova's step does not launch, on their own path: one
     W = 64 planning step of the Kinova with com_uncertainty = 0.05 (the
     uncertain-COM route of the PZ RNEA, through the op-level kernels),
     driven with the launch counters set to 0 just before it and read just
     after, which must launch both and K15 once (K15 checked there on the
     K1 / K2 route's torque); their calls recorded there, plus the FK
     rotation product of joint 1 formed from the step's JRS (not counted).
  4. planning-step checks and timings: every feasible k passes the plain
     full-set check on the card; the fused solve (K7 / K8 / K14) against the
     eager solve (K7 / K8 and the plain bookkeeping: k, feasible, cost and
     viol bit for bit, also from one start k0, whose K7 / K8 / K14 calls are
     held against their plain versions) and the plain solve (same feasible
     count, its feasible k certified by the plain full-set check, max
     |d cost|), each timed; the fused and the eager solve profiled (device
     activities by name, busy share), and the fused solve's activities from
     its first K8 call to the full-set check must all be K7 / K8 and K14's
     cull, but the cull's violation sum, with at most two K14 launches in
     the solve; K14's device time in the solve (its launches, and the fused
     less the eager solve's K7 / K8 finish kernels);
     the first 8 worlds through the port on the CPU (plain versions) agree
     on feasibility with at most one flip; solves/s at W = 64, the reach-set
     / solver split (reachset_ms), the device time of one step by kernel
     name, its device activities and busy share (torch.profiler), the reach
     sets' device activities (only K15 and the screen's envelope, torch's
     abs and sum, between K10 and K13, no K3), K13's
     and K15's event time, device time and bound; K4's two modes: the cell
     mode's event time, device time in the step and bound, and the screened
     rows of one plain solve (hard mode) against their plain versions and
     their G = 1 instantiation bit for bit, with event time, device time and
     bound; the step's peak device memory; batch-1 p50/p99 latency at the
     full profile against the 0.5 s budget.
  5. the closed loop at the flagship width: run_trials_batched over the same
     64 worlds, 3 iterations, straight-line guidance with the rescue solver,
     worst-case true parameters, seed 0, the launch counters set to 0 just
     before it; every kernel of the step (K12 and K13 included) must launch,
     K5 (rollout) and K6 (oracle_check) once per iteration, and no world
     may raise a safety flag.  Per iteration: plan,
     rescue, rollout (K5), oracles (K6) and the host time left over.
  6. K5 and K6 against their plain versions on the inputs recorded in phase
     5 (the first move: 500 control steps of 64 worlds), with the tolerances
     below.  K5 also on the move's first 100 steps with the Althoff and the
     nominal controller and with seeded measurement noise; K6 also on four
     copies of the move, each with one planted fault (obstacles on the
     links, torque, ultimate bound, joint limit) in every other world, whose
     plain flag must fire there and nowhere else.  K5 runs twice on every
     one of its four inputs and must give the same bits; K5 and K6 are
     printed beside their earlier times, K6's CUDA-event time beside its
     device time (calls queued behind busy work, chip_probe.queued_ms).
     Kernels timed as
     CUDA-event medians of 20, the plain K5 (a launch-bound Python loop of
     ~2M small launches) over one call.
  7. one plan at the rescue profile (strong_config: 8 x 6 iterations, seeds
     4 -> 2, 4 alphas) over the 64 worlds, counted; K7 / K8 / K14, K9 / K10
     and K12 / K13 / K15 against their plain versions at its shapes, all timed.
  8. the real-time planner: make_realtime_planner calibrates on the card
     (its calibration printed), then batch-1 p50/p99 through the calibrated
     step over the first 32 worlds, counted (every kernel of the step must
     launch); K7 / K8 / K14, K9 / K10 and K12 / K13 / K15 against their plain
     versions at the W = 1 shapes, all timed.
  9. containment: for the first 8 worlds of the step, 64 sampled k per world
     at a sampled time inside each of the 128 sub-intervals: every numeric
     link centre inside K9's sliced link hull and inside its centre set
     (shape generators at 0), every numeric nominal torque inside K10's
     sliced nominal band; the worst margins printed.
  10. the entry points: plan_from_armour_in on the card for an armour.in
     written from the first reference scene (the five files in the
     reference layouts, their contents equal to the plain route on the
     card, its wall time); make_rest_frs_checker on the card over the
     starts and goals of the 64 worlds and a planted box on a start elbow
     (every margin's sign equal to the plain route's, the planted one > 0).
  11. a hard scenario: experiments.run_hard_world (the per-world function
     of the "hard" mode, scripts/run_hard_scenarios.py's settings) on hard_7
     (reach through a window) for 3 iterations, the launch counters set to 0
     just before it; every kernel of the step, K5 and K6 must launch, K1 and
     K2 not, and no safety flag may be raised.
  12. the ARMTD family (cfg.traj_family = "armtd") over the same 64 worlds
     with start velocities seeded uniform in +-ARMTD_QD0 rad/s: one warm-up
     step that records each kernel's inputs, then one step with the launch
     counters set to 0 just before it and read just after, which must
     launch K11 (jrs_armtd) once and K4, K7, K8, K9, K10, K13, K14, K15,
     and neither K1, K2, K3 nor K12; every recorded call (K11, K4, K13, K15, K7 /
     K8's ARMTD branch and K14 on every shape, K9 / K10 on the ARMTD sets)
     against its plain version
     with the tolerances above, each kernel twice for the same bits, all
     timed; every feasible k passes the plain full-set check; phase 4's
     fused / eager / plain solve comparison and profiles on the ARMTD plan;
     the step beside phase 4's Bernstein step, profiled, its reach sets'
     window from K10 to K13 (K15 alone; K3 on the step's cells directly); phase
     9's containment on the ARMTD sets (65,536 sampled states); three
     closed-loop iterations with rescue (K11, K5, K6 launched, no safety
     flag); batch-1 p50 / p99.
  13. the grasp path: the Kinova with the dumbbell payload (zoo
     kinova_dumbbell: J = 9 bodies, F = 7 factors) at the full width (T =
     128, O = 40, K = 4096) over the same 64 worlds at rest, its ultimate
     bound derived at V_max = 5e-4 (tests/test_grasp.py:170), cfg.
     grasp_constraints on with the permissive contact parameters (mu 1.5,
     r 0.5): one warm-up step that records each kernel's inputs, then one
     step with the launch counters set to 0 just before it and read just
     after, which must launch K12, K9, K10 (torque and wrench), K15, K16,
     K13 once and K4, K7, K8, K14, and neither K1, K2 nor K3; every
     recorded call against its plain version (K16 and K15 bit for bit, K12's
     velocity PZs and R bit for bit, K9 / K10 / K7 / K8 within the
     tolerances above, K14 bit for bit), timed; every feasible k passes
     the plain full-set check, v_grasp included; the constraint groups
     over their thresholds in the infeasible worlds, and the same step's
     feasible count without grasp rows; the step's wall time, its
     device time, activities and busy share, K16's event and device time
     and bound, K15's and K16's launch geometries (k15_geometry,
     kernels/grasp.py:k16_geometry), the reach sets' window from K10 to K13
     (K15 and K16 alone);
     the same step with the tight contact parameters (1e-4, 1e-4), which
     must leave every world infeasible (NaN k); then a W = 8 step of every
     zoo robot (the UR5 with F = 6 included), counted, the first call of
     each kernel and shape in it against its plain version (K7 / K8 at F =
     6, K9 / K10 at F < J), its verdicts against the same step through the
     port on the CPU (at most one flip), each feasible k certified by the plain full-set check,
     the groups over their thresholds printed for the infeasible worlds,
     and the step again with the torque rows off (the JAX package's zoo
     test's setting), its feasible k certified too.
  14. the closed loop at J = 9 and F < J, K5 and K6 on the dumbbell's nine
     bodies: (i) the tray trial of tests/test_grasp.py:194-227 through
     simulator.run_trial on the card (T = 16, O = 8, K = 256, V_max 5e-4,
     contact (1.5, 0.5), worst-case true parameters from rng 0, 8
     iterations), which must reach its goal with no safety flag; (ii) the
     dumbbell's closed loop over phase 13's 64 scenes at the full width with
     grasp rows, as phase 5 runs the flagship's (3 lockstep iterations,
     straight guidance with rescue, worst-case true parameters), every
     kernel of the grasp step, K5 and K6 counted, its K5 / K6 calls held
     against their plain versions as in phase 6 (the whole move and its
     three 100-step variants; K6 also on the planted copies), timed, with
     K5's bound: the dumbbell's numbers in the K5 / K6 rows of the kernels
     line; (iii) a W = 8 closed loop of every zoo robot for 2 iterations
     (phase 13's postures and scenes, a goal 0.2 rad a joint away; K5 / K6
     at F < J on the Fetch arm and the dumbbell, at F = 6 on the UR5; the
     worst-case true parameters on the robots whose ultimate bound is
     certified, the nominal ones on the others, which leave their bound
     under model error in both packages: tests/test_torch_zoo.py's
     test_holding_still_under_model_error_matches_jax), with the worlds
     that moved and the feasible plans printed.  In (i)-(iii) the first
     K5 / K6 call of each shape is held against its plain version (the
     later iterations' calls are counted, not compared).  No world may
     raise a safety flag, and K5 and K6 launch once an iteration.
  15. the smooth collision mode (cfg.smooth_obstacle_constraints, smooth_tau
     = SMOOTH_TAU: K4's screened rows and K7 / K8 take the log-sum-exp of
     armour_tpu/collision.py:277-290; the full-set check stays exact):
     (i) a W = 64 Bernstein step over phase 2's worlds, a warm-up step that
     records each kernel's inputs, then one counted step (K12, K13, K4,
     K7, K8, K14, K9, K10, K15, neither K1 nor K2); the recorded K7 / K8 /
     K14 calls and a plain solve's K4 calls (its smooth screened rows, and
     the exact full-set check) against their plain versions at phase 3's
     tolerances, each twice for the same bits (K14 bit for bit), timed,
     with their bound (bytes, or float32 operations and the expf / logf
     over the special-function rate, H100_SFU_PER_S); every feasible k
     certified by the plain exact full-set check; phase 4's solve
     comparison (fused against eager bit for bit, against plain the same
     feasible count); the feasible count beside phase 4's, the step's wall
     time, device time, activities and busy share, K4 / K7 / K8's event and
     device times beside phases 3 / 4's; the first 8 worlds through the port
     on the CPU (at most one flip); (ii) the same checks, untimed (phase
     4's solve comparison too), on phase 12's ARMTD step, phase 13's
     dumbbell grasp step under (1.5, 0.5) and a W = 8 UR5 step (F = 6);
     (iii) phase 7 (the rescue profile's solve, strong_config keeps the
     mode) and phase 8 (make_realtime_planner's calibration, batch-1 p50 /
     p99 over the first 32 worlds) in the smooth mode, and
     make_rescue_planner batch-1 on the first 8 worlds, each recorded call
     held against its plain version; (iv) phase 5's closed loop in the
     smooth mode (3 iterations, rescue): no safety flag.  The smooth
     shapes' numbers go into the kernels line's K4 / K7 / K8 entries
     (smooth_w64; K4's launches and device time: one plain solve's, where
     its smooth rows run).
  16. the harness: (i) the serial suite (experiments.run_world_suite: one
     world at a time at batch 1, the rescue planner, worst-case true
     parameters) over the first HARNESS_WORLDS saved worlds, at most
     HARNESS_ITERATIONS iterations, counted (every kernel of the step, K5
     and K6 once an iteration, no safety flag), with its per-iteration plan
     / move / oracle times, its first K5 / K6 / K7-K15 call of each shape
     against the plain versions; then a call that resumes from the first
     two worlds' records, whose planners never see a reloaded world and
     whose summaries equal the fresh run's; (ii) the batched suite on the
     same worlds, again with world 0's record dropped: only world 0 runs,
     keeping its bucket and iterations; (iii) a traced trial
     (run_trial(trace_path=)) of world 0: the JAX writer's keys, q rows equal
     to K5's logs every 10 steps, the serial suite's summary; (iv) the
     controller sweep (7 levels x 3 controllers x 32 samples, float32) on
     K5, counted, one (level, controller) against rollout_plain, every entry
     printed beside results_controller_sweep.json (the JAX package's
     float32 run) with the largest relative difference, not gated; (v) the
     first flagship world's JRS (K12) -> FK (K9) against oracle_fk at three
     time indices and its nominal RNEA (K10) against oracle_rnea (threshold
     1e-5) at one, the float64 sparse oracle on the card's JRS: K9's
     k-coefficients within ORACLE_COEF_TOL and its radii at least the
     oracle's less ORACLE_SLACK; K10's sliced centres within ORACLE_TAU_TOL,
     its radii at least the oracle's less ORACLE_TAU_TOL (the radius ratios
     printed).

Prints the card line, one JSON line of per-kernel numbers, and last the
contract line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import functools
import glob
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12    # float32 outside the tensor cores
# expf / logf: one special-function (MUFU) result each, 16 a clock per SM
# (CUDA C++ Programming Guide, arithmetic instruction throughput, compute
# capability 9.0), 132 SMs at the 1,980 MHz boost clock of the 67 TFLOP/s
H100_SFU_PER_S = 132 * 16 * 1.98e9
TOL = 1e-5                      # relative to the summed |terms|, float32
N_WORLDS = 64
N_LATENCY = 32
N_CPU = 8
TIMING_ITERS = 20
LOOP_ITERATIONS = 3
K5_TOL_Q = 1e-4      # rad, max |dq| over the move's log rows and final state
K5_TOL_QD = 1e-3     # rad/s
K5_TOL_U = 1e-4      # relative: |du| <= K5_TOL_U * (|u| + 1)
K6_MARGIN = 1e-5     # m: an overlap whose deciding SAT margin is this close may flip
K5_VARIANT_STEPS = 100  # control steps of the Althoff / nominal / noise comparisons
ALM_TOL = 1e-4       # K7 / K8: g, H, step (backward error), m0, merit, relative to |terms|
ALM_C_TOL = 1e-5     # K8 rows: |dc| <= ALM_C_TOL (1 + |c| + torque terms); a query with a
                     # row this close to its threshold may flip its feasibility
N_CONTAIN = 8        # worlds of the containment phase
N_K = 64             # sampled k per world there (one sampled time per sub-interval each)
CONTAIN_SLACK = 1e-9  # m / Nm: the float64 slicing of the float32 sets
ENTRY_TOL = 1e-5     # relative (1 + |value|): the dump files against the plain route
PROFILE_TRIES = 3    # profiles taken while one lacks an activity that its launch counters say ran
ALM_TIE = 1e-5       # an active collision row whose best two candidates are this close
                     # may take the other normal: its (world, seed) is left out of g, H, step
# the kernels' times before their current designs (PERF.md's kernel history; NVIDIA H100
# 80GB HBM3, 700 W), printed beside this run's: ms summed over the step's call shapes
BEFORE_MS = {"alm_values": "1.464 (6 shapes)", "alm_newton": "2.138 (2 shapes)",
             "screen_collision": "1.403 event, 1.264 device, bound 0.550 (read K3's tensors)",
             "fk_chain": "3.417", "rnea_chain": "7.154", "rollout": "101.253",
             "oracle_check": "0.259", "pz_cross": "2.073 (4 shapes)",
             "pz_matmul_linear": "2.295 (3 shapes)",
             "jrs_bernstein": "0.332 event, 0.254 device (a block per slab, 4-byte rows)",
             "alm_loop": "0.944 over 13 shapes, 39 launches a step, 0.187 device",
             "reach_assembly": "0.1468 event, 0.0729 device (a block per (world, step), "
                               "4-byte loads)",
             "grasp_rows": "0.1462 event, 0.1025 device (pz_ops.cuh's pz_mul, loads unhidden)"}
BEFORE_MS_OTHER = {("rnea_chain", "rescue profile"): "7.168",
                   ("fk_chain", "rescue profile"): "3.814",
                   ("rnea_chain", "real-time path (W = 1)"): "0.440",
                   ("fk_chain", "real-time path (W = 1)"): "0.375"}
# K9 under other launch geometries (threads per element, elements per block,
# blocks): each must give the default geometry's bits
K9_GEOMETRIES = ((32, 4, 132), (64, 2, 264), (256, 1, 528), (32, 8, 17))
# K1 and K2 likewise (a group of three warps takes a component each in K2)
OP_GEOMETRIES = ((32, 4, 132), (64, 2, 264), (96, 2, 100), (256, 1, 528), (32, 8, 17))
HARD_WORLD, HARD_ITERATIONS = 7, 3   # phase 11
ARMTD_QD0 = 0.6      # rad/s: phase 12's start velocities, seeded uniform in +-ARMTD_QD0
ARMTD_SEED = 12
ARMTD_ITERATIONS = 3
COM_UNCERTAINTY = 0.05   # the uncertain-COM route (tests/test_torch_reachsets.py)
GRASP_V_MAX = 5e-4       # phase 13: the dumbbell's V_max (tests/test_grasp.py:170)
GRASP_PERMISSIVE = (1.5, 0.5)   # (mu, support radius), tests/test_grasp.py:175
GRASP_TIGHT = (1e-4, 1e-4)      # tests/test_grasp.py:178
N_ZOO = 8                # worlds of each zoo robot's step in phase 13
TRAY_ITERATIONS = 8      # phase 14 (i): tests/test_grasp.py:221
ZOO_LOOP_ITERATIONS = 2  # phase 14 (iii): each zoo robot's closed loop at W = N_ZOO
ZOO_GOAL_STEP = 0.2      # rad per joint from each zoo start to its goal there
ZOO_MOVED = 1e-3         # rad: a phase 14 (iii) world moved if a joint went further
SMOOTH_TAU = 0.01        # phase 15: cfg.smooth_tau, m (the JAX package's default)
HARNESS_WORLDS = 4       # phase 16: the first saved worlds of the serial and batched suites
HARNESS_ITERATIONS = 30  # and their iteration cap there
SWEEP_CHECKED = (0.3, "robust")   # phase 16 (iv): the (level, controller) held against plain
SWEEP_FILE = "results_controller_sweep.json"   # the JAX package's float32 sweep
SWEEP_FINDING = 1e-3     # a larger relative difference from that file is a finding to bisect
ORACLE_TIMES = (0, 64, 127)   # phase 16 (v): the time indices of the FK comparison
ORACLE_RNEA_T = 64       # and of the RNEA comparison
ORACLE_THRESHOLD = 1e-5  # oracle_rnea's pruning (tests/test_pipeline_reachsets.py:186)
ORACLE_COEF_TOL = 1e-5   # m: K9's float32 k-coefficients against the float64 oracle's
ORACLE_SLACK = 1e-5      # m: K9's radii may fall this far below the oracle's
ORACLE_TAU_TOL = 1e-3    # Nm: K10's sliced centres against the oracle's, and how far its
#                          radii may fall below the oracle's
# the replay trace's keys, as armour_tpu/simulator.py:459-477 writes them
TRACE_KEYS = ("q", "qd", "u", "q_des", "qd_des", "k", "waypoint", "feasible", "start",
              "goal", "obstacle_centers", "obstacle_generators", "trace_dt", "robot_name",
              "flags")


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
        # rad's terms include both operands of the overflow
        # max(absprod(Sa, Sb) - in_abs, 0), which cancel in mag: when every
        # pair is in the basis (a constant operand, the uncertain COM) the
        # overflow is the rounding of two sums of ~Sa Sb taken in different
        # orders
        mag.rad = mag.rad + 2.0 * bpz._cross_abs(a.coef.abs().sum(-1), b.coef.abs().sum(-1))
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


def check_cells(inputs, dev):
    """K4's cell mode (the full-set check formed from the cells) against
    K4's row mode (G = 1) over K3's tensors of the same cells, bit for bit
    (NaN at the same places), and within TOL against its plain version,
    collision_constraints_plain over build_hyperplanes_plain of the cells:
    the error and the plain time reported are that plain version's."""
    from armour_tpu_torch import collision as col
    from armour_tpu_torch.kernels import collision as kcol
    from armour_tpu_torch.kinematics import LinkFRS

    shape_gens, radius, centers, gens, obs_mask, p_all = inputs
    Wn, Q = p_all.shape[:2]
    T, J = radius.shape[1:3]
    O = obs_mask.shape[1]
    N = T * J * O

    def kern():
        return kcol.collision_cells(shape_gens, radius, centers, gens, obs_mask, p_all)

    A, d, delta = kcol.build_hyperplanes(shape_gens, radius, centers, gens)
    obs = col.ObstacleSet(centers=centers, generators=gens, mask=obs_mask)
    frs = LinkFRS(center_coef=None, shape_gens=shape_gens, radius=radius)
    row = (torch.arange(N, device=dev) // O).to(torch.int32)
    mask = col._cell_mask(obs, T, J).contiguous()

    def plain():
        hyp = col.build_hyperplanes_plain(frs, obs)
        return col.collision_constraints_plain(hyp, obs, p_all).reshape(Wn, Q, N)

    g, again = kern(), kern()
    rows, _ = kcol._collision_rows(A, d, delta, row, mask, p_all, None, 0.0, 1)
    g0 = plain()
    exact = _bits(g, rows) and _bits(g, again)
    fin = torch.isfinite(g0)
    err = float((g - g0)[fin].abs().max()) if bool(fin.any()) else 0.0
    nan_ok = torch.equal(torch.isnan(g), torch.isnan(g0))
    torch.cuda.synchronize(dev)
    real = int(obs_mask.sum())
    cells = int((obs_mask.sum(1) > 0).sum()) * T * J
    nbytes = _nbytes(shape_gens, radius, centers, gens, obs_mask, p_all, g)
    flops = k4_cell_operations(cells, real, real * T * J, Q)
    return exact and nan_ok and err <= TOL, err, kern, plain, nbytes, flops, \
        (f"cell mode, G = {kcol.k4_group(Q)}: {'bit for bit' if exact else 'NOT bit for bit'} "
         f"K4's row mode (G = 1) over K3's tensors of the same cells, the same bits on a second "
         f"call; |dg| {err:.3g} against the plain check over the plain hyperplanes, "
         f"{int((~fin).sum())} rows NaN in it "
         f"({'the same' if nan_ok else 'NOT the same'} in the kernel); {real * T * J} real rows "
         f"of {Wn * N}, no hyperplane tensor passed")


def check_rows(inputs, dev):
    """K4 against the plain rows: g within TOL; dg where the best two
    candidates differ by more than TOL (elsewhere the argmax may flip); in
    the smooth mode (no argmax) dg on every row.  The screened rows also
    against the G = 1 instantiation bit for bit (the launch takes
    k4_group(Q) queries a thread).  A cell-mode call goes to check_cells."""
    from armour_tpu_torch import collision as col
    from armour_tpu_torch.kernels import collision as kcol

    if len(inputs) == 6:
        return check_cells(inputs, dev)
    A, d, delta, row, mask, p_all, dp_all, tau = inputs
    Wn, Q = p_all.shape[:2]
    R, C = A.shape[-1], A.shape[2]

    def kern(G=kcol.k4_group(Q)):
        return kcol._collision_rows(A, d, delta, row, mask, p_all, dp_all, tau, G)

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
            return col.screened_rows_plain(sc, p_all, dp_all, smooth_tau=tau)

    g, dg = kern()
    g0, dg0 = plain()
    # a query point that is not finite (a line-search point after a failed
    # Cholesky: nlp.newton_step gives the JAX package's all-NaN step) gives
    # NaN rows in both: the same rows, and only there; the rest compared
    fin = torch.isfinite(g0)
    at_nan_p = ~torch.isfinite(col._rows_at(p_all, row) if row.dim() == 2
                               else p_all[..., row.long()]).all(dim=2)  # [W, Q, R]
    nan_ok = torch.equal(torch.isnan(g), torch.isnan(g0)) and bool((at_nan_p | fin).all())
    err = float((g - g0)[fin].abs().max()) if bool(fin.any()) else 0.0
    ok = err <= TOL and nan_ok
    note = (f"|dg| {err:.3g}; {int((~fin).sum())} rows NaN in the plain version "
            f"({'the same in the kernel, all at non-finite link centres' if nan_ok else 'NOT the same rows in the kernel'})")
    G = kcol.k4_group(Q)
    if G > 1:
        g1 = kern(1)
        same = _bits(g, g1[0]) and _bits(dg, g1[1])
        ok = ok and same
        note += f", G = {G} {'bit for bit' if same else 'NOT bit for bit'} the G = 1 instantiation"
    if tau > 0:
        again = kern()
        same = _bits(g, again[0]) and _bits(dg, again[1])
        ok = ok and same
        note += f", a second call {'gives the same bits' if same else 'DIFFERS'}"
    if dp_all is not None:
        dp = col._rows_at(dp_all, row)                                 # [W, Q, 3, F, R]
        mag = (dp.abs().sum(dim=2)).transpose(-1, -2)                  # |A_a| <= 1
        if tau > 0:
            clear = fin & torch.isfinite(dg0).all(-1)
        else:
            # the best two candidates of every row, from the plain arithmetic
            p = col._rows_at(p_all, row)
            Ap = col._dot3(A[:, None], p[:, :, :, None, :], 2)
            okn = (A.abs().sum(dim=1) > 0)[:, None]
            big = torch.full_like(Ap, -col.BIG)
            both = torch.cat([torch.where(okn, Ap - (d + delta)[:, None], big),
                              torch.where(okn, -Ap - (-d + delta)[:, None], big)], dim=-2)
            top2 = torch.topk(both, 2, dim=-2).values
            clear = fin & ((top2[:, :, 0] - top2[:, :, 1]) > TOL)      # [W, Q, R]
        ratio = float(((dg - dg0).abs() / (TOL * (mag + 1e-6)))[clear].max()) \
            if bool(clear.any()) else 0.0
        ok = ok and ratio <= 1.0
        err = max(err, float((dg - dg0)[clear].abs().max()) if bool(clear.any()) else 0.0)
        note += f", dg worst |d|/tol {ratio:.3g} on {int(clear.sum())}/{clear.numel()} clear rows"
    torch.cuda.synchronize(dev)
    F = dp_all.shape[3] if dp_all is not None else 0
    nbytes = _nbytes(A, d, delta, row, mask, p_all, dp_all, g, dg)
    flops = Wn * Q * R * (C * 16 + 6 * F)
    if tau > 0:
        # the second pass: the candidates again, the weights, Z and the blend
        flops += Wn * Q * R * (C * 36 + 8)
    return ok, err, kern, plain, nbytes, flops, note


def _alm_io_bytes(rows, k, lam, rho, newton: bool, want_c: bool) -> int:
    """Bytes a K7 / K8 call must move: the plan's rows read once, the
    queries and multipliers read once, the outputs written once."""
    t, sc = rows.tensors, rows.prob.screened
    Wn, Q = k.shape[:2]
    F, M = rows.args.F, rows.M
    out = Wn * Q * (4 + 1) + (Wn * Q * F * 4 if newton else 0) + (Wn * Q * M * 4 if want_c else 0)
    grasp = (t["g_coef"], t["g_rad"]) if rows.args.TG else ()
    return _nbytes(t["u_coef"], t["u_hi"], *grasp, t["center"], sc.A, sc.d, sc.delta, sc.row,
                   sc.mask, t["traj"], t["limits"], k, lam, rho) + out


def _alm_flops(rows, nq: int, newton: bool) -> int:
    """float32 operations of a K7 / K8 call: the basis, the link-centre and
    torque dot products (with the k-gradients for K7), K4's 2C candidates
    per screened row, and per row the penalty (K7: g and H terms)."""
    a = rows.args
    B, F, TF, TJ, K, C, M = a.B, a.F, a.TF + a.TG, a.TJ, a.K, a.C, rows.M
    nv = 1 + F if newton else 1
    per = (B * F * (4 + (F if newton else 0)) + 2 * nv * B * (3 * TJ + TF) + K * C * 14
           + M * 6)
    if newton:
        per += K * 6 * F + M * (2 * F + F * (F + 1)) + 2 * F ** 3
    if a.tau > 0:
        # the smooth mode's second pass: the candidates again, the weights,
        # Z (and in K7 the blended normal)
        per += K * (C * (36 if newton else 24) + 8)
    return a.W * nq * per


def check_alm_newton(inputs, dev):
    """K7 against alm_newton_plain (and alm_newton_system for g, H): m0
    within ALM_TOL |m0|; g, H within ALM_TOL of their summed |terms| and the
    step within ALM_TOL backward error (|H step - g| against |H| |step| +
    |g|) on every (world, seed) whose active set and active argmaxes are the
    same in both (the others counted); feas identical up to queries with a
    row within ALM_C_TOL of its threshold."""
    from armour_tpu_torch import nlp
    from armour_tpu_torch.kernels import solver as ks

    rows, k, lam, rho = inputs
    prob, cfg, basis = rows.prob, rows.cfg, rows.basis
    Wn, S, F = k.shape

    def kern():
        return ks.alm_newton(rows, k, lam, rho)

    def plain():
        return nlp.alm_newton_plain(k, lam, rho, prob, cfg, basis)

    step, m0, feas, cost, g, H = ks.alm_newton(rows, k, lam, rho, want_system=True)
    again = ks.alm_newton(rows, k, lam, rho, want_system=True)
    same = all(torch.equal(x, y) for x, y in zip((step, m0, feas, cost, g, H), again))
    st0, m00, f0, cost0 = plain()
    cost_ok, cost_note = _cost_bits(rows, k, cost, cost0)
    g0, H0, c0 = nlp.alm_newton_system(k, lam, rho, prob, cfg, basis)
    _, Jc = nlp.constraint_stack(k, prob, cfg, basis, with_grad=True)
    # the kernels' own rows at the same k (K8 shares K7's row code)
    ck = ks.alm_values(rows, k, lam, rho, torch.arange(S, dtype=torch.int32, device=dev),
                       want_c=True)[3]
    z0 = lam + rho[..., None] * c0
    act0 = z0 > 0
    flip = (act0 != (lam + rho[..., None] * ck > 0)).any(-1)
    c0_ = 2 * rows.args.TF + rows.args.TG
    if rows.args.tau > 0:
        # the smooth mode blends the normals: no argmax to tie
        tie = torch.zeros_like(act0[..., c0_:c0_ + rows.args.K])
    else:
        tie = _collision_ties(rows, k) & act0[..., c0_:c0_ + rows.args.K]
    clear = ~(flip | tie.any(-1))                                      # [W, S]
    w = torch.where(act0, rho[..., None], torch.zeros_like(c0))
    le = torch.where(act0, z0, torch.zeros_like(c0))
    Ja = Jc.abs()
    cont = prob.limits.continuous
    g_mag = (nlp.plan_cost_grad(k, prob.traj, prob.q_des, cont, cfg).abs()
             + (Ja * le[..., None]).sum(-2))
    H_mag = (torch.matmul(Ja.transpose(-1, -2) * w[..., None, :], Ja)
             + nlp.plan_cost_hessian(prob.traj, cfg) + 1e-3)
    resid = (torch.matmul(H0, step[..., None])[..., 0] - g0).abs()
    r_mag = torch.matmul(H0.abs(), step.abs()[..., None])[..., 0] + g0.abs()
    ratios = {
        "g": ((g - g0).abs() / (ALM_TOL * (g_mag + 1e-6))).amax(-1),
        "H": ((H - H0).abs() / (ALM_TOL * (H_mag + 1e-6))).amax((-1, -2)),
        "step": (resid / (ALM_TOL * (r_mag + 1e-6))).amax(-1)}
    worst = {n: float(r[clear].max()) if bool(clear.any()) else 0.0 for n, r in ratios.items()}
    m_ratio = float(((m0 - m00).abs() / (ALM_TOL * (m00.abs() + 1e-6))).max())
    amb = ((c0 - nlp._stack_thresholds(prob, cfg)).abs()
           <= ALM_C_TOL * _row_mag(rows, k, c0)).any(-1)
    feas_ok = bool(((feas == f0) | amb).all())
    torch.cuda.synchronize(dev)
    ok = feas_ok and m_ratio <= 1.0 and all(v <= 1.0 for v in worst.values()) \
        and bool(torch.isfinite(step[clear]).all()) and same and cost_ok
    err = max(float((m0 - m00).abs().max()),
              float((step - st0)[clear].abs().max()) if bool(clear.any()) else 0.0)
    note = (f"m0 worst |d|/tol {m_ratio:.3g}; g {worst['g']:.3g}, H {worst['H']:.3g}, step "
            f"(backward error) {worst['step']:.3g} on {int(clear.sum())}/{clear.numel()} "
            f"(world, seed): {int(flip.sum())} with an active-set flip, "
            f"{int((tie.any(-1) & ~flip).sum())} with an active argmax near-tie left out; "
            f"max |dstep| {err:.3g}; feas {'identical' if bool(torch.equal(feas, f0)) else 'differs'}"
            f" ({int(f0.sum())} feasible, {int(amb.sum())} within {ALM_C_TOL} of a threshold); "
            f"{int(act0.sum())} active rows; {cost_note}; a second call "
            f"{'gives the same bits' if same else 'DIFFERS'}")
    nbytes = _alm_io_bytes(rows, k, lam, rho, True, False)
    return ok, err, kern, plain, nbytes, _alm_flops(rows, S, True), note


def _row_mag(rows, kq, c0):
    """Magnitude of the terms of every row at kq [W, Q, F]: 1 + |c|, and for
    the torque rows also sum_b |u_coef_b phi_b| + |hi|, for the grasp rows
    sum_b |g_coef_b phi_b| + |g_rad|."""
    a = rows.args
    mag = 1.0 + c0.abs()
    phi = rows.basis.phi(kq).abs()
    if a.TF:
        u_abs = torch.matmul(phi, rows.tensors["u_coef"].abs().transpose(1, 2))  # [W, Q, TF]
        t = u_abs + rows.tensors["u_hi"].abs()[:, None]
        mag[..., :2 * a.TF] += torch.cat([t, t], dim=-1)
    if a.TG:
        mag[..., 2 * a.TF:2 * a.TF + a.TG] += _grasp_mag(rows, phi)
    return mag


def _grasp_mag(rows, phi_abs):
    """sum_b |g_coef_b phi_b| + |g_rad| of every grasp row [W, Q, TG]."""
    t = rows.tensors
    return (torch.matmul(phi_abs, t["g_coef"].abs().transpose(1, 2))
            + t["g_rad"].abs()[:, None])


def _collision_ties(rows, k):
    """[W, Q, K]: real screened rows whose best two of the 2C candidates at
    k lie within ALM_TIE and carry gradients (signed unit normals) more than
    0.1 ALM_TOL apart; parallel generator pairs tie with the same normal."""
    from armour_tpu_torch import collision as col

    prob, basis = rows.prob, rows.basis
    sc = prob.screened
    p = col._rows_at(col.eval_link_polys(prob.frs, basis.phi(k)), sc.row)   # [W, Q, 3, K]
    A = sc.A[:, None]
    Ap = col._dot3(A, p[:, :, :, None, :], 2)                           # [W, Q, C, K]
    okn = A.abs().sum(dim=2) > 0
    big = torch.full_like(Ap, -col.BIG)
    both = torch.cat([torch.where(okn, Ap - (sc.d + sc.delta)[:, None], big),
                      torch.where(okn, -Ap - (-sc.d + sc.delta)[:, None], big)], dim=-2)
    top2, idx = torch.topk(both, 2, dim=-2)                             # [W, Q, 2, K]
    C = sc.A.shape[2]
    sign = torch.where(idx < C, -1.0, 1.0)
    comb = torch.where(idx < C, idx, idx - C)
    An = torch.gather(A.expand(-1, comb.shape[1], -1, -1, -1), 3,
                      comb[:, :, None].expand(-1, -1, 3, -1, -1))     # [W, Q, 3, 2, K]
    grad = sign[:, :, None] * An
    differ = (grad[:, :, :, 0] - grad[:, :, :, 1]).abs().amax(2) > 0.1 * ALM_TOL
    return ((top2[:, :, 0] - top2[:, :, 1]) <= ALM_TIE) & differ & sc.mask[:, None]


def check_alm_values(inputs, dev):
    """K8 against alm_values_plain: merit within ALM_TOL |merit|, rows within
    ALM_C_TOL (1 + |c|), feas identical up to queries with a row within
    ALM_C_TOL of its threshold."""
    from armour_tpu_torch import nlp
    from armour_tpu_torch.kernels import solver as ks

    rows, kq, lam, rho, seed_of_q, want_c = inputs
    prob, cfg, basis = rows.prob, rows.cfg, rows.basis

    def kern():
        return ks.alm_values(rows, kq, lam, rho, seed_of_q, want_c)

    def plain():
        return nlp.alm_values_plain(kq, lam, rho, seed_of_q, prob, cfg, basis, want_c)

    merit, feas, cost, c = ks.alm_values(rows, kq, lam, rho, seed_of_q, True)
    again = ks.alm_values(rows, kq, lam, rho, seed_of_q, True)
    same = all(torch.equal(x, y) for x, y in zip((merit, feas, cost, c), again))
    m0, f0, cost0, c0 = nlp.alm_values_plain(kq, lam, rho, seed_of_q, prob, cfg, basis, True)
    cost_ok, cost_note = _cost_bits(rows, kq, cost, cost0)
    m_ratio = float(((merit - m0).abs() / (ALM_TOL * (m0.abs() + 1e-6))).max())
    mag = _row_mag(rows, kq, c0)
    c_ratio = float(((c - c0).abs() / (ALM_C_TOL * mag)).max())
    amb = ((c0 - nlp._stack_thresholds(prob, cfg)).abs() <= ALM_C_TOL * mag).any(-1)
    feas_ok = bool(((feas == f0) | amb).all())
    torch.cuda.synchronize(dev)
    ok = feas_ok and m_ratio <= 1.0 and c_ratio <= 1.0 and same and cost_ok
    err = max(float((merit - m0).abs().max()), float((c - c0).abs().max()))
    note = (f"merit worst |d|/tol {m_ratio:.3g}, rows {c_ratio:.3g} (max |dc| "
            f"{float((c - c0).abs().max()):.3g}); feas "
            f"{'identical' if bool(torch.equal(feas, f0)) else 'differs'} ({int(f0.sum())}/"
            f"{f0.numel()} feasible, {int(amb.sum())} within {ALM_C_TOL} of a threshold); "
            f"{cost_note}; a second call {'gives the same bits' if same else 'DIFFERS'}")
    nbytes = _alm_io_bytes(rows, kq, lam, rho, False, want_c)
    return ok, err, kern, plain, nbytes, _alm_flops(rows, kq.shape[1], False), note


def _bits(a, b) -> bool:
    """The same bits (float tensors compared as int32 words: NaN payloads
    and the sign of zero count)."""
    if a is None or b is None:
        return a is None and b is None
    if a.dtype == torch.bool or b.dtype == torch.bool:
        return a.dtype == b.dtype and torch.equal(a, b)
    a, b = a.contiguous(), b.contiguous()
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _cost_bits(rows, kq, cost, cost0):
    """K7 / K8's cost against plan_cost (cost0, the plain version's output):
    (bit for bit?, a note that also counts the queries where the cost summed
    by torch.sum, the plain cost's sum before it took alm_cost's order,
    differs)."""
    from armour_tpu_torch import nlp

    prob, cfg = rows.prob, rows.cfg
    d = nlp._plan_diff(kq, prob.traj, prob.q_des, prob.limits.continuous, cfg)
    by_sum = cfg.cost_scale * torch.sum(d * d, dim=-1)
    ok = _bits(cost, cost0)
    n_sum = int((by_sum.view(torch.int32) != cost.contiguous().view(torch.int32)).sum())
    return ok, (f"cost {'= plan_cost bit for bit' if ok else 'DIFFERS from plan_cost'} "
                f"({cost.numel()} points; torch.sum's order would differ at {n_sum})")


def check_alm_maxima(inputs, dev):
    """K8's max mode against nlp.maxima_plain at the solve's points: the
    state maxima bit for bit, the torque maxima within ALM_C_TOL of their
    terms (K8's dot products sum in their own order), the same bits on a
    repeat."""
    from armour_tpu_torch import nlp
    from armour_tpu_torch.kernels import solver as ks

    rows, kq, _ = inputs
    prob, cfg, basis = rows.prob, rows.cfg, rows.basis

    def kern():
        return ks.alm_maxima(rows, kq)

    def plain():
        return nlp.maxima_plain(kq, prob, cfg, basis)

    vt, vs, vg = kern()
    vt2, vs2, vg2 = kern()
    pt, ps, pg = plain()
    same = _bits(vt, vt2) and _bits(vs, vs2) and _bits(vg, vg2)
    state_ok = _bits(vs, ps)
    phi = basis.phi(kq).abs()
    if rows.args.TF:
        u_abs = torch.matmul(phi, rows.tensors["u_coef"].abs().transpose(1, 2))
        mag = (u_abs + rows.tensors["u_hi"].abs()[:, None]).amax(-1) + 1.0
    else:
        mag = torch.ones_like(pt)
    gmag = _grasp_mag(rows, phi).amax(-1) + 1.0 if rows.args.TG else torch.ones_like(pg)
    t_ratio = float(((vt - pt).abs() / (ALM_C_TOL * mag)).max())
    g_ratio = float(((vg - pg).abs() / (ALM_C_TOL * gmag)).max())
    torch.cuda.synchronize(dev)
    ok = same and state_ok and t_ratio <= 1.0 and g_ratio <= 1.0
    err = max(float((vt - pt).abs().max()), float((vs - ps).abs().max()),
              float((vg - pg).abs().max()))
    note = (f"max mode at {kq.shape[1]} points: state maxima "
            f"{'bit for bit' if state_ok else 'DIFFER'} "
            f"({int((vs.view(torch.int32) != ps.contiguous().view(torch.int32)).sum())} of "
            f"{vs.numel()} differ), torque maxima worst |d|/tol {t_ratio:.3g} (max |d| "
            f"{float((vt - pt).abs().max()):.3g}; {int((vt != pt).sum())} not bit for bit), "
            f"grasp maxima worst |d|/tol {g_ratio:.3g} ({int((vg != pg).sum())} not bit for "
            f"bit); a second call {'gives the same bits' if same else 'DIFFERS'}")
    # the max mode reads the torque and grasp rows and the torque limits, the
    # trajectory scalars and the untightened state limits (rows 3-5); no
    # link centre
    a, t = rows.args, rows.tensors
    torque = (t["u_coef"], t["u_hi"]) if a.TF else ()
    grasp = (t["g_coef"], t["g_rad"]) if a.TG else ()
    nbytes = (_nbytes(*torque, *grasp, t["traj"], t["limits"][3:], t["continuous"], kq)
              + kq.shape[0] * kq.shape[1] * 12)
    flops = a.W * kq.shape[1] * (a.B * a.F * 4 + 2 * a.B * (a.TF + a.TG) + 3 * a.TF + a.TG
                                 + 8 * a.F * 60)
    return ok, err, kern, plain, nbytes, flops, note


def _tup(x):
    return x if isinstance(x, tuple) else (x,)


def _k14_bytes(phase, inputs, got) -> int:
    """Bytes K14's phase must move on this run's data: every output written
    once and, of the inputs, what it reads: a row of F floats (a seed's k, a
    multiplier row) only where the phase picks it or folds it into the
    tracker, a cost only where its point is feasible.  A phase run in a row
    pass's finish (alm_loop.cuh) takes its pass's outputs (merit, feas,
    cost, the step, the clipped rows of the outer update) from registers or
    shared memory, and its pass reads the query points, lam and rho anyway:
    it counts only its own inputs (the tracker, m0, the bracket, end_feas,
    k) and its outputs."""
    def some(t, where):
        """bytes of the rows of t picked by the mask `where` (t's leading dims)"""
        return int(where.sum()) * (t.numel() // max(where.numel(), 1)) * t.element_size()

    out = _nbytes(*got)
    if phase == "init":
        return out
    if phase == "ladder":
        k, step, feas, cost, best_k, best_cost, alphas = inputs
        return out + _nbytes(best_k, best_cost) + 4 * len(alphas)
    if phase == "accept":
        # k only where no ladder point replaces it
        k, m0, kq, merit, feas, cost, best_k, best_cost = inputs
        mv = merit.view(k.shape[0], k.shape[1], -1)
        took = mv.gather(-1, mv.argmin(-1, keepdim=True))[..., 0] < m0
        return out + _nbytes(m0, best_k, best_cost) + some(k, ~took)
    if phase == "outer":
        # lam_out written where K8 forms each row; no c, no second read of lam
        k, feas, cost, c, lam, rho, best_k, best_cost = inputs
        return out + _nbytes(best_k, best_cost)
    if phase == "cull":
        # the scores; then only the kept seeds' carry (W keep rows of lam)
        k, lam, rho, best_k, best_cost, v, cost, keep = inputs
        open_ = ~torch.isfinite(best_cost)
        kept = k.shape[0] * keep
        return (out + _nbytes(best_cost) + some(v, open_) + some(cost, open_)
                + kept * (lam.shape[-1] + 2 * k.shape[-1] + 1) * 4)
    if phase == "pull_start":
        k, best_k, best_cost = inputs
        return out + _nbytes(best_cost) + some(best_k, torch.isfinite(best_cost))
    if phase == "pull_step":
        lo, hi, mid, ok = inputs
        return out + some(lo, ~ok) + some(hi, ok)
    if phase == "pull_end":
        k, lo, mid, ok, end_feas, best_cost = inputs
        pull = ~end_feas & torch.isfinite(best_cost)
        return (out + _nbytes(end_feas) + some(best_cost, ~end_feas) + some(k, ~pull)
                + some(lo, pull & ~ok))
    if phase == "finish":
        k, k_pull, feas, cost, best_k, best_cost = inputs
        return out + _nbytes(k, best_k, best_cost)
    if phase == "select":
        # the full-set violations of both iterates; one kb row per feasible world
        kb, v, best_cost, cost_final, t = inputs
        return (out + _nbytes(v, best_cost, cost_final) + 4 * len(t)
                + int(got[1].sum()) * kb.shape[-1] * kb.element_size())
    raise ValueError(f"no byte count for K14 phase {phase}")


def _row_pass(phase, rows, args, want_c=False):
    """The row pass of a recorded step (nlp.loop_pairs) alone: K7 at
    the ladder's seeds, else K8 at the step's query points (args[:3])."""
    from armour_tpu_torch import nlp
    from armour_tpu_torch.kernels import solver as ks

    q, lam, rho = args[:3]
    if phase == "ladder":
        return ks.alm_newton(rows, q, lam, rho)
    S = rho.shape[1]
    per = q.shape[1] // S if phase == "accept" else 1
    return ks.alm_values(rows, q, lam, rho, nlp._seed_index(S, per, q.device), want_c)


def _phase_inputs(phase, rows, alphas, args):
    """The inputs of K14's plain phase (nlp.PLAIN_LOOP) for a recorded step
    of a row pass with the phase in its finish: the step's own inputs and
    the row pass's outputs (_row_pass)."""
    out = _row_pass(phase, rows, args, want_c=phase == "outer")
    if phase == "init":
        k = args[0]
        return (k, out[1], out[2])
    if phase == "ladder":
        k, _, _, best_k, best_cost = args
        step, _, feas, cost = out
        return (k, step, feas, cost, best_k, best_cost, alphas)
    if phase == "accept":
        kq, _, _, k, m0, best_k, best_cost = args
        return (k, m0, kq, out[0], out[1], out[2], best_k, best_cost)
    if phase == "outer":
        k, lam, rho, best_k, best_cost = args
        return (k, out[1], out[2], out[3], lam, rho, best_k, best_cost)
    if phase == "pull_start":
        k, _, _, best_k, best_cost = args
        return (k, best_k, best_cost)
    if phase == "pull_step":
        mid, _, _, lo, hi = args
        return (lo, hi, mid, out[1])
    if phase == "pull_end":
        mid, _, _, k, lo, end_feas, best_cost = args
        return (k, lo, mid, out[1], end_feas, best_cost)
    if phase == "finish":
        k_pull, _, _, k, best_k, best_cost = args
        return (k, k_pull, out[1], out[2], best_k, best_cost)
    raise ValueError(f"no K14 phase {phase} runs in a row pass")


def kernel_ms(kern, dev) -> float:
    """The median of TIMING_ITERS calls of kern (CUDA events); for a K14
    phase run by a row pass's finish, less the same row pass alone
    (kern.row_pass), timed in turns."""
    from armour_tpu_torch.utils.timing import median_ms

    base = getattr(kern, "row_pass", None)
    if base is None:
        return median_ms(kern, dev, TIMING_ITERS)
    with_phase, alone = [], []
    for _ in range(2):
        with_phase.append(median_ms(kern, dev, TIMING_ITERS))
        alone.append(median_ms(base, dev, TIMING_ITERS))
    return statistics.median(with_phase) - statistics.median(alone)


def check_alm_loop(key, inputs, dev):
    """K14's phase key[0] against its plain version (nlp.PLAIN_LOOP) on the
    recorded inputs: every output bit for bit, and the same bits on a
    second call.  The cull and the selection are K14's launches; every
    other phase runs in the finish of its row pass (K7 for the ladder, K8
    else), held through that pass against the pass alone followed by the
    plain phase (nlp.loop_pairs); its time is then the pass with the phase
    less the pass alone (kern.row_pass), its plain time the plain phase's,
    its bound the bytes the phase moves (_k14_bytes)."""
    from armour_tpu_torch import nlp
    from armour_tpu_torch.kernels import solver as ks

    phase = key[0]
    if phase in ks.ALM_EPILOGUES:
        rows, alphas, args = inputs
        def newton(k, lam, rho, epi=None):
            return ks.alm_newton(rows, k, lam, rho, epi=epi)

        def values(*a, **kw):
            return ks.alm_values(rows, *a, **kw)

        fused = getattr(nlp.loop_pairs(newton, values, ks.LOOP, alphas,
                                       functools.partial(ks.epilogue, rows, alphas)), phase)
        unfused = getattr(nlp.loop_pairs(newton, values, nlp.PLAIN_LOOP, alphas), phase)

        def kern():
            return fused(*args)

        got, again, want = _tup(kern()), _tup(kern()), _tup(unfused(*args))
        p_in = _phase_inputs(phase, rows, alphas, args)
        p_out = _tup(getattr(nlp.PLAIN_LOOP, phase)(*p_in))

        def row_pass():
            return _row_pass(phase, rows, args)

        def plain():
            return getattr(nlp.PLAIN_LOOP, phase)(*p_in)

        kern.row_pass = row_pass
        where = f"in {ks.ALM_EPILOGUES[phase][0]}'s finish"
    else:
        p_in = inputs
        kern_fn, plain_fn = getattr(ks.LOOP, phase), getattr(nlp.PLAIN_LOOP, phase)

        def kern():
            return kern_fn(*inputs)

        def plain():
            return plain_fn(*inputs)

        got, again, want = _tup(kern()), _tup(kern()), _tup(plain())
        p_out = got
        where = "its own launch"
    torch.cuda.synchronize(dev)
    same = len(got) == len(again) and all(_bits(g, a) for g, a in zip(got, again))
    equal = len(got) == len(want) and all(_bits(g, w) for g, w in zip(got, want))
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype != torch.bool:
            d = (torch.nan_to_num(g.float(), nan=0.0, posinf=0.0, neginf=0.0)
                 - torch.nan_to_num(w.float(), nan=0.0, posinf=0.0, neginf=0.0)).abs()
            err = max(err, float(d.max()) if d.numel() else 0.0)
    nbytes = _k14_bytes(phase, p_in, p_out)
    flops = 4 * sum(x.numel() for x in p_out)
    bits = "the plain version's bits" if equal else "DIFFERS"
    note = (f"{phase} ({where}): {bits} on {len(got)} outputs; a second call "
            f"{'gives the same bits' if same else 'DIFFERS'}")
    return equal and same, err, kern, plain, nbytes, flops, note


def check_alm(name, key, inputs, dev):
    """The check of a recorded K7 / K8 / K8 max mode / K14 call."""
    if name == "alm_newton":
        return check_alm_newton(inputs, dev)
    if name == "alm_loop":
        return check_alm_loop(key, inputs, dev)
    if key[-1] == "maxima":
        return check_alm_maxima(inputs, dev)
    return check_alm_values(inputs, dev)


ALM_KERNELS = ("alm_newton", "alm_values", "alm_loop")


def check_alm_captures(captured, dev, label) -> None:
    """K7 / K8 / K14 against their plain versions on every recorded shape of
    a path other than the main one, the kernels timed (and summed by kernel
    over the shapes); fails on a mismatch."""
    from armour_tpu_torch.utils.timing import median_ms

    sums, all_ok = {}, True
    for (name, key), inputs in captured.items():
        if name not in ALM_KERNELS:
            continue
        ok, _, kern, plain, _, _, note = check_alm(name, key, inputs, dev)
        ms = kernel_ms(kern, dev)
        pms = median_ms(plain, dev, TIMING_ITERS)
        print(f"  {name} {key}: {'ok' if ok else 'MISMATCH'} ({note}); kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms (medians of {TIMING_ITERS})")
        sm = sums.setdefault(name, [0.0, 0.0, 0])
        sm[0] += ms
        sm[1] += pms
        sm[2] += 1
        all_ok &= ok
    for name in ALM_KERNELS:
        if name not in sums:
            fail(f"no {name} call was recorded on the {label}")
    if not all_ok:
        fail(f"K7 / K8 / K14 disagree with their plain versions on the {label}")
    print(f"  {label}: " + ", ".join(f"{n} {v[0]:.4f} ms / plain {v[1]:.4f} ms over {v[2]} "
                                     f"shapes" for n, v in sums.items()))


def _chain_flops(name, Wn, T, J, P, basis, E) -> int:
    """float32 operations of K9 / K10 on these shapes: every PZ op of the
    chain counted as the plain version writes it (pz_ops.cuh repeats it)."""
    B, nf = basis.size, basis.nf
    ld = B + E + 1

    def mm(n, m, p):        # matmul_linear with its abs masses and slop
        return (n * p * m * (B * (2 + 2 * nf) + 4 * E + 15) + (n * m + m * p) * (2 * B + E)
                + 2 * n * p * (B + E))

    cross = len(basis.pair_i) * 24 + 3 * E * 6 + 18 * (B + E)
    if name == "fk_chain":
        per = J * (21 * ld + mm(3, 3, 3) + 9 * (B + 3 * E + 10) + 18 * (B + E) + 3 * ld)
    else:
        fwd = (3 + P) * cross + 4 * 9 * ld + 9 * ld + mm(3, 3, 4) + 3 * 3 * ld \
            + P * (3 * ld * 2 + 6 * (B + E) + 3 * 2 * 3 * 2 * ld + 12 * (B + E) + 3 * ld)
        bwd = mm(3, 3, 2 * P) + P * (2 * 9 * ld + 4 * 3 * ld + 4 * ld)
        per = J * (fwd + bwd)
    return Wn * T * per


def check_chain(name, inputs, dev):
    """K9 / K10 against their plain versions (forward_occupancy_plain,
    rnea_pz_sets_plain) on the card: every coef / egen / rad entry within
    TOL (PR 1's 1e-5) of the plain output entry's total mass
    (sum |coef| + sum |egen| + rad, the scale its summed terms share) + 1e-6;
    K10's wrench outputs (a grasp step's, wrench_at set) likewise."""
    from armour_tpu_torch import dynamics, kinematics
    from armour_tpu_torch.kernels import reach

    if name == "fk_chain":
        jrs, robot, cfg, basis = inputs

        def kern():
            return reach.fk_chain(jrs, robot, cfg, basis)

        def plain():
            return kinematics.forward_occupancy_plain(jrs, robot, cfg, basis)
        P = 1
        in_bytes = sum(_nbytes(t[:, :, :robot.num_joints])
                       for t in (jrs.R.coef, jrs.R.egen, jrs.R.rad))
    else:
        jrs, robot, cfg, basis, sets, wrench_at = inputs

        def kern():
            return reach.rnea_chain(jrs, robot, cfg, basis, sets, wrench_at=wrench_at)

        def plain():
            return dynamics.rnea_pz_sets_plain(jrs, robot, cfg, basis, sets,
                                               wrench_at=wrench_at)
        P = len(sets)
        in_bytes = _bpz_bytes(jrs.R) + _bpz_bytes(jrs.qd) + _bpz_bytes(jrs.qda) \
            + _bpz_bytes(jrs.qdda)
    got, again, ref = _tup(kern()), _tup(kern()), _tup(plain())
    torch.cuda.synchronize(dev)
    fields = ("coef", "egen", "rad")
    same = all(torch.equal(getattr(g, f), getattr(a, f))
               for g, a in zip(got, again) for f in fields)
    ratio, err, finite = 0.0, 0.0, True
    for g, r in zip(got, ref):
        mass = r.coef.abs().sum(-1) + r.egen.abs().sum(-1) + r.rad.abs()
        ratio = max(ratio, _rel_ratio(g.coef, r.coef, mass[..., None]),
                    _rel_ratio(g.egen, r.egen, mass[..., None]), _rel_ratio(g.rad, r.rad, mass))
        err = max([err] + [float((getattr(g, f) - getattr(r, f)).abs().max()) for f in fields])
        finite &= all(bool(torch.isfinite(getattr(g, f)).all()) for f in fields)
    Wn, T = jrs.R.rad.shape[:2]
    flops = _chain_flops(name, Wn, T, robot.num_joints, P, basis, jrs.R.egen.shape[-1])
    nbytes = in_bytes + sum(_bpz_bytes(g) for g in got)
    return ratio <= 1.0 and finite and same, err, kern, plain, nbytes, flops, \
        (f"worst |d|/tol {ratio:.3g}, max |d| {err:.3g}; a second call "
         f"{'gives the same bits' if same else 'DIFFERS'}")


def check_k9_geometries(inputs) -> str:
    """K9 under K9_GEOMETRIES against its default geometry: the same bits,
    or the run fails."""
    from armour_tpu_torch.kernels import reach

    jrs, robot, cfg, basis = inputs
    ref = reach.fk_chain(jrs, robot, cfg, basis)
    default = reach.k9_geometry
    try:
        for G, NG, grid in K9_GEOMETRIES:
            reach.k9_geometry = lambda *a, g=reach.ChainGeometry(G, NG, grid), **k: g
            got = reach.fk_chain(jrs, robot, cfg, basis)
            if not all(torch.equal(getattr(got, f), getattr(ref, f))
                       for f in ("coef", "egen", "rad")):
                fail(f"K9 with G={G} NG={NG} grid={grid} differs from its default geometry")
    finally:
        reach.k9_geometry = default
    return (f"the same bits under {len(K9_GEOMETRIES)} other geometries "
            f"{[g[:2] for g in K9_GEOMETRIES]}")


def check_op_geometries(name, inputs) -> str:
    """K1 (name pz_matmul_linear) or K2 (pz_cross) under OP_GEOMETRIES
    against its default geometry: the same bits, or the run fails."""
    from armour_tpu_torch.kernels import pz as kpz

    if name == "pz_cross":
        attr, label = "k2_geometry", "K2"

        def call():
            return kpz.cross(*inputs)
    else:
        attr, label = "k1_geometry", "K1"
        a, b, basis, slop, tr = inputs

        def call():
            return kpz.matmul_linear(a, b, basis, slop, transpose_out=tr)
    ref = call()
    default = getattr(kpz, attr)
    try:
        for G, NG, grid in OP_GEOMETRIES:
            setattr(kpz, attr, lambda *x, g=kpz.ChainGeometry(G, NG, grid), **k: g)
            got = call()
            if not all(torch.equal(getattr(got, f), getattr(ref, f))
                       for f in ("coef", "egen", "rad")):
                fail(f"{label} with G={G} NG={NG} grid={grid} differs from its default geometry")
    finally:
        setattr(kpz, attr, default)
    return (f"the same bits under {len(OP_GEOMETRIES)} other geometries "
            f"{[g[:2] for g in OP_GEOMETRIES]}")


def check_chain_captures(captured, dev, label) -> None:
    """K9 / K10 against their plain versions on every shape recorded on a
    path other than the main one, both timed; fails on a mismatch."""
    from armour_tpu_torch.utils.timing import median_ms

    n, all_ok = 0, True
    for (name, key), inputs in captured.items():
        if name not in ("fk_chain", "rnea_chain"):
            continue
        ok, _, kern, plain, nbytes, _, note = check_chain(name, inputs, dev)
        ms, pms = median_ms(kern, dev, TIMING_ITERS), median_ms(plain, dev, TIMING_ITERS)
        was = BEFORE_MS_OTHER.get((name, label))
        print(f"  {name} {key}: {'ok' if ok else 'MISMATCH'} ({note}); kernel {ms:.4f} ms"
              f"{f' (before: {was} ms)' if was else ''}, plain {pms:.4f} ms (medians of "
              f"{TIMING_ITERS}), {nbytes / 1e6:.1f} MB")
        all_ok &= ok
        n += 1
    if n < 2:
        fail(f"K9 and K10 were not both recorded on the {label}")
    if not all_ok:
        fail(f"K9 / K10 disagree with their plain versions on the {label}")


def uncertain_com_path(jrs, robot, cfg, obs_args, dev):
    """K1 / K2's path: one W = 64 planning step of the Kinova with
    com_uncertainty = COM_UNCERTAINTY, whose PZ RNEA takes the op-level
    route (rotations by K1, PZ x PZ crosses by K2).  A warm-up step records
    the calls; the launch counters are set to 0 just before the counted step
    and read just after, and both kernels must have launched.  Then the FK
    rotation product of the second joint (fk_r = R_0, times R_1) is formed
    from the step's JRS for K1's comparison, outside the count.  Returns
    (recorded calls, K1 / K2 launches, device launches, step ms)."""
    import dataclasses

    from armour_tpu_torch import kernels
    from armour_tpu_torch.planner import make_batch_planner
    from armour_tpu_torch.pz import bpz
    from armour_tpu_torch.pz.basis import make_basis
    from armour_tpu_torch.utils.timing import median_ms, wall_s

    robot_c = dataclasses.replace(robot, com_uncertainty=COM_UNCERTAINTY)
    step_c = make_batch_planner(robot_c, cfg)
    with kernels.capture() as rec:
        wall_s(lambda: step_c(*obs_args), dev)
    kernels.reset_counts()
    t, res = wall_s(lambda: step_c(*obs_args), dev)
    counts, dcounts = kernels.counts(), kernels.device_counts()
    launches = {k: counts[k] for k in OP_KERNELS}
    print(f"phase 3: uncertain-COM path (com_uncertainty {COM_UNCERTAINTY}): W={N_WORLDS} "
          f"planning step {t * 1e3:.1f} ms, {int(res.feasible.sum())}/{N_WORLDS} feasible; "
          f"launches {counts}")
    for name in OP_KERNELS:
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the uncertain-COM path")
    if counts["reach_assembly"] != 1:
        fail(f"K15 launched {counts['reach_assembly']} times in the uncertain-COM step, not once")
    no_k3(counts, "the uncertain-COM path")
    k15 = [v for k, v in rec.items() if k[0] == "reach_assembly"]
    if len(k15) != 1:
        fail("the uncertain-COM step recorded no K15 call")
    ok, _, kern, plain, _, _, note = check_reach_assembly(k15[0], dev)
    print(f"  reach_assembly on the uncertain-COM route (u_both from the K1 / K2 loops): "
          f"{'ok' if ok else 'MISMATCH'} ({note}); kernel "
          f"{median_ms(kern, dev, TIMING_ITERS):.4f} ms, plain "
          f"{median_ms(plain, dev, TIMING_ITERS):.4f} ms")
    if not ok:
        fail("K15 disagrees with its plain version on the uncertain-COM route")
    R = jrs.R
    r0 = bpz.BPZ(coef=R.coef[:, :, 0], egen=R.egen[:, :, 0], rad=R.rad[:, :, 0])
    r1 = bpz.BPZ(coef=R.coef[:, :, 1], egen=R.egen[:, :, 1], rad=R.rad[:, :, 1])
    basis = make_basis(robot.num_factors, cfg.max_poly_degree)
    with kernels.capture() as fk:
        bpz.matmul_linear_right(r0, r1, basis, cfg.float_slop)
    rec = {k: v for k, v in rec.items() if k[0] in OP_KERNELS}
    rec.update(fk)
    if not any(k[0] == "pz_matmul_linear" for k in rec) or not any(k[0] == "pz_cross"
                                                                    for k in rec):
        fail("the uncertain-COM path recorded no K1 / K2 call")
    return rec, launches, {k: dcounts[k] for k in OP_KERNELS}, t * 1e3


REPLACES = {
    "pz_matmul_linear": ("armour_tpu_torch/csrc/pz_matmul_linear.cu", "armour_tpu/pz/bpz.py:214"),
    "pz_cross": ("armour_tpu_torch/csrc/pz_cross.cu", "armour_tpu/pz/bpz.py:120"),
    "build_hyperplanes": ("armour_tpu_torch/csrc/build_hyperplanes.cu", "armour_tpu/collision.py:99"),
    "collision_rows": ("armour_tpu_torch/csrc/collision_rows.cu", "armour_tpu/collision.py:255"),
    "rollout": ("armour_tpu_torch/csrc/rollout.cu", "armour_tpu/simulator.py:111"),
    "oracle_check": ("armour_tpu_torch/csrc/oracle_check.cu", "armour_tpu/simulator.py:217"),
    "alm_newton": ("armour_tpu_torch/csrc/alm_newton.cu", "armour_tpu/nlp.py:475"),
    "alm_values": ("armour_tpu_torch/csrc/alm_values.cu", "armour_tpu/nlp.py:494"),
    "fk_chain": ("armour_tpu_torch/csrc/fk_chain.cu", "armour_tpu/kinematics.py:97"),
    "rnea_chain": ("armour_tpu_torch/csrc/rnea_chain.cu", "armour_tpu/dynamics.py:160"),
    "jrs_armtd": ("armour_tpu_torch/csrc/jrs_armtd.cu", "armour_tpu/armtd.py:77"),
    "jrs_bernstein": ("armour_tpu_torch/csrc/jrs_bernstein.cu", "armour_tpu/jrs.py:220"),
    "screen_collision": ("armour_tpu_torch/csrc/screen_collision.cu",
                         "armour_tpu/collision.py:193"),
    "alm_loop": ("armour_tpu_torch/csrc/alm_loop.cu", "armour_tpu/nlp.py:427"),
    "reach_assembly": ("armour_tpu_torch/csrc/reach_assembly.cu",
                       "armour_tpu/dynamics.py:293, armour_tpu/kinematics.py:115"),
    "grasp_rows": ("armour_tpu_torch/csrc/grasp_rows.cu",
                   "armour_tpu/pz/bpz.py:120 (mul, :170), armour_tpu/grasp.py:131"),
}
# the kernels of a planning step of either trajectory family, after its JRS;
# K1 / K2 (the op-level PZ products) serve only the uncertain-COM route,
# which phase 3 drives as their own path, and K3 no planning path at all
STEP_KERNELS = ("collision_rows", "alm_newton", "alm_values", "fk_chain", "rnea_chain",
                "screen_collision", "alm_loop", "reach_assembly")
# a Bernstein step: its JRS is K12 (the ARMTD family's is K11)
BERNSTEIN_KERNELS = ("jrs_bernstein",) + STEP_KERNELS
OP_KERNELS = ("pz_matmul_linear", "pz_cross")
PLANNING_KERNELS = OP_KERNELS + BERNSTEIN_KERNELS
# held against their plain versions by a direct call on a step's inputs:
# K3 (build_hyperplanes), on the step's cells (add_direct_k3)
DIRECT_KERNELS = ("build_hyperplanes",)
HAND_KERNEL_PREFIX = {"pz_matmul_linear": "k1", "pz_cross": "k2", "build_hyperplanes": "k3",
                      "collision_rows": "k4", "rollout": "k5", "oracle_check": "k6",
                      "alm_newton": "k7", "alm_values": "k8", "fk_chain": "k9",
                      "rnea_chain": "k10", "jrs_armtd": "k11", "jrs_bernstein": "k12",
                      "screen_collision": "k13", "alm_loop": "k14", "reach_assembly": "k15",
                      "grasp_rows": "k16"}


def no_k3(launches, where) -> None:
    """No planning path forms the hyperplane tensors: K13 and K4 form the
    rows they need from the cells, so K3 must not have launched."""
    if launches["build_hyperplanes"]:
        fail(f"K3 (build_hyperplanes) launched {launches['build_hyperplanes']} times on {where}: "
             f"a planning path formed the [W, 3, 36, N] hyperplane tensors")


def add_direct_k3(captured) -> None:
    """K3 on a step's cells (the recorded K13 call's link sets and
    obstacles), recorded as a call of that step: K3 runs on no planning
    path, so phase 3 and the ARMTD and grasp steps hold it against its plain
    version this way."""
    for (name, _), inputs in list(captured.items()):
        if name == "screen_collision":
            shape_gens, radius, centers, gens = inputs[:4]
            captured[("build_hyperplanes", (tuple(radius.shape), centers.shape[1]))] = (
                shape_gens, radius, centers, gens)


def _bound_ms(nbytes, flops) -> float:
    """The least time on the card for the work: bytes over its memory rate
    or float32 operations over its peak, whichever is longer."""
    return max(nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOP_PER_S) * 1e3


def kernel_part(name, key):
    """The part of a kernel whose shapes are summed apart: K8's row passes
    and its max mode, K14's phases; None for the other kernels."""
    if name == "alm_values":
        return "max mode" if key[-1] == "maxima" else "row passes"
    if name == "alm_loop":
        return key[0]
    return None


def kernel_phase(captured, launches, device_launches, dev):
    from armour_tpu_torch.utils.timing import median_ms

    rows = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0, "err": 0.0, "calls": 0,
                "library_ms": None} for k in PLANNING_KERNELS + DIRECT_KERNELS}
    parts = {}
    all_ok = True
    for (name, key), inputs in captured.items():
        if name not in rows:
            continue
        library = None
        if name == "jrs_bernstein":
            res = check_jrs(name, inputs, dev)
        elif name == "screen_collision":
            *res, library = check_screen(inputs, dev)
        elif name == "reach_assembly":
            res = check_reach_assembly(inputs, dev)
        elif name in ("pz_matmul_linear", "pz_cross"):
            res = check_pz(name, inputs, dev)
        elif name == "build_hyperplanes":
            res = check_hyperplanes(inputs, dev)
        elif name in ALM_KERNELS:
            res = check_alm(name, key, inputs, dev)
        elif name in ("fk_chain", "rnea_chain"):
            res = check_chain(name, inputs, dev)
        else:
            res = check_rows(inputs, dev)
        ok, err, kern, plain, nbytes, flops, note = res
        ms = kernel_ms(kern, dev)
        pms = median_ms(plain, dev, TIMING_ITERS)
        r = rows[name]
        r["ms"] += ms
        r["plain_ms"] += pms
        r["bytes"] += nbytes
        r["flops"] += flops
        r["err"] = max(r["err"], err)
        r["calls"] += 1
        part = kernel_part(name, key)
        if part is not None:
            pt = parts.setdefault((name, part), [0.0, 0.0, 0, 0, 0])
            for i, x in enumerate((ms, pms, nbytes, flops, 1)):
                pt[i] += x
        lib = ""
        if library is not None:
            lms = median_ms(library, dev, TIMING_ITERS)
            r["library_ms"] = (r["library_ms"] or 0.0) + lms
            lib = f", library (torch.topk of the same K over the same bound) {lms:.4f} ms"
        print(f"  {name} {key}: {'ok' if ok else 'MISMATCH'} ({note}); "
              f"kernel {ms:.4f} ms, plain {pms:.4f} ms{lib}, {nbytes / 1e6:.1f} MB, "
              f"bound {_bound_ms(nbytes, flops):.4f} ms")
        if name == "fk_chain":
            print(f"  {name} {key}: {check_k9_geometries(inputs)}")
        elif name == "reach_assembly":
            print(f"  {name} {key}: launch geometry {k15_geometry_of(inputs)}")
        elif name in OP_KERNELS:
            print(f"  {name} {key}: {check_op_geometries(name, inputs)}")
        elif name == "screen_collision":
            for label, x in screen_variants(inputs):
                ok_v, _, kern_v, plain_v, _, _, note_v, _ = check_screen(x, dev)
                print(f"  {name} {key}, {label}: {'ok' if ok_v else 'MISMATCH'} ({note_v}); "
                      f"kernel {median_ms(kern_v, dev, TIMING_ITERS):.4f} ms, plain "
                      f"{median_ms(plain_v, dev, TIMING_ITERS):.4f} ms")
                ok &= ok_v
        all_ok &= ok
    for (name, part), (ms, pms, nbytes, flops, n) in parts.items():
        print(f"  {name}, {part}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
              f"{_bound_ms(nbytes, flops):.4f} ms ({nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.3f} GFLOP) over {n} shapes")
    out = []
    for name in PLANNING_KERNELS + DIRECT_KERNELS:
        r = rows[name]
        if r["calls"] == 0:
            fail(f"kernel {name} was never called on the main path"
                 + (" (a direct call on its cells)" if name in DIRECT_KERNELS else ""))
        t_bytes = r["bytes"] / H100_BYTES_PER_S * 1e3
        t_ops = r["flops"] / H100_FP32_FLOP_PER_S * 1e3
        if name in BEFORE_MS:
            print(f"  {name}: {r['ms']:.4f} ms over {r['calls']} shapes (before: "
                  f"{BEFORE_MS[name]} ms)")
        src, rep = REPLACES[name]
        out.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                    "launches": launches[name], "max_abs_err": r["err"],
                    "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": r["library_ms"], "variants": r["calls"],
                    "device_launches": device_launches[name]})
    if not all_ok:
        fail("a kernel disagrees with its plain version")
    return out


def k4_modes(prob, cfg, basis, krows, breakdown, dev) -> dict:
    """K4's two modes at the W = 64 step: the cell mode (the step's
    full-set check: phase 3's event time, its device time in phase 4's
    profiled step, its bound) and the screened rows of one plain solve (the
    hard mode, where nlp.constraint_stack takes them from K4: every call
    against its plain version and its G = 1 instantiation bit for bit, the
    event times summed, the device time in one profiled plain solve, the
    bound)."""
    from armour_tpu_torch import kernels, nlp
    from armour_tpu_torch.utils.timing import median_ms

    k4 = next(r for r in krows if r["name"] == "collision_rows")
    cell_dev = breakdown.get("hand_device_ms", {}).get("collision_rows", float("nan"))
    print(f"  K4, cell mode (the step's full-set check): event {k4['ms']:.4f} ms, device "
          f"{cell_dev:.4f} ms in one step, bound {k4['bound_ms']:.4f} ms ({k4['bound_by']}), "
          f"plain {k4['plain_ms']:.4f} ms")
    with kernels.capture() as cap:
        nlp.solve(prob, cfg, basis, plain=True)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0, "calls": 0}
    all_ok = True
    for (name, key), inputs in cap.items():
        if name != "collision_rows" or len(inputs) == 6:
            continue
        ok, _, kern, plain, nbytes, flops, note = check_rows(inputs, dev)
        ms, pms = kernel_ms(kern, dev), median_ms(plain, dev, TIMING_ITERS)
        print(f"  collision_rows {key}: {'ok' if ok else 'MISMATCH'} ({note}); kernel "
              f"{ms:.4f} ms, plain {pms:.4f} ms, {nbytes / 1e6:.1f} MB, bound "
              f"{_bound_ms(nbytes, flops):.4f} ms")
        all_ok &= ok
        for f, x in (("ms", ms), ("plain_ms", pms), ("bytes", nbytes), ("flops", flops),
                     ("calls", 1)):
            tot[f] += x
    cap.clear()
    if not all_ok or tot["calls"] == 0:
        fail(f"K4's screened rows of the plain solve: {tot['calls']} shapes recorded, all "
             f"within tolerance and bit for bit G = 1: {all_ok}")
    tl = device_timeline(lambda: nlp.solve(prob, cfg, basis, plain=True), dev)
    rows_dev = [us for n, us in tl if "k4_rows<false" in n]
    bound = _bound_ms(tot["bytes"], tot["flops"])
    print(f"  K4, screened rows (hard, one plain solve): event {tot['ms']:.4f} ms over "
          f"{tot['calls']} shapes, device {sum(rows_dev) / 1e3:.4f} ms in {len(rows_dev)} "
          f"launches of one plain solve, bound {bound:.4f} ms (the shapes' {tot['bytes'] / 1e6:.1f}"
          f" MB and {tot['flops'] / 1e9:.3f} GFLOP), plain {tot['plain_ms']:.4f} ms")
    return {"k4_cells_event_ms": k4["ms"], "k4_cells_device_ms": cell_dev,
            "k4_cells_bound_ms": k4["bound_ms"], "k4_screened_event_ms": tot["ms"],
            "k4_screened_device_ms": sum(rows_dev) / 1e3,
            "k4_screened_device_launches": len(rows_dev), "k4_screened_bound_ms": bound,
            "k4_screened_shapes": tot["calls"]}


def step_peak(fn, dev) -> dict:
    """The device memory one call of fn takes at its peak: the largest
    allocation above what was held before it (torch's caching allocator's
    max_memory_allocated after a reset), and the run's peak until then."""
    torch.cuda.synchronize(dev)
    before = torch.cuda.max_memory_allocated(dev)
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    return {"step_peak_gb": peak / 1e9, "step_peak_above_held_gb": (peak - held) / 1e9,
            "held_gb": held / 1e9, "run_peak_before_gb": before / 1e9}


def print_k13_k15(krows, breakdown, label) -> None:
    """K13's and K15's event time (phase 3, summed over the step's call
    shapes), device time in one step (torch.profiler) and bound."""
    dev_ms = breakdown.get("hand_device_ms", {})
    for r in krows:
        if r["name"] in ("screen_collision", "reach_assembly"):
            print(f"  {label}, {r['name']}: event {r['ms']:.4f} ms ({r['variants']} shapes), "
                  f"device {dev_ms.get(r['name'], float('nan')):.4f} ms in one step, "
                  f"{r['launches']} launch(es), bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                  f"plain {r['plain_ms']:.4f} ms")
    print(f"  {label}, K13's passes, device ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in breakdown.get("k13_pass_ms", {}).items()))


def profile_step(fn, dev, step_s) -> dict:
    """Device time of one call of fn by kernel name (torch.profiler's
    device-side events only: the host-side operator events carry the same
    time again), the hand kernels' share, the number of device activities
    (kernels, copies, fills), and the device busy share of the unprofiled
    step time step_s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    # one warm-up step, then the recorded one: a second profiling session in
    # a process has lost the first device activities of its first step
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize(dev)
            prof.step()
    # the schedule's step annotation spans the whole step on the device
    # timeline: it is no activity of its own
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("ProfilerStep")),
                  reverse=True)
    total = sum(r[0] for r in rows)
    if total == 0:
        print("  profiler: no device time recorded (not measured)")
        return {}
    hand = {name: sum(r[0] for r in rows if f"{k}_" in r[2])
            for name, k in HAND_KERNEL_PREFIX.items()}
    launches = sum(r[1] for r in rows)
    print(f"  profiler: device time {total:.1f} ms in {launches} device activities of one "
          f"W={N_WORLDS} step ({len(rows)} names); top by device time:")
    for ms, n, key in rows[:12]:
        print(f"    {ms:9.3f} ms  x{n:5d}  {key[:90]}")
    print("  hand kernels: " + ", ".join(f"{k} {v:.3f} ms" for k, v in hand.items()))
    return {"device_ms": total, "hand_kernel_ms": sum(hand.values()),
            "device_busy_share": total / (step_s * 1e3), "device_activities": launches,
            "hand_device_ms": hand,
            "k13_pass_ms": {r[2].split("(")[0]: r[0] for r in rows if "k13_" in r[2]}}


# ---------------------------------------------------------------------------
# the closed loop: K5 and K6
# ---------------------------------------------------------------------------


# float32 operations per link of one numeric RNEA pass (rnea_numeric.rnea)
ROT_FLOPS = 48      # joint rotation: cos, sin, axis pattern, rot_mats @ R_axis
KIN_FLOPS = 114     # forward recursion: linear acceleration 48, w / w_aux / wdot 66
LIN_FLOPS = 48      # the linear-acceleration part of KIN_FLOPS alone
FORCE_FLOPS = 36    # link force m (a + wdot x c + w x (w_aux x c))
MOMENT_FLOPS = 42   # link moment I wdot + w_aux x (I w)
BACK_FLOPS = 63     # backward recursion of one link


def k5_work(robot, n: int, Wn: int, substeps: int, noise: bool, clock_mhz: float):
    """(operations, serial-chain ms) of one K5 move: the work the function
    needs, per world and control step:
      - joint rotations once per distinct configuration: the measured state
        (apart from the true state only with noise), the true state (mass
        matrix, first RK4 stage) and the 4 * substeps - 1 other stage states;
      - the velocity / acceleration recursion once per distinct motion: the
        controller's two (tau; V with qd = 0, qdd = r, whose perturbation
        passes add gravity and so a second linear-acceleration chain), the F
        mass-matrix columns and the 4 * substeps bias stages; the 2 x 2J
        perturbation passes share the controller's;
      - link wrench and backward recursion for every nominal pass; a
        perturbation direction of link i changes that link's force (mass) or
        moment (inertia) only, so it needs that term and the backward
        recursion over links 0..i;
      - the controller's reductions, the 7x7 Gauss-Jordan inverse, the M^-1
        products and the RK4 sums.
    The serial chain: the dependent float32 operations of one step (one
    controller pass, the inverse, 4 * substeps bias passes and their
    products; ~15 per link of a pass) at 4 cycles each at the card's maximum
    SM clock."""
    J, F = robot.num_joints, robot.num_factors
    stages = 4 * substeps
    configs = (2 if noise else 1) + stages - 1
    motions = 2 + F + stages
    pert = sum(FORCE_FLOPS + MOMENT_FLOPS + 2 * BACK_FLOPS * (i + 1) for i in range(J))
    per_step = (configs * J * ROT_FLOPS + motions * J * KIN_FLOPS + J * LIN_FLOPS
                + motions * J * (FORCE_FLOPS + MOMENT_FLOPS + BACK_FLOPS) + 2 * pert
                + 8 * J * F + 20 * F + 4 * F ** 3
                + substeps * (4 * (F + 2 * F * F) + 34 * F))
    depth = 15 * J + (3 * F + F * F) + stages * (15 * J + 2 * F + 4)
    serial_ms = n * depth * 4 / (clock_mhz * 1e6) * 1e3
    return Wn * n * per_step, serial_ms


def check_rollout(robot, cfg, inp, dev, label, timed):
    """K5 against rollout_plain on inp; the kernel timed (median of
    TIMING_ITERS) only when timed, the plain version over its one call."""
    from armour_tpu_torch import simulator as tsim
    from armour_tpu_torch.kernels import sim as ksim
    from armour_tpu_torch.utils.timing import median_ms

    def kern():
        return ksim.rollout(robot, cfg, **inp)

    got, again = kern(), kern()
    torch.cuda.synchronize(dev)
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ref = tsim.rollout_plain(robot, cfg, inp["q"], inp["qd"], inp["q_des"], inp["qd_des"],
                             inp["qdd_des"], inp["tp"], inp["control_dt"], inp["substeps"],
                             inp["controller"], inp["noise"], inp["gains"])
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    q_out, qd_out, q_log, qd_log, u_log = got
    rq_out, rqd_out, rq_log, rqd_log, ru_log = ref
    dq = max(float((q_log - rq_log).abs().max()), float((q_out - rq_out).abs().max()))
    dqd = max(float((qd_log - rqd_log).abs().max()), float((qd_out - rqd_out).abs().max()))
    du = float((u_log - ru_log).abs().max())
    u_ratio = float(((u_log - ru_log).abs() / (K5_TOL_U * (ru_log.abs() + 1.0))).max())
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    ok = finite and dq <= K5_TOL_Q and dqd <= K5_TOL_QD and u_ratio <= 1.0 and same
    ms = median_ms(kern, dev, TIMING_ITERS) if timed else None
    Wn, n, F = inp["q_des"].shape
    nbytes = _nbytes(inp["q"], inp["qd"], inp["q_des"], inp["qd_des"], inp["qdd_des"],
                     inp["noise"], inp["tp"].mass, inp["tp"].inertia, inp["tp"].com, *got)
    timing = (f"kernel {ms:.3f} ms (median of {TIMING_ITERS}; before: "
              f"{BEFORE_MS['rollout']} ms), " if timed else "") \
        + f"plain {plain_ms:.1f} ms (1 call); a second call " \
        + ("gives the same bits" if same else "DIFFERS")
    print(f"  rollout {label} [{Wn} worlds x {n} steps]: {'ok' if ok else 'MISMATCH'} "
          f"(max |dq| {dq:.3g} rad <= {K5_TOL_Q}, max |dqd| {dqd:.3g} rad/s <= {K5_TOL_QD}, "
          f"max |du| {du:.3g}, worst |du|/({K5_TOL_U}(|u|+1)) {u_ratio:.3g}); {timing}")
    return ok, max(dq, dqd, du), ms, plain_ms, nbytes


def rollout_variants(inp, dev, n):
    """The recorded move cut to its first n control steps, with the paths
    the main path does not take: the Althoff and nominal controllers, and
    the robust controller under seeded measurement noise (1e-4, as the
    noise test uses)."""
    cut = dict(inp, q_des=inp["q_des"][:, :n].contiguous(),
               qd_des=inp["qd_des"][:, :n].contiguous(),
               qdd_des=inp["qdd_des"][:, :n].contiguous())
    Wn, _, F = cut["q_des"].shape
    g = torch.Generator().manual_seed(0)
    noise = (1e-4 * torch.randn((Wn, n, 2, F), generator=g, dtype=torch.float64)).to(
        device=dev, dtype=torch.float32)
    return [("althoff", dict(cut, controller="althoff")),
            ("nominal", dict(cut, controller="nominal")),
            ("robust + noise", dict(cut, controller="robust", noise=noise))]


def link_obstacle_margins(robot, q, obs):
    """The deciding SAT margin (simulator.sat_margin) of every (world,
    logged step, link, obstacle): q [W, N, F] -> [W, N, J, O]."""
    from armour_tpu_torch import simulator as tsim

    R_w, centers, link_h = tsim._link_boxes(robot, q)
    axes, half = tsim.obstacle_axes_halves(obs.generators)
    return tsim.sat_margin(centers[:, :, :, None, :], R_w[:, :, :, None], link_h[:, None, :],
                           obs.centers[:, None, None], axes[:, None, None],
                           half[:, None, None])


def sat_axes_needed(robot, logs, obs) -> int:
    """Separating-axis candidates K6 evaluates on these inputs: for every
    real (state, link, obstacle) triple, up to and including the first axis
    that separates (all 15 for an overlap)."""
    from armour_tpu_torch import simulator as tsim

    R_w, centers, link_h = tsim._link_boxes(robot, logs["q"])
    axes, half = tsim.obstacle_axes_halves(obs.generators)
    need = None
    done = None
    for k, (valid, dist, rad) in enumerate(tsim._sat_axes(
            centers[:, :, :, None, :], R_w[:, :, :, None], link_h[:, None, :],
            obs.centers[:, None, None], axes[:, None, None], half[:, None, None])):
        sep = valid & (dist > rad)
        if need is None:
            need = torch.full_like(dist, 15, dtype=torch.int64)
            done = torch.zeros_like(sep)
        need = torch.where(sep & ~done, torch.full_like(need, k + 1), need)
        done = done | sep
    return int((need * obs.mask[:, None, None, :]).sum())


def planted_oracle_inputs(robot, cfg, inp):
    """Copies of the recorded K6 inputs, one fault planted in each, in every
    other world (the others as logged): 4 real obstacles moved onto logged
    link centres (collision), u scaled 1% past the nearest torque limit
    (torque), q_des shifted by 1.5 qe over 10 steps (ultimate bound), q
    pushed 0.01 rad past a position limit at one step (joint limit)."""
    from armour_tpu_torch import simulator as tsim

    Wn, N, F = inp["q"].shape
    dev = inp["q"].device
    lim = torch.as_tensor(robot.torque_limits, dtype=torch.float32, device=dev)
    ub = torch.as_tensor(robot.position_limits_ub, dtype=torch.float32, device=dev)
    j_lim = int(torch.argmin(ub))                         # a joint with a finite limit
    copies = []
    for flag in range(4):
        sel = torch.arange(Wn, device=dev) % 2 == flag % 2
        x = {k: v.clone() for k, v in inp.items()}
        if flag == 0:
            _, link_c, _ = tsim._link_boxes(robot, x["q"])       # [W, N, J, 3]
            for w in torch.nonzero(sel).flatten().tolist():
                real = torch.nonzero(x["mask"][w]).flatten()[:4].tolist()
                for i, o in enumerate(real):
                    x["centers"][w, o] = link_c[w, (i * N) // 4, 1 + (2 * i) % (F - 1)]
        elif flag == 1:
            worst = (x["u"].abs() / lim).amax(dim=(1, 2))          # [W]
            x["u"] = torch.where(sel[:, None, None], x["u"] * (1.01 / worst)[:, None, None],
                                 x["u"]).contiguous()
        elif flag == 2:
            x["q_des"][sel, N // 2: N // 2 + 10, 3] += 1.5 * cfg.ub.qe
        else:
            x["q"][sel, N // 3, j_lim] = ub[j_lim] + 0.01
        copies.append((tsim.ORACLE_FLAGS[flag], x))
    return copies
def oracle_agreement(robot, cfg, inp):
    """K6 against oracle_check_plain on inp: (flags identical and overlap
    counts equal up to the triples whose deciding margin lies within
    K6_MARGIN, plain flags [W, 4], kernel and plain counts [W], |d| [W],
    ambiguous triples [W])."""
    from armour_tpu_torch import simulator as tsim
    from armour_tpu_torch.collision import ObstacleSet
    from armour_tpu_torch.kernels import sim as ksim

    logs = {k: inp[k] for k in ("q", "qd", "u", "q_des", "qd_des")}
    obs = ObstacleSet(centers=inp["centers"], generators=inp["generators"], mask=inp["mask"])
    fk, ok_ = ksim.oracle_check(robot, cfg, **inp)
    fp, op = tsim.oracle_check_plain(robot, cfg, logs, obs)
    margins = link_obstacle_margins(robot, logs["q"], obs)
    amb = ((margins.abs() <= K6_MARGIN) & obs.mask[:, None, None, :]).flatten(1).sum(-1)
    del margins
    diff = (ok_ - op).abs()
    return torch.equal(fk, fp) and bool((diff <= amb).all()), fp, ok_, op, diff, amb


def check_oracles(robot, cfg, inp, dev):
    """K6 against oracle_check_plain on the recorded move and on copies of
    it with planted faults: flags exactly, overlap counts exactly up to the
    ambiguous triples; each planted fault must raise its plain flag in some
    world and no other world.  Timed on the recorded move."""
    from armour_tpu_torch import simulator as tsim
    from armour_tpu_torch.collision import ObstacleSet
    from armour_tpu_torch.kernels import sim as ksim
    from armour_tpu_torch.utils.timing import median_ms

    logs = {k: inp[k] for k in ("q", "qd", "u", "q_des", "qd_des")}
    obs = ObstacleSet(centers=inp["centers"], generators=inp["generators"], mask=inp["mask"])
    all_ok = True
    err = 0
    Wn, N, F = logs["q"].shape
    J = robot.num_joints
    for label, x in [("as logged", inp)] + planted_oracle_inputs(robot, cfg, inp):
        ok, fp, ok_, op, diff, amb = oracle_agreement(robot, cfg, x)
        torch.cuda.synchronize(dev)
        if label != "as logged":
            col = tsim.ORACLE_FLAGS.index(label)
            planted = torch.arange(Wn, device=dev) % 2 == col % 2
            # the planted flag is raised in some world, and in none of the
            # worlds left as logged
            fired = bool(fp[:, col].any()) and not bool(fp[~planted, col].any())
            ok = ok and fired
        all_ok &= ok
        err = max(err, int(diff.max()))
        raised = {name: int(fp[:, c].sum()) for c, name in enumerate(tsim.ORACLE_FLAGS)}
        print(f"  oracle_check {label} [{Wn} worlds x {N} steps x {J} links x "
              f"{obs.mask.shape[1]} obstacles]: {'ok' if ok else 'MISMATCH'} (worlds flagged "
              f"by the plain version {raised}; overlaps kernel {int(ok_.sum())} plain "
              f"{int(op.sum())}, max |d| per world {int(diff.max())}, triples within "
              f"{K6_MARGIN} m of the boundary {int(amb.sum())})")

    def kern():
        return ksim.oracle_check(robot, cfg, **inp)

    def plain():
        return tsim.oracle_check_plain(robot, cfg, logs, obs)

    from chip_probe import queued_ms

    ms = median_ms(kern, dev, TIMING_ITERS)
    dev_ms = queued_ms(kern, dev)
    pms = median_ms(plain, dev, TIMING_ITERS)
    # the function's work on the recorded move: FK once per logged state
    # (7 joint steps of 111 + one link centre of 18 per link), obstacle axes
    # once per (world, real obstacle), d per real triple, the axis tests the
    # data needs (60 each), the per-joint torque / bound / limit tests
    axes_needed = sat_axes_needed(robot, logs, obs)
    n_obs = int(obs.mask.sum())
    n_real = n_obs * N * J
    flops = (Wn * N * J * (111 + 18) + n_obs * 30 + n_real * 3 + axes_needed * 60
             + Wn * N * F * 10)
    fk, ok_ = kern()
    nbytes = _nbytes(*logs.values(), obs.centers, obs.generators, obs.mask, fk, ok_)
    print(f"  oracle_check: {axes_needed} axis tests over {n_real} real triples on the "
          f"logged move; kernel {ms:.4f} ms of CUDA-event time (before: "
          f"{BEFORE_MS['oracle_check']} ms), {dev_ms:.4f} ms of device time a call "
          f"(chip_probe.queued_ms), plain {pms:.2f} ms (medians of {TIMING_ITERS})")
    return all_ok, float(err), ms, pms, nbytes, flops, dev_ms


def clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def closed_loop_phase(robot, cfg, dev):
    """Phase 5: three lockstep iterations over the flagship worlds, counted."""
    from armour_tpu_torch import kernels
    from armour_tpu_torch.batch_sim import run_trials_batched
    from armour_tpu_torch.utils.timing import wall_s
    from armour_tpu_torch.worlds import load_world_csv

    worlds = [load_world_csv(p) for p in sorted(glob.glob("saved_worlds/random/*.csv"))[:N_WORLDS]]
    stats: dict = {}
    kernels.reset_counts()
    with kernels.capture() as captured:
        t_loop, summaries = wall_s(lambda: run_trials_batched(
            worlds, robot, cfg, max_iterations=LOOP_ITERATIONS, true_param_scale=1.0, seed=0,
            rescue_solver=True, guidance="straight", stats=stats), dev)
    launches = kernels.counts()
    keep = {k[0]: v for k, v in captured.items() if k[0] in ("rollout", "oracle_check")}
    captured.clear()
    n_it = stats["batch_iterations"]
    print(f"phase 5: W={N_WORLDS} closed loop, {n_it} lockstep iterations in {t_loop:.1f} s "
          f"(planner warm-up included); launches {launches}")
    for i, rec in enumerate(stats["iterations"]):
        rescue = "not fired" if rec["rescue_s"] is None else f"{rec['rescue_s'] * 1e3:.1f} ms"
        host = rec["iteration_s"] - rec["plan_s"] - (rec["rescue_s"] or 0.0) \
            - rec["rollout_s"] - rec["oracles_s"]
        print(f"  iteration {i}: plan {rec['plan_s'] * 1e3:.1f} ms, rescue {rescue}, "
              f"rollout (reference + K5) {rec['rollout_s'] * 1e3:.1f} ms, oracles (K6 + flags "
              f"to host) {rec['oracles_s'] * 1e3:.1f} ms, host left over {host * 1e3:.1f} ms")
    if n_it < 1:
        fail("the closed loop ran no iteration")
    for name in BERNSTEIN_KERNELS:
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the closed-loop path")
    no_k3(launches, "the closed-loop path")
    for name in ("rollout", "oracle_check"):
        if launches[name] != n_it:
            fail(f"kernel {name} launched {launches[name]} times in {n_it} iterations")
        if name not in keep:
            fail(f"kernel {name} was not recorded")
    flagged = [i for i, s in enumerate(summaries)
               if s.collision or s.torque_exceeded or s.ultimate_bound_exceeded
               or s.joint_limit_exceeded]
    if flagged:
        fail(f"worlds {flagged} raised a safety flag under worst-case true parameters")
    buckets = {"goal": sum(s.goal_reached for s in summaries),
               "stuck": sum(s.stuck for s in summaries),
               "active": sum(not (s.goal_reached or s.stuck) for s in summaries)}
    print(f"  no world raised a safety flag; after {n_it} iterations {buckets}; "
          f"infeasible plans {sum(s.infeasible_plans for s in summaries)}, rescued "
          f"{stats['recovered_rows']}/{stats['rescued_rows']} rows in "
          f"{stats['rescue_iterations']} rescue iterations")
    return launches, keep, stats, t_loop, buckets


def closed_loop_kernel_rows(robot, cfg, launches, inputs, dev, label="phase 6"):
    """Phase 6 (and phase 14 (ii) at J = 9): the K5 and K6 rows of the
    kernels line."""
    print(f"{label}: K5 and K6 against their plain versions on the recorded inputs")
    inp = inputs["rollout"]
    ok5, err5, ms5, pms5, bytes5 = check_rollout(robot, cfg, inp, dev, "robust", timed=True)
    for label, x in rollout_variants(inp, dev, K5_VARIANT_STEPS):
        ok, err, _, _, _ = check_rollout(robot, cfg, x, dev, label, timed=False)
        ok5 &= ok
        err5 = max(err5, err)
    Wn, n, _ = inp["q_des"].shape
    flops5, serial5 = k5_work(robot, n, Wn, inp["substeps"], inp["noise"] is not None,
                              clock_mhz())
    ok6, err6, ms6, pms6, bytes6, flops6, dev6 = check_oracles(robot, cfg,
                                                               inputs["oracle_check"], dev)
    rows = []
    for name, err, ms, pms, nbytes, flops in (("rollout", err5, ms5, pms5, bytes5, flops5),
                                               ("oracle_check", err6, ms6, pms6, bytes6, flops6)):
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_FP32_FLOP_PER_S * 1e3
        src, rep = REPLACES[name]
        row = {"name": name, "route": "cuda", "source": src, "replaces": rep,
               "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": pms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": None, "variants": 1,
               "compared_inputs": 4 if name == "rollout" else 5}
        if name == "rollout":
            row["serial_chain_ms"] = serial5
        else:
            row["device_ms"] = dev6
        rows.append(row)
    print(f"  K5 bound: {flops5 / 1e9:.3f} GFLOP -> {rows[0]['bound_ms']:.4f} ms at 67 TFLOP/s; "
          f"serial-chain estimate {serial5:.3f} ms (the row's bound_ms is the operations bound)")
    print(f"  K6 bound: {flops6 / 1e9:.3f} GFLOP -> {rows[1]['bound_ms']:.4f} ms")
    if not (ok5 and ok6):
        fail("a closed-loop kernel disagrees with its plain version")
    return rows


# ---------------------------------------------------------------------------
# the solver: fused against plain, the rescue profile, the real-time planner
# ---------------------------------------------------------------------------


def device_timeline(fn, dev) -> list:
    """(name, device us) of every device activity of one call of fn, in
    start order (torch.profiler; a warm-up call, then the recorded one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize(dev)
            prof.step()
    ev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                 and not e.name.startswith("ProfilerStep")), key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us()) for e in ev]


def _is_alm(name: str) -> bool:
    return any(p in name for p in ("k7_", "k8_", "k14_"))


def solve_window(timeline) -> dict:
    """Checks that between the solve's first K8 activity and the full-set
    check (the last K7 / K8 activity before its K4 launch) only K7 and K8
    ran, but K14's cull and the cull's violation sum (its torch ops,
    between the cull's K8 call and K14's cull), and that the whole solve
    launched K14 at most twice (the cull and the selection); returns the
    counts."""
    names = [n for n, _ in timeline]
    first = next((i for i, n in enumerate(names) if "k8_" in n), None)
    sel = max((i for i, n in enumerate(names) if "k14_select" in n), default=None)
    k4 = max((i for i, n in enumerate(names[:sel or 0]) if "k4_" in n), default=None)
    if first is None or sel is None or k4 is None:
        fail("the fused solve's profile shows no K8, no K4 before K14's selection or no "
             "selection")
    last = max(i for i in range(first, k4) if _is_alm(names[i]))
    allowed = set()
    for c in (i for i, n in enumerate(names) if "k14_cull" in n):
        j = c - 1
        while j > first and not _is_alm(names[j]):
            allowed.add(j)
            j -= 1
    others = [i for i in range(first, last + 1) if not _is_alm(names[i])]
    bad = sorted({names[i][:90] for i in others if i not in allowed})
    bad += sorted({names[i][:90] for i in range(first, last + 1)
                   if "k14_" in names[i] and "k14_cull" not in names[i]})
    cull_ops = [names[i][:60] for i in sorted(allowed)]
    if bad or len(cull_ops) > 4:
        fail(f"the fused solve ran other device work between its first K8 call and the full-set "
             f"check: {bad or cull_ops}")
    k14 = sum("k14_" in n for n in names)
    if k14 > 2:
        fail(f"the fused solve launched K14 {k14} times: its phases but the cull and the "
             f"selection belong in K7's / K8's finish")
    return {"window_activities": last + 1 - first, "window_cull_sum_ops": len(cull_ops),
            "solve_k14_device_launches": k14}


def finish_ms(timeline) -> float:
    """Device ms of the K7 / K8 finish kernels in a solve's timeline."""
    return sum(us for n, us in timeline if "k7_finish" in n or "k8_finish" in n) / 1e3


def solve_profile(fn, dev, wall_s, label) -> tuple:
    """The solve's device activities by name, their count, device time and
    busy share of the solve's wall time."""
    tl = device_timeline(fn, dev)
    by = {}
    for n, us in tl:
        key = n.split("(")[0][:70]
        c = by.setdefault(key, [0, 0.0])
        c[0] += 1
        c[1] += us / 1e3
    dev_ms = sum(us for _, us in tl) / 1e3
    print(f"  {label}: {len(tl)} device activities, {dev_ms:.2f} ms of device time, busy "
          f"{dev_ms / (wall_s * 1e3):.3f} of {wall_s * 1e3:.1f} ms; by name:")
    for key, (n, ms) in sorted(by.items(), key=lambda x: -x[1][0])[:14]:
        print(f"    x{n:5d} {ms:8.3f} ms  {key}")
    return tl, {"activities": len(tl), "device_ms": dev_ms, "busy": dev_ms / (wall_s * 1e3)}


def solver_phase(prob, cfg, basis, dev) -> dict:
    """The solve with K7 / K8 / K14 (fused) against the eager solve (K7 /
    K8 and the plain bookkeeping) and the plain solve (the plain rows too)
    on the card, same problem, timed in turns (host clock to a sync, median
    of 3): the fused solve gives the eager solve's k, feasible, cost and
    viol bit for bit, from all starts and from one (k0 = 0); the plain
    solve the same feasible count, and every feasible k of the fused solve
    passes the plain full-set check; the fused and the eager solve
    profiled (activities by name, busy share), and the fused solve's
    activities between its first K8 call and the full-set check must be
    K7 / K8 and K14's cull (but the cull's sum), K14 launched at most
    twice; K14's device time is its two launches and what its phases add
    to the K7 / K8 finish kernels (fused less eager).  The single-seed
    path's K7 / K8 / K14 calls are recorded and held against their plain
    versions."""
    from armour_tpu_torch import kernels, nlp
    from armour_tpu_torch.collision import collision_constraints_plain
    from armour_tpu_torch.utils.timing import wall_s

    modes = {"fused": {}, "eager": {"eager": True}, "plain": {"plain": True}}
    times = {m: [] for m in modes}
    res = {}
    for m in ("fused", "eager", "plain", "plain", "eager", "fused", "fused", "eager", "plain"):
        t, res[m] = wall_s(lambda kw=modes[m]: nlp.solve(prob, cfg, basis, **kw), dev)
        times[m].append(t)
    fused, eager, ref = res["fused"], res["eager"], res["plain"]
    same = {f: _bits(getattr(fused, f), getattr(eager, f)) for f in ("k", "feasible", "cost",
                                                                      "viol")}
    k0 = torch.zeros_like(prob.q_des)
    kernels.reset_counts()
    with kernels.capture() as cap:
        one = nlp.solve(prob, cfg, basis, k0=k0)
    n_one = kernels.counts()
    one_e = nlp.solve(prob, cfg, basis, k0=k0, eager=True)
    same_one = all(_bits(getattr(one, f), getattr(one_e, f))
                   for f in ("k", "feasible", "cost", "viol"))
    n_f, n_p = int(fused.feasible.sum()), int(ref.feasible.sum())
    k_chk = torch.where(fused.feasible[:, None], fused.k, torch.zeros_like(fused.k))[:, None]
    v = torch.stack(nlp.max_violations(k_chk, prob, cfg, basis,
                                       collision_fn=collision_constraints_plain), dim=-1)[:, 0]
    cert = nlp.viol_feasible(v, cfg)
    both = fused.feasible & ref.feasible
    dcost = float((fused.cost - ref.cost)[both].abs().max()) if bool(both.any()) else 0.0
    t = {m: statistics.median(x) for m, x in times.items()}
    print(f"  solve: fused (K7 / K8 / K14) {t['fused'] * 1e3:.1f} ms, eager (K7 / K8, the plain "
          f"bookkeeping) {t['eager'] * 1e3:.1f} ms, plain {t['plain'] * 1e3:.1f} ms (medians of "
          f"3); fused against eager bit for bit: {same}; from one start (k0 = 0, K14 x"
          f"{n_one['alm_loop']}): {same_one}; feasible {n_f} (plain {n_p}); the fused solve's "
          f"feasible k all certified by the plain full-set check: "
          f"{bool(cert[fused.feasible].all())}; max |d cost| against plain {dcost:.3g} over "
          f"{int(both.sum())} worlds feasible in both; verdicts differ in "
          f"{int((fused.feasible != ref.feasible).sum())}")
    if not all(same.values()) or not same_one:
        fail(f"the fused solve differs from the eager solve: {same}, one start {same_one}")
    if n_f != n_p:
        fail(f"the fused solve finds {n_f} feasible worlds, the plain solve {n_p}")
    if not bool(cert[fused.feasible].all()):
        fail("the plain full-set check rejects a feasible k of the fused solve")
    check_alm_captures(cap, dev, "single-seed path (k0)")
    cap.clear()
    kernels.reset_counts()
    nlp.solve(prob, cfg, basis)
    n_solve = kernels.counts()
    host = n_solve["alm_newton"] + n_solve["alm_values"] + n_solve["alm_loop"]
    print(f"  fused solve: host launcher calls {host} (K7 {n_solve['alm_newton']}, K8 "
          f"{n_solve['alm_values']}, K14 {n_solve['alm_loop']}); K14's phases run in a K7 / K8 "
          f"finish: {sum(kernels.IN_FINISH.values())} ({dict(kernels.IN_FINISH)})")
    if n_solve["alm_loop"] > 2:
        fail(f"the fused solve launched K14 {n_solve['alm_loop']} times, not at most 2")
    for attempt in range(1, PROFILE_TRIES + 1):
        before = kernels.counts()
        tl, pf = solve_profile(lambda: nlp.solve(prob, cfg, basis), dev, t["fused"],
                               "fused solve")
        ran = {k: kernels.counts()[k] - before[k] for k in ("alm_values", "collision_rows",
                                                             "alm_loop")}
        missing = [key for key in ("k8_", "k4_", "k14_select") if not any(key in n for n, _ in tl)]
        if not missing:
            break
        # profile again only when an activity the launch counters say ran is
        # missing; solve_window fails on anything extra or out of order
        if min(ran.values()) == 0 or attempt == PROFILE_TRIES:
            fail(f"the fused solve's profile lacks {missing} (launches in the profiled calls: "
                 f"{ran})")
        print(f"  fused solve: profile {attempt} of {PROFILE_TRIES} lacks {missing} though they "
              f"were launched ({ran}); profiling again")
    window = solve_window(tl)
    print(f"  fused solve: {window['window_activities']} device activities from its first K8 "
          f"call to the full-set check, all K7 / K8 but K14's cull and "
          f"{window['window_cull_sum_ops']} of the cull's violation sum; K14 device launches "
          f"{window['solve_k14_device_launches']}")
    tl_e, pe = solve_profile(lambda: nlp.solve(prob, cfg, basis, eager=True), dev, t["eager"],
                             "eager solve")
    k14_own = sum(us for n, us in tl if "k14_" in n) / 1e3
    k14_in = finish_ms(tl) - finish_ms(tl_e)
    print(f"  K14 in one solve, device ms: its phases inside K7's / K8's finish {k14_in:.4f} "
          f"(the fused solve's finish kernels {finish_ms(tl):.4f} less the eager solve's "
          f"{finish_ms(tl_e):.4f}), its own launches {k14_own:.4f}; the eager solve's plain "
          f"bookkeeping {sum(us for n, us in tl_e if not _is_alm(n)) / 1e3:.4f} in "
          f"{sum(not _is_alm(n) for n, _ in tl_e)} activities (the max mode's and the full-set "
          f"check's included)")
    return {"solve_host_launcher_calls": host, "solve_k14_launches": n_solve["alm_loop"],
            "solve_k14_in_finish_device_ms": k14_in, "solve_k14_own_device_ms": k14_own,
            "solve_fused_ms": t["fused"] * 1e3, "solve_eager_ms": t["eager"] * 1e3,
            "solve_plain_ms": t["plain"] * 1e3, "solve_max_dcost": dcost,
            "solve_fused_activities": pf["activities"], "solve_fused_device_ms": pf["device_ms"],
            "solve_fused_busy": pf["busy"], "solve_eager_activities": pe["activities"],
            "solve_eager_device_ms": pe["device_ms"], "solve_eager_busy": pe["busy"], **window}


def rescue_phase(robot, cfg, basis, args_dev, obs_dev, dev, label="phase 7") -> None:
    """Phase 7: one solve at the rescue profile (strong_config: 8 x 6
    iterations, seeds 4 -> 2, 4 line-search alphas) over the flagship
    worlds; K7 / K8 against their plain versions at its shapes."""
    from armour_tpu_torch import kernels, nlp
    from armour_tpu_torch.planner import plan_problem, strong_config
    from armour_tpu_torch.utils.timing import wall_s

    strong = strong_config(cfg)
    kernels.reset_counts()
    with kernels.capture() as captured:
        prob = plan_problem(*args_dev, obs_dev, robot, strong, basis)
        t, res = wall_s(lambda: nlp.solve(prob, strong, basis), dev)
    n = kernels.counts()
    print(f"{label}: rescue-profile solve over W={N_WORLDS} in {t * 1e3:.1f} ms, "
          f"{int(res.feasible.sum())} feasible; K7 x{n['alm_newton']}, K8 x{n['alm_values']}, "
          f"K14 x{n['alm_loop']}, "
          f"K9 x{n['fk_chain']}, K10 x{n['rnea_chain']}, K12 x{n['jrs_bernstein']}, "
          f"K13 x{n['screen_collision']}, K15 x{n['reach_assembly']} (its reach sets and screen)")
    for name in ("alm_newton", "alm_values", "alm_loop", "fk_chain", "rnea_chain",
                 "jrs_bernstein", "screen_collision", "reach_assembly"):
        if n[name] == 0:
            fail(f"the rescue-profile plan did not launch {name}")
    no_k3(n, f"{label}'s plan")
    check_alm_captures(captured, dev, "rescue profile")
    check_chain_captures(captured, dev, "rescue profile")
    check_jrs_screen_captures(captured, dev, "rescue profile")
    captured.clear()


def realtime_phase(robot, cfg, one, dev, label="phase 8") -> dict:
    """Phase 8: make_realtime_planner calibrates on the card; batch-1
    latency through the calibrated step over the first N_LATENCY worlds,
    counted; K7 / K8 against their plain versions at the W = 1 shapes."""
    from armour_tpu_torch import kernels
    from armour_tpu_torch.planner import make_realtime_planner
    from armour_tpu_torch.utils.timing import wall_s

    kernels.reset_counts()
    with kernels.capture() as captured:
        t_cal, (step_rt, cal) = wall_s(lambda: make_realtime_planner(robot, cfg, verbose=True),
                                       dev)
        lats = [wall_s(lambda a=a: step_rt(*a), dev)[0] for a in one]
    n = kernels.counts()
    p50, p99 = float(np.percentile(lats, 50)), float(np.percentile(lats, 99))
    print(f"{label}: real-time calibration in {t_cal:.1f} s: {json.dumps(cal)}")
    print(f"  batch-1 through the calibrated step ({cal['outer_iters']} outer iterations) over "
          f"{len(one)} worlds: p50 {p50 * 1e3:.1f} ms, p99 {p99 * 1e3:.1f} ms against 500 ms; "
          f"fits_budget {cal['fits_budget']}; launches {n}")
    for name in BERNSTEIN_KERNELS:
        if n[name] == 0:
            fail(f"kernel {name} was not launched on the real-time path")
    no_k3(n, "the real-time path")
    check_alm_captures(captured, dev, "real-time path")
    check_chain_captures(captured, dev, "real-time path (W = 1)")
    check_jrs_screen_captures(captured, dev, "real-time path (W = 1)")
    captured.clear()
    return {"realtime_calibration": cal, "realtime_p50_ms": p50 * 1e3,
            "realtime_p99_ms": p99 * 1e3, "realtime_ok": p99 < 0.5}


# ---------------------------------------------------------------------------
# containment of numeric ground truth in K9's and K10's sets
# ---------------------------------------------------------------------------


def containment_phase(jrs, robot, cfg, basis, dev, label="phase 9") -> dict:
    """Phase 9: for the first N_CONTAIN worlds of the step, N_K sampled k
    per world at one sampled time inside every sub-interval: the numeric
    link centres (rnea_numeric.forward_kinematics) must lie in K9's sliced
    link hull, the numeric passivity RNEA torque (rnea_numeric.rnea, nominal
    parameters) in K10's sliced nominal band; the numeric link centres also
    in the centre set alone (shape generators at 0).  Ground truth and slicing in
    float64 on the card, from the kernels' float32 sets; CONTAIN_SLACK
    absorbs only the float64 slicing."""
    import dataclasses

    from armour_tpu_torch import bezier, rnea_numeric, trajectory
    from armour_tpu_torch.kernels import reach
    from armour_tpu_torch.pz.bpz import BPZ

    W = N_CONTAIN

    def first(p):
        return BPZ(coef=p.coef[:W], egen=p.egen[:W], rad=p.rad[:W])

    sub = dataclasses.replace(jrs, R=first(jrs.R), Rt=first(jrs.Rt), qd=first(jrs.qd),
                              qda=first(jrs.qda), qdda=first(jrs.qdda))
    u = reach.rnea_chain(sub, robot, cfg, basis)                   # [W, 2, T, F]
    frs, _ = reach.reach_assembly(reach.fk_chain(sub, robot, cfg, basis), u, robot, cfg, basis)
    T = cfg.num_time_steps
    g = torch.Generator(device="cpu").manual_seed(0)
    k = (2 * torch.rand((W, N_K, 7), generator=g, dtype=torch.float64) - 1).to(dev)
    s = ((torch.arange(T, dtype=torch.float64)[None, None]
          + torch.rand((W, N_K, T), generator=g, dtype=torch.float64)) / T).to(dev)
    tr = jrs.traj
    dur = cfg.duration
    sb = s[..., None]
    if tr.family == "armtd":
        # the constant-acceleration trajectory at k g_k (the set's own g_k)
        q0, qd0 = (x[:W].double()[:, None, None] for x in (tr.q0, tr.qd0))
        k_act = (k * tr.k_scale[:W].double()[:, None])[:, :, None]
        q, qd, qdd = trajectory._armtd_state(q0, qd0, None, k_act, sb * dur, cfg)
    else:
        q0, Tqd0, TTqdd0 = (x[:W].double()[:, None, None] for x in (tr.q0, tr.Tqd0, tr.TTqdd0))
        k_act = (k * torch.as_tensor(cfg.k_range, dtype=torch.float64, device=dev))[:, :, None]
        q = bezier.q_des(q0, Tqd0, TTqdd0, k_act, sb)              # [W, N_K, T, F]
        qd = bezier.qd_des(q0, Tqd0, TTqdd0, k_act, sb) / dur
        qdd = bezier.qdd_des(q0, Tqd0, TTqdd0, k_act, sb) / dur ** 2
    phi = basis.phi(k)                                             # [W, N_K, B]
    _, _, centers = rnea_numeric.forward_kinematics(robot, q)      # [W, N_K, T, J, 3]
    c = torch.einsum("wtjab,wnb->wntja", frs.center_coef.double(), phi)
    hull = (frs.shape_gens.double().abs().sum(-1) + frs.radius.double())[:, None]
    fk_margin = float(((centers - c).abs() - hull).max())
    # the link box's own centre takes the shape generators at 0: it lies in
    # the centre set alone (the k-polynomial and the radius), a far tighter test
    centre_margin = float(((centers - c).abs() - frs.radius.double()[:, None]).max())
    tau = rnea_numeric.rnea(robot, q, qd, qd, qdd)                 # [W, N_K, T, F]
    un = BPZ(coef=u.coef[:, 0].double(), egen=u.egen[:, 0].double(), rad=u.rad[:, 0].double())
    cu = torch.einsum("wtfb,wnb->wntf", un.coef, phi)
    ru = (un.egen.abs().sum(-1) + un.rad)[:, None]
    tau_margin = float(((tau - cu).abs() - ru).max())
    n = W * N_K * T
    print(f"{label}: containment over {W} worlds x {N_K} k x {T} sub-intervals ({n} sampled "
          f"states): worst numeric link centre outside K9's hull by {fk_margin:.4g} m and "
          f"outside its centre set (no shape generators) by {centre_margin:.4g} m, worst "
          f"numeric torque outside K10's nominal band by {tau_margin:.4g} Nm (<= 0 inside; "
          f"slack {CONTAIN_SLACK})")
    if max(fk_margin, centre_margin, tau_margin) > CONTAIN_SLACK:
        fail("a sampled true state lies outside K9's or K10's reachable set")
    return {"containment_states": n, "containment_fk_margin_m": fk_margin,
            "containment_centre_margin_m": centre_margin,
            "containment_torque_margin_nm": tau_margin}


# ---------------------------------------------------------------------------
# the entry points: the reference file interface and the solvability oracle
# ---------------------------------------------------------------------------


def _close(got, want, what, tol=ENTRY_TOL) -> float:
    got, want = np.asarray(got, float), np.asarray(want, float)
    if got.shape != want.shape:
        fail(f"{what}: shape {got.shape}, expected {want.shape}")
    ratio = float((np.abs(got - want) / (tol * (1.0 + np.abs(want)))).max()) if got.size else 0.0
    if not ratio <= 1.0:
        fail(f"{what} disagrees with the plain route (worst |d|/tol {ratio:.3g})")
    return ratio


def armour_io_phase(robot, cfg, dev) -> dict:
    """Phase 10a: plan_from_armour_in on the card for an armour.in written
    from the first reference scene; the five files in the reference layouts,
    their contents equal to the plain-route values on the card (K9, K10,
    K3, K4 replaced by their plain versions) within ENTRY_TOL, relative."""
    import os
    import tempfile

    from armour_tpu_torch import armour_io, kernels
    from armour_tpu_torch.worlds import load_world_csv, straight_line_waypoint

    path = sorted(glob.glob("saved_worlds/reference/*.csv"))[0]
    w = load_world_csv(path)
    data = armour_io.ArmourIn(
        q0=w.start, qd0=np.zeros(7), qdd0=np.zeros(7),
        q_des=straight_line_waypoint(w.start, w.goal, continuous=robot.continuous_joints),
        centers=w.obstacle_centers, generators=w.obstacle_generators)
    with tempfile.TemporaryDirectory() as tmp:
        in_path = os.path.join(tmp, "armour.in")
        armour_io.write_armour_in(in_path, data)
        armour_io.plan_from_armour_in(in_path, os.path.join(tmp, "warm"), robot, cfg)
        kernels.reset_counts()
        t0 = time.perf_counter()
        out = armour_io.plan_from_armour_in(in_path, os.path.join(tmp, "out"), robot, cfg)
        wall = time.perf_counter() - t0
        n = kernels.counts()
        od = os.path.join(tmp, "out")
        k_file, ms = armour_io.read_armour_out(os.path.join(od, "armour.out"))
        files = {name: np.loadtxt(os.path.join(od, name)) for name in (
            "armour_joint_position_center.out", "armour_joint_position_radius.out",
            "armour_control_input_radius.out", "armour_constraints.out")}
    for name in BERNSTEIN_KERNELS:
        if n[name] == 0:
            fail(f"kernel {name} was not launched by plan_from_armour_in")
    no_k3(n, "plan_from_armour_in")
    if not out["feasible"] or k_file is None:
        fail(f"plan_from_armour_in found no feasible plan for {path}")
    T, J = cfg.num_time_steps, robot.num_joints
    F, O = robot.num_factors, len(data.centers)
    ref = armour_io.frs_values(data, out["k"], robot, cfg, dev, plain=True)
    worst = max(
        _close(k_file, out["k"], "armour.out k", 1e-8),
        _close(files["armour_joint_position_center.out"],
               ref["link_centers"].reshape(T * J, 3), "link centres"),
        _close(files["armour_joint_position_radius.out"],
               np.concatenate([ref["link_generators"],
                               ref["link_radius"][..., None] * np.eye(3)], axis=-1)
               .reshape(T * J * 3, 6), "link generators and radii"),
        _close(files["armour_control_input_radius.out"], ref["torque_radius"],
               "control input radius"),
        _close(files["armour_constraints.out"], np.concatenate([
            ref["constraint_torque"].reshape(-1),
            np.transpose(ref["constraint_collision"][:, :, :O], (1, 0, 2)).reshape(-1),
            ref["constraint_state"]]), "constraints (torque, link-major collision, state)"))
    print(f"phase 10: plan_from_armour_in on {os.path.basename(path)} ({O} obstacles): "
          f"feasible, planner {out['millis']:.1f} ms (armour.out {ms:.1f}), whole call "
          f"{wall * 1e3:.1f} ms; the five files in the reference layouts, equal to the plain "
          f"route on the card (worst |d|/tol {worst:.3g}, tol {ENTRY_TOL} (1 + |value|)); "
          f"launches {n}")
    return {"armour_io_planner_ms": out["millis"], "armour_io_call_ms": wall * 1e3}


def rest_checker_phase(robot, cfg, args_dev, obs_dev, dev) -> dict:
    """Phase 10b: make_rest_frs_checker on the card over the starts and
    goals of the flagship worlds and a planted world (a box on world 0's
    start elbow); every margin's sign equal to the plain route's
    (solvability.rest_frs_margins with plain=True, batched), the planted
    one > 0."""
    import dataclasses

    from armour_tpu_torch import kernels, solvability
    from armour_tpu_torch.collision import pad_obstacles
    from armour_tpu_torch.hlp import _fk_points_batch
    from armour_tpu_torch.pz.basis import make_basis
    from armour_tpu_torch.worlds import load_world_csv

    worlds = [load_world_csv(p) for p in sorted(glob.glob("saved_worlds/random/*.csv"))[:N_WORLDS]]
    elbow = _fk_points_batch(robot, np.asarray(worlds[0].start)[None])[0][3]
    planted = dataclasses.replace(worlds[0], obstacle_centers=np.asarray([elbow]),
                                  obstacle_generators=np.diag([0.15] * 3)[None])
    rest = solvability.make_rest_frs_checker(robot, cfg=cfg)
    rest(planted.start, planted)
    kernels.reset_counts()
    t0 = time.perf_counter()
    got = [rest(w.start, w) for w in worlds] + [rest(w.goal, w) for w in worlds] \
        + [rest(planted.start, planted)]
    t_all = time.perf_counter() - t0
    n = kernels.counts()
    basis = make_basis(robot.num_factors, cfg.max_poly_degree)
    goals = torch.as_tensor(np.stack([w.goal for w in worlds]), dtype=cfg.dtype).to(dev)
    pl = pad_obstacles(planted.obstacle_centers, planted.obstacle_generators,
                       cfg.max_obstacles, cfg.dtype, device=dev)
    one = type(obs_dev)(centers=pl.centers[None], generators=pl.generators[None],
                        mask=pl.mask[None])
    ref = torch.cat([solvability.rest_frs_margins(args_dev[0], obs_dev, robot, cfg, basis,
                                                  plain=True),
                     solvability.rest_frs_margins(goals, obs_dev, robot, cfg, basis,
                                                  plain=True),
                     solvability.rest_frs_margins(args_dev[0][:1], one, robot, cfg, basis,
                                                  plain=True)]).cpu().numpy()
    got = np.asarray(got)
    flips = int(np.sum((got > 0) != (ref > 0)))
    print(f"  rest-FRS checker on the card: {len(got)} margins (64 starts, 64 goals, 1 planted) "
          f"in {t_all:.2f} s ({t_all / len(got) * 1e3:.1f} ms each); {int((got > 0).sum())} > 0 "
          f"(plain route {int((ref > 0).sum())}); sign differs in {flips}; planted margin "
          f"{got[-1]:.4g} m (plain {ref[-1]:.4g}); max |d| {float(np.abs(got - ref).max()):.3g}; "
          f"launches {n}")
    for name in ("fk_chain", "rnea_chain", "collision_rows", "jrs_bernstein",
                 "screen_collision", "reach_assembly"):
        if n[name] == 0:
            fail(f"kernel {name} was not launched by the rest-FRS checker")
    no_k3(n, "the rest-FRS checker")
    if flips or not got[-1] > 0:
        fail("the rest-FRS checker's verdicts differ from the plain route's, or the planted "
             "obstacle was not caught")
    return {"rest_checker_ms_each": t_all / len(got) * 1e3,
            "rest_margins_positive": int((got > 0).sum())}


# ---------------------------------------------------------------------------
# a hard scenario through the "hard" mode's per-world function
# ---------------------------------------------------------------------------


def hard_phase(robot, cfg, dev) -> dict:
    """Phase 11: experiments.run_hard_world on hard_HARD_WORLD for
    HARD_ITERATIONS iterations, counted."""
    from armour_tpu_torch import kernels
    from armour_tpu_torch.experiments import run_hard_world
    from armour_tpu_torch.planner import make_planner, make_rescue_planner
    from armour_tpu_torch.scenarios import hard_scenario
    from armour_tpu_torch.utils.timing import wall_s

    step, rescue = make_planner(robot, cfg), make_rescue_planner(robot, cfg)
    kernels.reset_counts()
    t, res = wall_s(lambda: run_hard_world(HARD_WORLD, hard_scenario(HARD_WORLD), robot, cfg,
                                           step, rescue, np.random.default_rng(0),
                                           max_iterations=HARD_ITERATIONS), dev)
    counts = kernels.counts()
    s = res.summary
    flags = {f: getattr(s, f) for f in ("collision", "torque_exceeded",
                                        "ultimate_bound_exceeded", "joint_limit_exceeded")}
    print(f"phase 11: {res.world} for {s.iterations} iterations in {t:.1f} s (warm-up "
          f"included): bucket {res.bucket()}, {s.infeasible_plans} infeasible plans, "
          f"{s.rescued_plans} rescued, goal distance {s.goal_distance_final:.3f}, flags "
          f"{flags}; launches {counts}")
    for name in BERNSTEIN_KERNELS + ("rollout", "oracle_check"):
        if counts[name] == 0:
            fail(f"kernel {name} was not launched on the hard scenario")
    no_k3(counts, "the hard scenario")
    for name in OP_KERNELS:
        if counts[name] != 0:
            fail(f"kernel {name} was launched on the hard scenario")
    if any(flags.values()):
        fail(f"{res.world} raised a safety flag: {flags}")
    if s.iterations != HARD_ITERATIONS or len(s.planning_times) != HARD_ITERATIONS:
        fail(f"{res.world} ran {s.iterations} iterations, not {HARD_ITERATIONS}")
    return {"hard_world": res.world, "hard_iterations": s.iterations,
            "hard_bucket": res.bucket(), "hard_plan_ms": [x * 1e3 for x in s.planning_times]}


# ---------------------------------------------------------------------------
# the ARMTD family: K11 and K7 / K8's constant-acceleration branch
# ---------------------------------------------------------------------------


def check_jrs(name, inputs, dev):
    """K11 (name jrs_armtd) against build_jrs_armtd_plain, or K12
    (jrs_bernstein) against build_jrs_plain, on the card: the velocity PZs
    qd, qda, qdda and the trajectory scalars bit for bit; R's coef / egen /
    rad entries within TOL (1 + |plain entry|) (its cos / sin and 3x3
    products may round differently); a second call gives the same bits."""
    from armour_tpu_torch import armtd, jrs
    from armour_tpu_torch.kernels import jrs as kjrs

    if name == "jrs_armtd":
        q0, qd0, robot, cfg, basis = inputs
        qs = (q0, qd0)

        def kern():
            return kjrs.jrs_armtd(q0, qd0, robot, cfg, basis)

        def plain():
            return armtd.build_jrs_armtd_plain(q0, qd0, robot, cfg, basis)
    else:
        q0, qd0, qdd0, robot, cfg, basis = inputs
        qs = (q0, qd0, qdd0)

        def kern():
            return kjrs.jrs_bernstein(q0, qd0, qdd0, robot, cfg, basis)

        def plain():
            return jrs.build_jrs_plain(q0, qd0, qdd0, robot, cfg, basis)

    got, again, ref = kern(), kern(), plain()
    torch.cuda.synchronize(dev)
    rot = [(getattr(x.R, g) for x in (got, again, ref)) for g in ("coef", "egen", "rad")]
    exact_fields = [(getattr(getattr(x, f), g) for x in (got, again, ref))
                    for f in ("qd", "qda", "qdda") for g in ("coef", "egen", "rad")]
    exact_fields += [(getattr(x.traj, n) for x in (got, again, ref))
                     for n in ("qdd0", "Tqd0", "TTqdd0", "k_scale")]
    ratio, err, same, r_exact, v_exact = 0.0, 0.0, True, True, True
    for i, (a, b, r) in enumerate(rot + exact_fields):
        same &= torch.equal(a, b)
        eq = torch.equal(a, r)
        if i < len(rot):
            r_exact &= eq
        else:
            v_exact &= eq
        d = (a - r).abs()
        err = max(err, float(d.max()))
        ratio = max(ratio, float((d / (TOL * (1.0 + r.abs()))).max()))
    out_bytes = sum(_bpz_bytes(p) for p in (got.R, got.qd, got.qda, got.qdda)) \
        + 3 * _nbytes(got.traj.k_scale)
    Wn, T = got.R.rad.shape[:2]
    # per (world, sub-interval, factor): the element (K11 ~120; K12's bounds
    # of three parts at four points with powf ~600), the trig tail with its
    # four interval cos / sin (~4 x 20 + 60), four 3x3 products (216)
    flops = Wn * T * robot.num_factors * (480 if name == "jrs_armtd" else 960)
    return ratio <= 1.0 and same and v_exact, err, kern, plain, _nbytes(*qs) + out_bytes, \
        flops, (f"velocity PZs and trajectory scalars "
                f"{'bit for bit' if v_exact else 'DIFFER'}; R "
                f"{'bit for bit' if r_exact else f'worst |d| / (TOL (1 + |plain|)) {ratio:.3g}'}"
                f", max |d| {err:.3g}; a second call "
                f"{'gives the same bits' if same else 'DIFFERS'}")


def _screen_args(inputs):
    """A recorded K13 call as the plain version's arguments: the cells'
    link sets and obstacles, and K3's hyperplanes of them on the card."""
    from armour_tpu_torch import collision as col
    from armour_tpu_torch.kinematics import LinkFRS

    shape_gens, radius, centers, gens, center_coef, env, obs_mask, K, quota = inputs
    frs = LinkFRS(center_coef=center_coef, shape_gens=shape_gens, radius=radius)
    obs = col.ObstacleSet(centers=centers, generators=gens, mask=obs_mask)
    return col.build_hyperplanes(frs, obs), obs, frs, K, quota


def check_screen(inputs, dev):
    """K13 against screen_collision_plain on K3's hyperplanes of the same
    cells, on the card: the same rows in the same order and the same bits in
    every field; a second call gives the same bits.  K13 is passed the cells
    (no hyperplane tensor: its argument struct and the recorded call are
    checked).  Also returns the library call: torch.topk of the same K over
    the same [W, N] bound (the selection alone)."""
    from armour_tpu_torch import collision as col
    from armour_tpu_torch.kernels import collision as kcol

    shape_gens, radius, centers, gens, center_coef, env, obs_mask, K, quota = inputs
    hyp, obs, frs, _, _ = _screen_args(inputs)
    fields = {n for n, _ in kcol.K13Args._fields_}
    passed = [tuple(t.shape) for t in inputs if isinstance(t, torch.Tensor)]
    if fields & {"A", "d", "delta"} or {tuple(hyp.A.shape), tuple(hyp.d.shape)} & set(passed):
        fail("K13 is still passed a hyperplane tensor")

    def kern():
        return kcol.screen_collision(shape_gens, radius, centers, gens, center_coef, env,
                                     obs_mask, K, quota)

    def plain():
        return col.screen_collision_plain(hyp, obs, frs, K, quota)

    got, again, ref = kern(), kern(), plain()
    ref = (ref.A, ref.d, ref.delta, ref.row, ref.mask)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    exact = all(torch.equal(a, b) for a, b in zip(got, ref))
    err = max(float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
              for a, b in zip(got, ref))
    g_up, _ = col._screen_bound(hyp, obs, frs)
    ties = int(g_up.numel() - sum(torch.unique(x).numel() for x in g_up))
    torch.cuda.synchronize(dev)
    Wn, C, N = hyp.d.shape
    Kk = got[3].shape[1]
    TJ = center_coef.shape[1] * center_coef.shape[2]
    real = int(obs_mask.sum()) * TJ
    # the cells' inputs, p0, the outputs and the scratch bound g, each once
    nbytes = (_nbytes(shape_gens, radius, centers, gens, env, obs_mask, *got)
              + Wn * TJ * 3 * 4 + Wn * N * 4)
    flops = k13_operations(int((obs_mask.sum(1) > 0).sum()) * TJ, int(obs_mask.sum()), real,
                           Wn * Kk)
    library = lambda: torch.topk(g_up, Kk, dim=-1)   # noqa: E731
    return exact and same, err, kern, plain, nbytes, flops, \
        (f"K = {Kk}, quota {quota}: indices and every field "
         f"{'bit for bit' if exact else 'DIFFER'} against the plain screen of K3's "
         f"hyperplanes ({ties} tied bounds among {g_up.numel()}; {real} real rows); a second "
         f"call {'gives the same bits' if same else 'DIFFERS'}; passed the cells, no "
         f"hyperplane tensor"), library


# float32 operations of one hyperplane's parts in K13 (hyperplane_cell.cuh,
# screen_collision.cu; |x| and -x are operand modifiers and not counted)
K13_NORMAL = 20   # cross product 9, n2 5, the test, sqrt and division 3, scale 3
K13_TERM = 6      # one generator's |A . G_g| into delta: 3 mul, 2 add, the sum's add
K13_DOT = 5       # A . c (d) or A . p0
K13_SIDE = 15     # A . p0 5, r = sum_a |A_a| env_a 5, ok 3, +-(A . p0) - r 2
K13_PICK = 6      # +-d + delta 2, the two sides' differences 2, their running maxima 2


def k13_operations(cells, obstacles, real, chosen):
    """The least float32 operation count of K13's function: each part of a
    row's 36 hyperplanes counted once where it depends on less than the
    row.  Of the 9 generators, 3 are the obstacle's and 6 the link cell's:
    the 15 normals of link-generator pairs, their link terms of delta and
    their p0 / env side belong to the link cell (cells: the link cells of
    worlds with a real obstacle); the 3 normals of obstacle-generator pairs
    with their obstacle terms and d to the obstacle (obstacles: the real
    ones); the rest to the row (real: the real rows, bounded in pass (a);
    chosen: the rows whose hyperplanes pass (c) writes)."""
    per_cell = 15 * (K13_NORMAL + 6 * K13_TERM + K13_SIDE)
    per_obstacle = 3 * (K13_NORMAL + 3 * K13_TERM + K13_DOT)
    # the 18 mixed pairs whole; the link pairs' obstacle terms (+ 1 add to
    # join the link part) and d; the obstacle pairs' link terms (+ 1) and side
    built = (18 * (K13_NORMAL + 9 * K13_TERM + K13_DOT) + 15 * (3 * K13_TERM + 1 + K13_DOT)
             + 3 * (6 * K13_TERM + 1))
    per_row = built + 18 * K13_SIDE + 3 * K13_SIDE + 36 * K13_PICK
    return cells * per_cell + obstacles * per_obstacle + real * per_row + chosen * built


K4_QUERY = 9      # one (query, hyperplane): A . p 5, +-(A . p) - (+-d + delta) 2,
                  # the pos / neg running maxima 2
K4_PICK = 2       # one hyperplane's +-d + delta, shared by its queries


def k4_cell_operations(cells, obstacles, real, nq):
    """The least float32 operation count of K4's cell mode: each real row's
    36 hyperplanes with their shared parts counted once, as k13_operations
    counts them (the link pairs' normals and link terms of delta once per
    link cell, the obstacle pairs' once per obstacle, the rest per row; the
    normal's zero test is K13_NORMAL's n2 test), K4_PICK per (real row,
    hyperplane) and K4_QUERY per (real row, query, hyperplane).  A padded
    obstacle's rows are not formed."""
    per_cell = 15 * (K13_NORMAL + 6 * K13_TERM)
    per_obstacle = 3 * (K13_NORMAL + 3 * K13_TERM + K13_DOT)
    built = (18 * (K13_NORMAL + 9 * K13_TERM + K13_DOT) + 15 * (3 * K13_TERM + 1 + K13_DOT)
             + 3 * (6 * K13_TERM + 1))
    return (cells * per_cell + obstacles * per_obstacle
            + real * (built + 36 * K4_PICK + nq * 36 * K4_QUERY))


def screen_variants(inputs):
    """K13's inputs with an obstacle quota of 8, and with planted ties:
    every odd obstacle slot a copy of the even one before it (centre,
    generators and mask), so that rows tie in pairs; both at quota 0 and 8."""
    shape_gens, radius, centers, gens, center_coef, env, obs_mask, K, quota = inputs
    if obs_mask.shape[1] % 2:
        fail("the planted-tie copy takes an even obstacle count")

    def pair(x):
        y = x.clone()
        y[:, 1::2] = y[:, 0::2]
        return y

    cells = (shape_gens, radius)
    tied = cells + (pair(centers), pair(gens), center_coef, env, pair(obs_mask))
    return [("quota 8", inputs[:7] + (K, 8)),
            ("planted ties", tied + (K, 0)), ("planted ties, quota 8", tied + (K, 8))]


def k15_geometry_of(inputs):
    """K15's launch geometry for a recorded call (kernels/reach.py:
    k15_geometry on this card)."""
    from armour_tpu_torch.kernels import reach as kreach

    links, u_both = inputs[0], inputs[1]
    Wn, T, J = links.rad.shape[:3]
    return kreach.k15_geometry(Wn, T, u_both.rad.shape[-1], 3 * J, links.coef.shape[-1],
                               links.egen.shape[-1], kreach._sms(links.rad))


def check_reach_assembly(inputs, dev):
    """K15 against its plain version (dynamics.reach_assembly_plain, or the
    one part's plain version) on the card: the shape generators, the link
    radii and the torque radius bit for bit, the same bits on a second call,
    u_coef and center_coef views of K10's and K9's outputs."""
    from armour_tpu_torch import dynamics, kinematics
    from armour_tpu_torch.kernels import reach as kreach

    links, u_both, robot, cfg, basis = inputs

    def kern():
        return kreach.reach_assembly(links, u_both, robot, cfg, basis)

    def plain():
        return (None if links is None else kinematics.reduce_links_plain(links, basis),
                None if u_both is None else dynamics.torque_assembly_plain(u_both, robot, cfg))

    got, again, ref = kern(), kern(), plain()
    torch.cuda.synchronize(dev)
    pairs = []
    if links is not None:
        pairs += [(got[0].shape_gens, again[0].shape_gens, ref[0].shape_gens),
                  (got[0].radius, again[0].radius, ref[0].radius)]
        views = got[0].center_coef.data_ptr() == links.coef.data_ptr()
    if u_both is not None:
        pairs.append((got[1].torque_radius, again[1].torque_radius, ref[1].torque_radius))
        views = got[1].u_coef.data_ptr() == u_both.coef.data_ptr() and (
            links is None or views)
    exact = all(torch.equal(a, c) for a, _, c in pairs)
    same = all(torch.equal(a, b) for a, b, _ in pairs)
    err = max(float((a - c).abs().max()) for a, _, c in pairs)
    nbytes = sum(_nbytes(a) for a, _, _ in pairs)
    flops = 0
    if links is not None:
        nbytes += _nbytes(links.egen, links.rad)
        flops += links.rad.numel() * 2 * (links.egen.shape[-1] - 3)
    if u_both is not None:
        nbytes += _bpz_bytes(u_both)
        B, E = u_both.coef.shape[-1], u_both.egen.shape[-1]
        per = 3 * (B - 1) + 3 * E + 2 * E + 16          # the sums, lo / hi, the radius
        flops += (u_both.rad.numel() // 2) * per + u_both.rad[:, 0, :, 0].numel() * 8
    return exact and same and views, err, kern, plain, nbytes, flops, \
        (f"links {None if links is None else tuple(links.rad.shape)}, u_both "
         f"{None if u_both is None else tuple(u_both.rad.shape)}: every output "
         f"{'bit for bit' if exact else 'DIFFERS'}; a second call "
         f"{'gives the same bits' if same else 'DIFFERS'}; u_coef / center_coef "
         f"{'views' if views else 'COPIES'}")


SCREEN_ENVELOPE_OPS = ("AbsFunctor", "sum_functor")   # collision.screen_envelope's torch ops


def reach_window(fn, dev, label, between=("k15_",)) -> dict:
    """The reach sets' device activities of one call of fn: from K10's
    launch to K13's first only the kernels `between` may run, once each and
    in that order (K15; K15 then K16 with grasp rows), then the screen's
    envelope (two torch ops, K13's input): no K3 among them.  Returns the
    window's names."""
    from armour_tpu_torch import kernels

    for attempt in range(1, PROFILE_TRIES + 1):
        before = kernels.counts()
        names = [n for n, _ in device_timeline(fn, dev)]
        ran = {k: kernels.counts()[k] - before[k] for k in ("rnea_chain", "screen_collision")}
        i10 = [i for i, n in enumerate(names) if "k10_" in n]
        i13 = [i for i, n in enumerate(names) if "k13_bound" in n]
        if len(i10) == 1 and len(i13) == 1 and i13[0] > i10[0]:
            break
        # profile again only when an activity is missing that the launch
        # counters say ran; an extra activity or the wrong order fails
        lost = (not i10 or not i13) and len(i10) <= 1 and len(i13) <= 1 and min(ran.values()) > 0
        if not lost or attempt == PROFILE_TRIES:
            fail(f"{label}: expected one K10 then one K13 activity, got {len(i10)} / {len(i13)} "
                 f"(launched {ran['rnea_chain']} / {ran['screen_collision']} in the profiled "
                 f"calls)")
        print(f"  {label}: profile {attempt} of {PROFILE_TRIES} holds {len(i10)} K10 / "
              f"{len(i13)} K13 activities though both were launched; profiling again")
    window = names[i10[0] + 1:i13[0]]
    print(f"  {label}: {len(names)} device activities in the reach sets; from K10 to K13: "
          f"{[n[:40] for n in window]}")
    # K13's input env (collision.screen_envelope: torch's abs, then its sum)
    # is formed just before K13
    env = window[len(between):]
    if (len(env) > len(SCREEN_ENVELOPE_OPS)
            or not all(b in n for b, n in zip(between, window[:len(between)]))
            or not all(any(e in n for e in SCREEN_ENVELOPE_OPS) for n in env)):
        fail(f"{label}: other device work than {between} and the screen's envelope between "
             f"K10 and K13: {window}")
    if any("k3_" in n for n in names):
        fail(f"{label}: K3 ran in the reach sets")
    return {"reach_activities": len(names), "k10_to_k13": [n[:40] for n in window]}


def check_jrs_screen_captures(captured, dev, label) -> None:
    """K12 / K13 / K15 against their plain versions on every shape recorded
    on a path other than the main one, both timed; fails on a mismatch."""
    from armour_tpu_torch.utils.timing import median_ms

    n, all_ok = set(), True
    for (name, key), inputs in captured.items():
        if name == "jrs_bernstein":
            ok, _, kern, plain, nbytes, _, note = check_jrs(name, inputs, dev)
        elif name == "screen_collision":
            ok, _, kern, plain, nbytes, _, note, _ = check_screen(inputs, dev)
        elif name == "reach_assembly":
            ok, _, kern, plain, nbytes, _, note = check_reach_assembly(inputs, dev)
        else:
            continue
        ms, pms = median_ms(kern, dev, TIMING_ITERS), median_ms(plain, dev, TIMING_ITERS)
        print(f"  {name} {key}: {'ok' if ok else 'MISMATCH'} ({note}); kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms (medians of {TIMING_ITERS}), {nbytes / 1e6:.1f} MB")
        all_ok &= ok
        n.add(name)
    if n != {"jrs_bernstein", "screen_collision", "reach_assembly"}:
        fail(f"K12, K13 and K15 were not all recorded on the {label}")
    if not all_ok:
        fail(f"K12 / K13 / K15 disagree with their plain versions on the {label}")


def armtd_inputs(q0, cfg, n, dev):
    """Phase 12's start velocities: seeded uniform in +-ARMTD_QD0 rad/s, so
    that g_k takes both its floor pi/24 and the adaptive |qd0| / 3."""
    rng = np.random.default_rng(ARMTD_SEED)
    return torch.as_tensor(rng.uniform(-ARMTD_QD0, ARMTD_QD0, (n, q0.shape[1])),
                           dtype=cfg.dtype).to(dev)


def armtd_phase(robot, cfg, basis, q0, q_des, obs, dev, bern_step_s) -> tuple:
    """Phase 12: the ARMTD family at the flagship width.  A W = 64 step
    counted (K11 once, K4, K7, K8, K9, K10, neither K1, K2 nor K3), every
    recorded kernel call against its plain version, the full-set check and
    the fused-vs-plain solve, containment, three closed-loop iterations with
    rescue, batch-1 latency.  Returns (K11's kernels-line row, numbers)."""
    import dataclasses

    from armour_tpu_torch import kernels, nlp
    from armour_tpu_torch.batch_sim import run_trials_batched
    from armour_tpu_torch.collision import ObstacleSet, collision_constraints_plain
    from armour_tpu_torch.planner import make_batch_planner, make_planner, plan_problem
    from armour_tpu_torch.utils.timing import median_ms, wall_s
    from armour_tpu_torch.worlds import load_world_csv

    cfg_a = dataclasses.replace(cfg, traj_family="armtd")
    q0d = torch.as_tensor(q0, dtype=cfg.dtype).to(dev)
    qd0 = armtd_inputs(q0d, cfg, N_WORLDS, dev)
    qdd0 = torch.zeros_like(q0d)
    q_des_d = torch.as_tensor(q_des, dtype=cfg.dtype).to(dev)
    obs_d = ObstacleSet(centers=obs.centers.to(dev), generators=obs.generators.to(dev),
                        mask=obs.mask.to(dev))
    step = make_batch_planner(robot, cfg_a)
    args = (q0d, qd0, qdd0, q_des_d, obs_d)
    with kernels.capture() as captured:
        t_first, _ = wall_s(lambda: step(*args), dev)
    kernels.reset_counts()
    t_main, res = wall_s(lambda: step(*args), dev)
    launches, dlaunches = kernels.counts(), kernels.device_counts()
    gk = (qd0.abs() / 3.0).clamp(min=math.pi / 24, max=math.pi / 3)
    print(f"phase 12: ARMTD family (traj_family='armtd'), start velocities seeded in "
          f"+-{ARMTD_QD0} rad/s ({int((gk > math.pi / 24).sum())} of {gk.numel()} factors "
          f"above g_k's floor): W={N_WORLDS} step {t_main * 1e3:.1f} ms (first call "
          f"{t_first * 1e3:.1f} ms); launches {launches}")
    if launches["jrs_armtd"] != 1 or launches["jrs_bernstein"] != 0:
        fail(f"K11 launched {launches['jrs_armtd']} times and K12 {launches['jrs_bernstein']} "
             f"times in one ARMTD step (once and never)")
    for name in STEP_KERNELS:
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the ARMTD step")
    no_k3(launches, "the ARMTD step")
    for name in OP_KERNELS:
        if launches[name] != 0:
            fail(f"kernel {name} was launched on the ARMTD step")

    # every recorded call against its plain version, each kernel twice (K3
    # by a direct call on the step's cells)
    add_direct_k3(captured)
    check = {"jrs_armtd": lambda x, d: check_jrs("jrs_armtd", x, d),
             "build_hyperplanes": check_hyperplanes, "collision_rows": check_rows,
             "screen_collision": lambda x, d: check_screen(x, d)[:7],
             "reach_assembly": check_reach_assembly}
    sums = {}
    k11 = None
    all_ok = True
    for (name, key), inputs in captured.items():
        if name in ("fk_chain", "rnea_chain"):
            res_c = check_chain(name, inputs, dev)
        elif name in ALM_KERNELS:
            res_c = check_alm(name, key, inputs, dev)
        elif name in check:
            res_c = check[name](inputs, dev)
        else:
            continue
        ok, err, kern, plain, nbytes, flops, note = res_c
        ms, pms = kernel_ms(kern, dev), median_ms(plain, dev, TIMING_ITERS)
        print(f"  {name} {key}: {'ok' if ok else 'MISMATCH'} ({note}); kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms, {nbytes / 1e6:.1f} MB")
        all_ok &= ok
        sm = sums.setdefault(name, [0.0, 0.0, 0])
        sm[0] += ms
        sm[1] += pms
        sm[2] += 1
        if name == "jrs_armtd":
            t_bytes = nbytes / H100_BYTES_PER_S * 1e3
            t_ops = flops / H100_FP32_FLOP_PER_S * 1e3
            src, rep = REPLACES[name]
            k11 = {"name": name, "route": "cuda", "source": src, "replaces": rep,
                   "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": pms,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": None, "variants": 1, "device_launches": dlaunches[name]}
    jrs = next(v[0] for kk, v in captured.items() if kk[0] == "rnea_chain")
    captured.clear()
    if not all_ok:
        fail("a kernel disagrees with its plain version on the ARMTD step")
    if k11 is None or any(n not in sums for n in ALM_KERNELS):
        fail("the ARMTD step recorded no K11 / K7 / K8 / K14 call")
    print("  ARMTD step kernels, ms summed over their shapes (kernel / plain): " + ", ".join(
        f"{n} {v[0]:.4f} / {v[1]:.4f} ({v[2]} shapes)" for n, v in sums.items()))

    # results: the full-set check, fused against plain
    k, feas = res.k, res.feasible
    kf = k[feas]
    if not bool(torch.isfinite(kf).all()) or bool((kf.abs() > 1.0 + 1e-6).any()):
        fail("a feasible ARMTD k is not finite or leaves [-1, 1]")
    if bool(torch.isfinite(k[~feas]).any()):
        fail("an infeasible ARMTD world returned a finite k")
    prob = plan_problem(q0d, qd0, qdd0, q_des_d, obs_d, robot, cfg_a, basis)
    k_chk = torch.where(feas[:, None], k, torch.zeros_like(k))[:, None]
    v = torch.stack(nlp.max_violations(k_chk, prob, cfg_a, basis,
                                       collision_fn=collision_constraints_plain), dim=-1)[:, 0]
    cert = nlp.viol_feasible(v, cfg_a)
    if not bool(cert[feas].all()):
        fail(f"the plain full-set check rejects feasible ARMTD worlds "
             f"{torch.nonzero(feas & ~cert).flatten().tolist()}")
    n_feas = int(feas.sum())
    print(f"  {n_feas}/{N_WORLDS} ARMTD worlds feasible; every feasible k passes the plain "
          f"full-set check")
    solve_cmp = solver_phase(prob, cfg_a, basis, dev)
    del prob

    t_steps = [wall_s(lambda: step(*args), dev)[0] for _ in range(3)]
    t_step = statistics.median(t_steps)
    breakdown = profile_step(lambda: step(*args), dev, t_step)
    print(f"  ARMTD W={N_WORLDS} step {t_step * 1e3:.1f} ms (median of 3) beside the Bernstein "
          f"step {bern_step_s * 1e3:.1f} ms (phase 4, this call)")
    window = reach_window(lambda: plan_problem(q0d, qd0, qdd0, q_des_d, obs_d, robot, cfg_a,
                                               basis), dev, f"ARMTD reach sets, W={N_WORLDS}")
    print("  ARMTD step, device ms of one step: " + ", ".join(
        f"{n} {breakdown.get('hand_device_ms', {}).get(n, float('nan')):.4f}"
        for n in ("screen_collision", "reach_assembly")) + "; K13's passes " + ", ".join(
        f"{k} {v:.4f}" for k, v in breakdown.get("k13_pass_ms", {}).items()))

    # containment of sampled ARMTD states in K9's / K10's sets
    contain = containment_phase(jrs, robot, cfg_a, basis, dev, label="  phase 12")
    del jrs

    # three closed-loop iterations with rescue, counted
    worlds = [load_world_csv(p) for p in sorted(glob.glob("saved_worlds/random/*.csv"))[:N_WORLDS]]
    stats: dict = {}
    kernels.reset_counts()
    t_loop, summaries = wall_s(lambda: run_trials_batched(
        worlds, robot, cfg_a, max_iterations=ARMTD_ITERATIONS, true_param_scale=1.0, seed=0,
        rescue_solver=True, guidance="straight", stats=stats), dev)
    loop_counts = kernels.counts()
    flagged = [i for i, x in enumerate(summaries)
               if x.collision or x.torque_exceeded or x.ultimate_bound_exceeded
               or x.joint_limit_exceeded]
    n_it = stats["batch_iterations"]
    print(f"  ARMTD closed loop: W={N_WORLDS}, {n_it} lockstep iterations with rescue in "
          f"{t_loop:.1f} s (warm-up included); launches {loop_counts}; infeasible plans "
          f"{sum(x.infeasible_plans for x in summaries)}, rescued {stats['recovered_rows']}/"
          f"{stats['rescued_rows']} rows; safety flags in worlds {flagged}")
    if n_it != ARMTD_ITERATIONS:
        fail(f"the ARMTD closed loop ran {n_it} iterations, not {ARMTD_ITERATIONS}")
    for name in ("jrs_armtd", "rollout", "oracle_check") + STEP_KERNELS:
        if loop_counts[name] == 0:
            fail(f"kernel {name} was not launched on the ARMTD closed loop")
    no_k3(loop_counts, "the ARMTD closed loop")
    if flagged:
        fail(f"ARMTD worlds {flagged} raised a safety flag under worst-case true parameters")

    # batch-1 latency
    step1 = make_planner(robot, cfg_a)
    one = [(q0d[i], qd0[i], qdd0[i], q_des_d[i], obs_slice(obs_d, i)) for i in range(N_LATENCY)]
    wall_s(lambda: step1(*one[0]), dev)
    lats = [wall_s(lambda a=a: step1(*a), dev)[0] for a in one]
    p50, p99 = float(np.percentile(lats, 50)), float(np.percentile(lats, 99))
    print(f"  ARMTD batch-1 over {N_LATENCY} worlds: p50 {p50 * 1e3:.1f} ms, p99 "
          f"{p99 * 1e3:.1f} ms against 500 ms")
    perf = {"armtd_step_ms": t_step * 1e3, "armtd_feasible": n_feas,
            "armtd_launches": {n: launches[n] for n in ("jrs_armtd",) + STEP_KERNELS},
            "armtd_kernel_ms": {n: v[0] for n, v in sums.items()},
            "armtd_plain_ms": {n: v[1] for n, v in sums.items()},
            "armtd_latency_batch1_p50_ms": p50 * 1e3, "armtd_latency_batch1_p99_ms": p99 * 1e3,
            "armtd_batch1_ok": p99 < 0.5, "armtd_loop_iterations": n_it,
            "armtd_loop_wall_s": t_loop,
            **{f"armtd_{kk}": vv for kk, vv in solve_cmp.items()},
            **{f"armtd_{kk}": vv for kk, vv in contain.items()},
            **{f"armtd_{kk}": vv for kk, vv in breakdown.items()},
            **{f"armtd_{kk}": vv for kk, vv in window.items()}}
    return k11, perf


# ---------------------------------------------------------------------------
# the grasp path: the Kinova with the dumbbell payload, K16, the zoo
# ---------------------------------------------------------------------------


def k16_work(Wn, T, B, E, P) -> tuple:
    """(bytes, float32 operations) K16 must move and do at W worlds, T steps:
    it reads the five wrench components it uses (B + E + 1 floats each) and
    writes three rows (B + 1 floats each) per (world, step); per square 6
    operations a pair (the product and its sum, two abs, their product and
    its sum), the abs sums of coef and egen, in_abs, egen, the radius and
    the slop term; then the rows' sums and scales and their reductions."""
    per_bytes = 4 * (5 * (B + E + 1) + 3 * (B + 1))
    per_ops = 5 * (6 * P + 5 * B + 7 * E + 18) + 7 * B + 13 * E + 8
    return Wn * T * per_bytes, Wn * T * per_ops


def k16_geometry_of(inputs):
    """K16's launch geometry for a recorded call (kernels/grasp.py:
    k16_geometry on this card)."""
    from armour_tpu_torch.kernels import grasp as kgrasp

    f_c = inputs[0]
    return kgrasp.k16_geometry(f_c.rad.shape[0], f_c.rad.shape[2],
                               f_c.coef.shape[-1] + f_c.egen.shape[-1] + 1,
                               torch.cuda.get_device_properties(f_c.rad.device)
                               .multi_processor_count)


def check_grasp(inputs, dev):
    """K16 against grasp_rows_plain on the same CUDA inputs: g_coef and g_rad
    bit for bit (the same operations in the same order), and a second call
    the same bits."""
    from armour_tpu_torch import grasp
    from armour_tpu_torch.kernels import grasp as kgrasp

    f_c, n_c, params, cfg, basis = inputs

    def kern():
        return kgrasp.grasp_rows(f_c, n_c, params, cfg, basis)

    def plain():
        return grasp.grasp_rows_plain(f_c, n_c, params, cfg, basis)

    got, again, want = kern(), kern(), plain()
    torch.cuda.synchronize(dev)
    bits = _bits(got.g_coef, want.g_coef) and _bits(got.g_rad, want.g_rad)
    same = _bits(got.g_coef, again.g_coef) and _bits(got.g_rad, again.g_rad)
    finite = bool(torch.isfinite(got.g_coef).all()) and bool(torch.isfinite(got.g_rad).all())
    err = max(float((got.g_coef - want.g_coef).abs().max()),
              float((got.g_rad - want.g_rad).abs().max()))
    Wn, _, T = f_c.rad.shape[:3]
    nbytes, flops = k16_work(Wn, T, basis.size, f_c.egen.shape[-1], len(basis.pair_i))
    note = (f"mu {params.mu}, r {params.support_radius}: g_coef and g_rad "
            f"{'bit for bit' if bits else 'DIFFER'}, max |d| {err:.3g}; a second call "
            f"{'gives the same bits' if same else 'DIFFERS'}")
    return bits and same and finite, err, kern, plain, nbytes, flops, note


def check_zoo_captures(captured, dev, label) -> str:
    """Every kernel call recorded on a zoo robot's step against its plain
    version on the same inputs, untimed (K7 / K8 / K14, K9 / K10, K12, K13,
    K4, K15); fails on a mismatch or if a kernel of the step was not
    recorded.  Returns a summary."""
    check = {"jrs_bernstein": lambda x, d: check_jrs("jrs_bernstein", x, d),
             "build_hyperplanes": check_hyperplanes, "collision_rows": check_rows,
             "screen_collision": lambda x, d: check_screen(x, d)[:7],
             "reach_assembly": check_reach_assembly}
    shapes, bad = {}, []
    for (name, key), inputs in captured.items():
        if name in ("fk_chain", "rnea_chain"):
            ok, _, _, _, _, _, note = check_chain(name, inputs, dev)
        elif name in ALM_KERNELS:
            ok, _, _, _, _, _, note = check_alm(name, key, inputs, dev)
        elif name in check:
            ok, _, _, _, _, _, note = check[name](inputs, dev)
        else:
            continue
        shapes[name] = shapes.get(name, 0) + 1
        if not ok:
            bad.append(f"{name} {key}: {note}")
    missing = [k for k in BERNSTEIN_KERNELS if k not in shapes]
    if bad or missing:
        fail(f"{label}: kernels against their plain versions: not recorded {missing}, "
             f"mismatches {bad}")
    return ", ".join(f"{n} {c}" for n, c in shapes.items())


def zoo_steps(dev) -> dict:
    """A W = N_ZOO step of every zoo robot on the card (ArmourConfig.
    for_robot: the cached ultimate bound, the full width), from mid-range
    postures seeded around the joint boxes' centres toward a goal 0.05 rad
    away, among the obstacles of the first N_ZOO saved worlds.  The first
    call records the first call of each kernel and shape, each held against
    its plain version (K7 / K8 at the UR5's F = 6, K9 / K10 at the Fetch
    arm's and the dumbbell's F < J among them); the second is counted: every kernel of a
    Bernstein step must launch, K16 not.  Witnesses of the verdicts: the
    same step through the port on the CPU (plain versions) must agree on
    feasibility with at most one flip; every feasible k passes the plain
    full-set check; the groups over their thresholds in the infeasible
    worlds are printed; and the step again with the torque rows off
    (turn_off_input_constraints, the configuration of the JAX package's
    tests/test_robot_zoo.py:test_zoo_plan_step_runs, whose Kinova-tuned
    controller constants do not fit the other robots' torque limits), its
    feasible k certified too.  Returns {name: numbers}."""
    import dataclasses

    from armour_tpu_torch import kernels, nlp
    from armour_tpu_torch.collision import (ObstacleSet, collision_constraints_plain,
                                            pad_obstacles, stack_obstacles)
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.models import zoo
    from armour_tpu_torch.planner import make_batch_planner, plan_problem
    from armour_tpu_torch.pz.basis import make_basis
    from armour_tpu_torch.utils.timing import wall_s
    from armour_tpu_torch.worlds import load_world_csv

    worlds = [load_world_csv(p) for p in sorted(glob.glob("saved_worlds/random/*.csv"))[:N_ZOO]]
    rng = np.random.default_rng(13)
    out = {}

    def certify(r, cfg, args, obs_d, res, label):
        feas = res.feasible
        if not bool(torch.isfinite(res.k[feas]).all()) or bool(
                torch.isfinite(res.k[~feas]).any()):
            fail(f"{label}: k is not finite exactly where a world is feasible")
        if not bool(feas.any()):
            return
        basis = make_basis(r.num_factors, cfg.max_poly_degree)
        prob = plan_problem(*args, obs_d, r, cfg, basis)
        k_chk = torch.where(feas[:, None], res.k, torch.zeros_like(res.k))[:, None]
        v = torch.stack(nlp.max_violations(k_chk, prob, cfg, basis,
                                           collision_fn=collision_constraints_plain),
                        dim=-1)[:, 0]
        if not bool(nlp.viol_feasible(v, cfg)[feas].all()):
            fail(f"{label}: the plain full-set check rejects a feasible world")

    for name in zoo.list_robots():
        r = zoo.load_zoo_robot(name)
        cfg = ArmourConfig.for_robot(r, dtype=torch.float32)
        lo = np.maximum(r.position_limits_lb, -np.pi)
        hi = np.minimum(r.position_limits_ub, np.pi)
        q0 = (lo + hi) / 2.0 + rng.uniform(-0.1, 0.1, (N_ZOO, r.num_factors))
        obs = stack_obstacles([pad_obstacles(w.obstacle_centers, w.obstacle_generators,
                                             cfg.max_obstacles, cfg.dtype) for w in worlds])
        obs_d = ObstacleSet(centers=obs.centers.to(dev), generators=obs.generators.to(dev),
                            mask=obs.mask.to(dev))
        q0d = torch.as_tensor(q0, dtype=cfg.dtype).to(dev)
        z = torch.zeros_like(q0d)
        args = (q0d, z, z, q0d + 0.05)
        step = make_batch_planner(r, cfg)
        with kernels.capture() as captured:
            t_first, _ = wall_s(lambda: step(*args, obs_d), dev)
        kernels.reset_counts()
        t, res = wall_s(lambda: step(*args, obs_d), dev)
        n = kernels.counts()
        missing = [k for k in BERNSTEIN_KERNELS if n[k] == 0]
        if missing or n["grasp_rows"]:
            fail(f"zoo {name}: kernels not launched {missing}, K16 x{n['grasp_rows']}")
        no_k3(n, f"zoo {name}'s step")
        checked = check_zoo_captures(captured, dev, f"zoo {name}")
        captured.clear()
        certify(r, cfg, args, obs_d, res, f"zoo {name}")
        feas = res.feasible
        thr = torch.tensor(nlp.viol_thresholds(cfg), device=dev)
        over = (res.viol[~feas] > thr).sum(0).tolist()

        q0c = torch.as_tensor(q0, dtype=cfg.dtype)
        zc = torch.zeros_like(q0c)
        t_cpu, res_cpu = wall_s(lambda: make_batch_planner(r, cfg, device="cpu")(
            q0c, zc, zc, q0c + 0.05, obs), "cpu")
        card_v, cpu_v = feas.cpu().tolist(), res_cpu.feasible.tolist()
        flips = sum(x != y for x, y in zip(card_v, cpu_v))

        cfg_off = dataclasses.replace(cfg, turn_off_input_constraints=True)
        res_off = make_batch_planner(r, cfg_off)(*args, obs_d)
        certify(r, cfg_off, args, obs_d, res_off, f"zoo {name}, torque rows off")
        n_off = int(res_off.feasible.sum())
        print(f"  zoo {name} (J = {r.num_joints}, F = {r.num_factors}): W={N_ZOO} step "
              f"{t * 1e3:.1f} ms (first call {t_first * 1e3:.1f} ms), {int(feas.sum())}/{N_ZOO} "
              f"feasible, launches K7 x{n['alm_newton']}, K8 x{n['alm_values']}, "
              f"K10 x{n['rnea_chain']}, K16 x{n['grasp_rows']}; kernels against their plain "
              f"versions, shapes: {checked}; infeasible worlds over their thresholds: torque "
              f"{over[0]}, collision {over[1]}, state {over[2]}, grasp {over[3]}; CPU plain "
              f"{sum(cpu_v)}/{N_ZOO} feasible ({flips} differ, {t_cpu:.1f} s); torque rows "
              f"off: {n_off}/{N_ZOO} feasible")
        if flips > 1:
            fail(f"zoo {name}: card {card_v} and CPU {cpu_v} verdicts differ on more than one "
                 f"world")
        out[name] = {"step_ms": t * 1e3, "feasible": int(feas.sum()), "over": over,
                     "feasible_cpu": sum(cpu_v), "feasible_torque_off": n_off}
    return out


def grasp_phase(dev) -> tuple:
    """Phase 13: the grasp path on the Kinova with the dumbbell payload at
    the full width (see the module docstring).  Returns (K16's kernels-line
    row, numbers)."""
    import dataclasses

    from armour_tpu_torch import kernels, nlp
    from armour_tpu_torch.collision import ObstacleSet, collision_constraints_plain
    from armour_tpu_torch.config import ArmourConfig, derive_ultimate_bound
    from armour_tpu_torch.models import zoo
    from armour_tpu_torch.planner import make_batch_planner, plan_problem
    from armour_tpu_torch.pz.basis import make_basis
    from armour_tpu_torch.utils.timing import median_ms, wall_s

    robot = zoo.kinova_dumbbell()
    t_ub, ub = wall_s(lambda: derive_ultimate_bound(robot, v_max=GRASP_V_MAX), "cpu")
    mu, rr = GRASP_PERMISSIVE
    cfg = ArmourConfig.for_robot(robot, derive_ub=False, ub=ub, dtype=torch.float32,
                                 grasp_constraints=True, grasp_mu=mu, grasp_support_radius=rr)
    basis = make_basis(robot.num_factors, cfg.max_poly_degree)
    q0, qd0, qdd0, q_des, obs = scenes(robot, cfg, N_WORLDS)
    args = [torch.as_tensor(x, dtype=cfg.dtype).to(dev) for x in (q0, qd0, qdd0, q_des)]
    obs_d = ObstacleSet(centers=obs.centers.to(dev), generators=obs.generators.to(dev),
                        mask=obs.mask.to(dev))
    step = make_batch_planner(robot, cfg)
    with kernels.capture() as captured:
        t_first, _ = wall_s(lambda: step(*args, obs_d), dev)
    kernels.reset_counts()
    t_main, res = wall_s(lambda: step(*args, obs_d), dev)
    launches, dlaunches = kernels.counts(), kernels.device_counts()
    print(f"phase 13: grasp path, {robot.name} (J = {robot.num_joints}, F = "
          f"{robot.num_factors}), ub at V_max {GRASP_V_MAX} (eps {ub.eps:.5f}, m_min "
          f"{ub.m_min}, m_max {ub.m_max:.6f}; derived on the host in {t_ub:.2f} s), contact "
          f"mu {mu}, r {rr}: W={N_WORLDS} step {t_main * 1e3:.1f} ms (first call "
          f"{t_first * 1e3:.1f} ms); launches {launches}")
    for name in BERNSTEIN_KERNELS + ("grasp_rows",):
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the grasp step")
    no_k3(launches, "the grasp step")
    for name in ("jrs_bernstein", "fk_chain", "rnea_chain", "reach_assembly", "grasp_rows",
                 "screen_collision"):
        if launches[name] != 1:
            fail(f"kernel {name} launched {launches[name]} times in one grasp step, not once")
    for name in OP_KERNELS:
        if launches[name] != 0:
            fail(f"kernel {name} was launched on the grasp step")

    # every recorded call against its plain version, each kernel twice (K3
    # by a direct call on the step's cells)
    add_direct_k3(captured)
    check = {"jrs_bernstein": lambda x, d: check_jrs("jrs_bernstein", x, d),
             "build_hyperplanes": check_hyperplanes, "collision_rows": check_rows,
             "screen_collision": lambda x, d: check_screen(x, d)[:7],
             "reach_assembly": check_reach_assembly, "grasp_rows": check_grasp}
    sums, k16, all_ok = {}, None, True
    for (name, key), inputs in captured.items():
        if name in ("fk_chain", "rnea_chain"):
            res_c = check_chain(name, inputs, dev)
        elif name in ALM_KERNELS:
            res_c = check_alm(name, key, inputs, dev)
        elif name in check:
            res_c = check[name](inputs, dev)
        else:
            continue
        ok, err, kern, plain, nbytes, flops, note = res_c
        ms, pms = kernel_ms(kern, dev), median_ms(plain, dev, TIMING_ITERS)
        print(f"  {name} {key}: {'ok' if ok else 'MISMATCH'} ({note}); kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms, {nbytes / 1e6:.1f} MB, bound "
              f"{_bound_ms(nbytes, flops):.4f} ms")
        if name == "reach_assembly":
            print(f"  {name} {key}: launch geometry {k15_geometry_of(inputs)}")
        elif name == "grasp_rows":
            print(f"  {name} {key}: launch geometry {k16_geometry_of(inputs)} (before: "
                  f"{BEFORE_MS[name]} ms)")
        all_ok &= ok
        sm = sums.setdefault(name, [0.0, 0.0, 0])
        sm[0] += ms
        sm[1] += pms
        sm[2] += 1
        if name == "grasp_rows":
            t_bytes = nbytes / H100_BYTES_PER_S * 1e3
            t_ops = flops / H100_FP32_FLOP_PER_S * 1e3
            src, rep = REPLACES[name]
            k16 = {"name": name, "route": "cuda", "source": src, "replaces": rep,
                   "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": pms,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": None, "variants": 1, "device_launches": dlaunches[name]}
            k16_work_done = (nbytes, flops)
    captured.clear()
    if not all_ok:
        fail("a kernel disagrees with its plain version on the grasp step")
    if k16 is None or any(n not in sums for n in ALM_KERNELS + ("rnea_chain", "fk_chain")):
        fail("the grasp step recorded no K16 / K9 / K10 / K7 / K8 / K14 call")
    print("  grasp step kernels, ms summed over their shapes (kernel / plain): " + ", ".join(
        f"{n} {v[0]:.4f} / {v[1]:.4f} ({v[2]} shapes)" for n, v in sums.items()))

    # results: the full-set check, the grasp rows included
    k, feas = res.k, res.feasible
    if not bool(torch.isfinite(k[feas]).all()) or bool((k[feas].abs() > 1.0 + 1e-6).any()):
        fail("a feasible grasp k is not finite or leaves [-1, 1]")
    if bool(torch.isfinite(k[~feas]).any()):
        fail("an infeasible grasp world returned a finite k")
    prob = plan_problem(*args, obs_d, robot, cfg, basis)
    if prob.grasp is None or tuple(prob.grasp.g_coef.shape) != (
            N_WORLDS, cfg.num_time_steps, 3, basis.size):
        fail("the grasp plan carries no grasp rows of the expected shape")
    k_chk = torch.where(feas[:, None], k, torch.zeros_like(k))[:, None]
    v = torch.stack(nlp.max_violations(k_chk, prob, cfg, basis,
                                       collision_fn=collision_constraints_plain), dim=-1)[:, 0]
    cert = nlp.viol_feasible(v, cfg)
    if not bool(cert[feas].all()):
        fail(f"the plain full-set check rejects feasible grasp worlds "
             f"{torch.nonzero(feas & ~cert).flatten().tolist()}")
    n_feas = int(feas.sum())
    vg = float(v[feas][:, 3].max()) if n_feas else float("nan")
    # what blocks the infeasible worlds: the groups over their thresholds at
    # the returned attempt (SolveResult.viol: torque, collision, state, grasp)
    thr = torch.tensor(nlp.viol_thresholds(cfg), device=dev)
    over = (res.viol[~feas] > thr).sum(0).tolist()
    print(f"  {n_feas}/{N_WORLDS} grasp worlds feasible under mu {mu}, r {rr}; every feasible "
          f"k passes the plain full-set check (max v_grasp {vg:.4g} against "
          f"{cfg.grasp_violation_threshold}); of the {N_WORLDS - n_feas} infeasible, over "
          f"their thresholds: torque {over[0]}, collision {over[1]}, state {over[2]}, grasp "
          f"{over[3]}")
    del prob
    res_off = make_batch_planner(robot, dataclasses.replace(cfg, grasp_constraints=False))(
        *args, obs_d)
    n_off = int(res_off.feasible.sum())
    print(f"  the same step without grasp rows: {n_off}/{N_WORLDS} feasible")

    # the tight contact parameters: every world rejected
    mu_t, r_t = GRASP_TIGHT
    cfg_t = dataclasses.replace(cfg, grasp_mu=mu_t, grasp_support_radius=r_t)
    step_t = make_batch_planner(robot, cfg_t)
    kernels.reset_counts()
    t_tight, res_t = wall_s(lambda: step_t(*args, obs_d), dev)
    n_t = int(res_t.feasible.sum())
    print(f"  tight contact parameters (mu {mu_t}, r {r_t}): {n_t}/{N_WORLDS} feasible, step "
          f"{t_tight * 1e3:.1f} ms (first call), K16 x{kernels.counts()['grasp_rows']}")
    if n_t or not bool(torch.isnan(res_t.k).all()):
        fail("the tight contact parameters left a world feasible or a k finite")

    # timings: the step, its device time and activities, the reach window
    t_steps = [wall_s(lambda: step(*args, obs_d), dev)[0] for _ in range(3)]
    t_step = statistics.median(t_steps)
    t_rs = statistics.median(
        [wall_s(lambda: plan_problem(*args, obs_d, robot, cfg, basis), dev)[0]
         for _ in range(3)])
    breakdown = profile_step(lambda: step(*args, obs_d), dev, t_step)
    k16_dev = breakdown.get("hand_device_ms", {}).get("grasp_rows", float("nan"))
    print(f"  grasp W={N_WORLDS} step {t_step * 1e3:.1f} ms (median of 3), reach sets "
          f"{t_rs * 1e3:.1f} ms, solve {(t_step - t_rs) * 1e3:.1f} ms; "
          f"{breakdown.get('device_activities', 'not measured')} device activities, busy "
          f"share {breakdown.get('device_busy_share', float('nan')):.3f}")
    print(f"  K16 (grasp_rows): event {k16['ms']:.4f} ms, device {k16_dev:.4f} ms in one step, "
          f"{k16['launches']} launch, bound {k16['bound_ms']:.4f} ms ({k16['bound_by']}: "
          f"{k16_work_done[0] / 1e6:.1f} MB, {k16_work_done[1] / 1e9:.3f} G operations), "
          f"plain {k16['plain_ms']:.4f} ms, library none")
    window = reach_window(lambda: plan_problem(*args, obs_d, robot, cfg, basis), dev,
                          f"grasp reach sets, W={N_WORLDS}", between=("k15_", "k16_"))
    zoo_out = zoo_steps(dev)
    perf = {"grasp_step_ms": t_step * 1e3, "grasp_reachset_ms": t_rs * 1e3,
            "grasp_feasible": n_feas, "grasp_feasible_tight": n_t,
            "grasp_feasible_without_rows": n_off, "grasp_infeasible_over": over,
            "grasp_launches": {n: launches[n] for n in BERNSTEIN_KERNELS + ("grasp_rows",)},
            "grasp_kernel_ms": {n: v[0] for n, v in sums.items()},
            "grasp_plain_ms": {n: v[1] for n, v in sums.items()},
            "k16_device_ms": k16_dev, "zoo": zoo_out,
            **{f"grasp_{kk}": vv for kk, vv in breakdown.items()},
            **{f"grasp_{kk}": vv for kk, vv in window.items()}}
    return k16, perf


def _flagged(summaries) -> list:
    return [i for i, s in enumerate(summaries)
            if s.collision or s.torque_exceeded or s.ultimate_bound_exceeded
            or s.joint_limit_exceeded]


def check_loop_calls(robot, cfg, captured, dev, label) -> float:
    """The K5 / K6 calls a closed loop recorded (the first of each shape:
    kernels.capture) against their plain versions on the same inputs (K5
    over the whole move with K5's tolerances, K6's flags exactly and its
    overlap counts up to the triples within K6_MARGIN of the boundary),
    untimed; fails on a mismatch or if either kernel was
    not recorded.  Returns the largest difference."""
    err, seen = 0.0, set()
    for (name, key), inp in captured.items():
        if name == "rollout":
            ok, e, _, _, _ = check_rollout(robot, cfg, inp, dev, label, timed=False)
        elif name == "oracle_check":
            ok, fp, ok_, op, diff, amb = oracle_agreement(robot, cfg, inp)
            e = float(diff.max())
            Wn, N, _ = inp["q"].shape
            print(f"  oracle_check {label} [{Wn} worlds x {N} steps x {robot.num_joints} links "
                  f"x {inp['mask'].shape[1]} obstacles]: {'ok' if ok else 'MISMATCH'} (worlds "
                  f"flagged by the plain version {fp.sum(0).tolist()}; overlaps kernel "
                  f"{int(ok_.sum())} plain {int(op.sum())}, triples within {K6_MARGIN} m of "
                  f"the boundary {int(amb.sum())})")
        else:
            continue
        seen.add(name)
        if not ok:
            fail(f"{label}: {name} {key} disagrees with its plain version")
        err = max(err, e)
    if seen != {"rollout", "oracle_check"}:
        fail(f"{label}: K5 / K6 calls recorded: {sorted(seen)}")
    return err


def zoo_loop_worlds(robot, q0, scenes_) -> tuple:
    """Worlds from start postures q0 [W, F] toward goals ZOO_GOAL_STEP rad a
    joint away among the scenes' obstacles, less those that overlap one of
    the robot's link boxes at its start (a trial starts collision-free):
    (worlds, obstacles dropped)."""
    from armour_tpu_torch.collision import pad_obstacles, stack_obstacles
    from armour_tpu_torch.worlds import World

    n_obs = max(len(w.obstacle_centers) for w in scenes_)
    obs = stack_obstacles([pad_obstacles(w.obstacle_centers, w.obstacle_generators, n_obs,
                                         torch.float64) for w in scenes_])
    margins = link_obstacle_margins(robot, torch.as_tensor(q0)[:, None], obs)   # [W, 1, J, O]
    clear = (margins > 0).flatten(1, 2).all(1)                                   # [W, O]
    worlds, dropped = [], 0
    for i, w in enumerate(scenes_):
        keep = clear[i, :len(w.obstacle_centers)].numpy()
        dropped += int((~keep).sum())
        worlds.append(World(start=q0[i], goal=q0[i] + ZOO_GOAL_STEP,
                            obstacle_centers=w.obstacle_centers[keep],
                            obstacle_generators=w.obstacle_generators[keep]))
    return worlds, dropped


def grasp_loop_phase(dev) -> tuple:
    """Phase 14: the closed loop at J = 9 and F < J (see the module
    docstring).  Returns (the dumbbell's K5 and K6 rows at W = 64, numbers)."""
    from armour_tpu_torch import kernels
    from armour_tpu_torch.batch_sim import run_trials_batched
    from armour_tpu_torch.collision import pad_obstacles
    from armour_tpu_torch.config import ArmourConfig, derive_ultimate_bound
    from armour_tpu_torch.kernels import sim as ksim
    from armour_tpu_torch.models import zoo
    from armour_tpu_torch.planner import make_planner
    from armour_tpu_torch.simulator import run_trial, sample_true_params
    from armour_tpu_torch.utils.timing import wall_s
    from armour_tpu_torch.worlds import World, load_world_csv

    robot = zoo.kinova_dumbbell()
    J, F = robot.num_joints, robot.num_factors
    ub = derive_ultimate_bound(robot, v_max=GRASP_V_MAX)
    mu, rr = GRASP_PERMISSIVE
    grasp = dict(derive_ub=False, ub=ub, dtype=torch.float32, grasp_constraints=True,
                 grasp_mu=mu, grasp_support_radius=rr)
    out = {}

    # (i) the tray trial: tests/test_grasp.py:194-227 on the card
    cfg_t = ArmourConfig.for_robot(robot, num_time_steps=16, max_obstacles=8, screen_k=256,
                                   **grasp)
    start = np.linspace(-0.3, 0.3, F)
    world = World(start=start, goal=start + 0.12, obstacle_centers=np.array([[2.0, 2.0, 2.0]]),
                  obstacle_generators=np.stack([np.diag([0.05] * 3)]))
    obs = pad_obstacles(world.obstacle_centers, world.obstacle_generators, cfg_t.max_obstacles,
                        cfg_t.dtype)
    tp = sample_true_params(robot, np.random.default_rng(0), scale=1.0)
    step = make_planner(robot, cfg_t)
    kernels.reset_counts()
    with kernels.capture() as captured:
        t_tray, s = wall_s(lambda: run_trial(world, robot, cfg_t, step, obs, tp,
                                             max_iterations=TRAY_ITERATIONS), dev)
    n = kernels.counts()
    print(f"phase 14 (i): tray trial, {robot.name} (J = {J}, F = {F}), T = 16, O = 8, K = 256, "
          f"contact mu {mu}, r {rr}: {s.iterations} iterations in {t_tray:.1f} s (planner "
          f"warm-up included), goal {'reached' if s.goal_reached else 'NOT reached'}, "
          f"{s.infeasible_plans} infeasible plans, goal distance {s.goal_distance_final:.4f}; "
          f"launches K5 x{n['rollout']}, K6 x{n['oracle_check']}, K16 x{n['grasp_rows']}")
    if _flagged([s]):
        fail("the tray trial raised a safety flag")
    if not s.goal_reached:
        fail(f"the tray trial did not reach its goal in {TRAY_ITERATIONS} iterations")
    if n["rollout"] != s.iterations or n["oracle_check"] != s.iterations or not n["grasp_rows"]:
        fail(f"tray trial launches {n} for {s.iterations} iterations")
    no_k3(n, "the tray trial")
    err = check_loop_calls(robot, cfg_t, captured, dev, "tray")
    captured.clear()
    out["tray"] = {"iterations": s.iterations, "goal_reached": s.goal_reached,
                   "wall_s": t_tray, "max_abs_err": err,
                   "plan_ms": [x * 1e3 for x in s.planning_times]}

    # (ii) the dumbbell's closed loop at the full width over phase 13's scenes
    cfg = ArmourConfig.for_robot(robot, **grasp)
    worlds = [load_world_csv(p) for p in
              sorted(glob.glob("saved_worlds/random/*.csv"))[:N_WORLDS]]
    stats: dict = {}
    kernels.reset_counts()
    with kernels.capture() as captured:
        t_loop, summaries = wall_s(lambda: run_trials_batched(
            worlds, robot, cfg, max_iterations=LOOP_ITERATIONS, true_param_scale=1.0, seed=0,
            rescue_solver=True, guidance="straight", stats=stats), dev)
    launches = kernels.counts()
    keep = {k[0]: v for k, v in captured.items() if k[0] in ("rollout", "oracle_check")}
    captured.clear()
    n_it = stats["batch_iterations"]
    buckets = {"goal": sum(x.goal_reached for x in summaries),
               "stuck": sum(x.stuck for x in summaries),
               "active": sum(not (x.goal_reached or x.stuck) for x in summaries)}
    print(f"phase 14 (ii): {robot.name} W={N_WORLDS} closed loop with grasp rows, {n_it} "
          f"lockstep iterations in {t_loop:.1f} s (planner warm-up included); after them "
          f"{buckets}, infeasible plans {sum(x.infeasible_plans for x in summaries)}, rescued "
          f"{stats['recovered_rows']}/{stats['rescued_rows']} rows; launches {launches}")
    for i, rec in enumerate(stats["iterations"]):
        rescue = "not fired" if rec["rescue_s"] is None else f"{rec['rescue_s'] * 1e3:.1f} ms"
        print(f"  iteration {i}: plan {rec['plan_s'] * 1e3:.1f} ms, rescue {rescue}, rollout "
              f"(reference + K5) {rec['rollout_s'] * 1e3:.1f} ms, oracles "
              f"{rec['oracles_s'] * 1e3:.1f} ms")
    if n_it < 1:
        fail("the dumbbell's closed loop ran no iteration")
    for name in BERNSTEIN_KERNELS + ("grasp_rows",):
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the dumbbell's closed loop")
    no_k3(launches, "the dumbbell's closed loop")
    for name in ("rollout", "oracle_check"):
        if launches[name] != n_it or name not in keep:
            fail(f"kernel {name} launched {launches[name]} times in {n_it} iterations")
    if _flagged(summaries):
        fail(f"dumbbell worlds {_flagged(summaries)} raised a safety flag")
    rows = closed_loop_kernel_rows(robot, cfg, launches, keep, dev, "phase 14 (ii)")
    keep.clear()
    out["dumbbell_loop"] = {"worlds": N_WORLDS, "iterations": n_it, "wall_s": t_loop,
                            "buckets": buckets,
                            "rollout_ms": [r["rollout_s"] * 1e3 for r in stats["iterations"]],
                            "oracles_ms": [r["oracles_s"] * 1e3 for r in stats["iterations"]]}

    # (iii) every zoo robot's closed loop: phase 13's postures and scenes,
    # the worst-case true parameters where the robot's ultimate bound is
    # certified and the nominal ones elsewhere, the obstacles that overlap a
    # robot at its start dropped
    scenes_ = [load_world_csv(p) for p in
               sorted(glob.glob("saved_worlds/random/*.csv"))[:N_ZOO]]
    rng = np.random.default_rng(13)
    out["zoo_loop"] = {}
    for name in zoo.list_robots():
        r = zoo.load_zoo_robot(name)
        cfg_z = ArmourConfig.for_robot(r, dtype=torch.float32)
        certified = derive_ultimate_bound(r, return_provenance=True)[1]["certified"]
        scale = 1.0 if certified else 0.0
        lo = np.maximum(r.position_limits_lb, -np.pi)
        hi = np.minimum(r.position_limits_ub, np.pi)
        q0 = (lo + hi) / 2.0 + rng.uniform(-0.1, 0.1, (N_ZOO, r.num_factors))
        ws, dropped = zoo_loop_worlds(r, q0, scenes_)
        stats_z: dict = {}
        kernels.reset_counts()
        with kernels.capture() as captured:
            t_z, sz = wall_s(lambda: run_trials_batched(
                ws, r, cfg_z, max_iterations=ZOO_LOOP_ITERATIONS, true_param_scale=scale,
                seed=0, rescue_solver=True, guidance="straight", stats=stats_z,
                trace=range(N_ZOO)), dev)
        nz = kernels.counts()
        it_z = stats_z["batch_iterations"]
        # how far each world got from its start, over the states it reached
        moved = [max(float(np.abs(np.asarray(rec["q"]) - w.start).max()) for rec in recs)
                 for w, recs in zip(ws, (stats_z["trace"][str(i)] for i in range(N_ZOO)))]
        n_moved = sum(m > ZOO_MOVED for m in moved)
        n_feas = sum(rec["feasible"] for i in range(N_ZOO) for rec in stats_z["trace"][str(i)])
        print(f"phase 14 (iii): zoo {name} (J = {r.num_joints}, F = {r.num_factors}) W={N_ZOO} "
              f"closed loop, {'worst-case' if certified else 'nominal'} true parameters "
              f"(bound {'certified' if certified else 'not certified'}; {dropped} obstacles "
              f"on the start postures dropped), {it_z} iterations in {t_z:.1f} s; goal "
              f"{sum(x.goal_reached for x in sz)}, feasible plans {n_feas}, infeasible plans "
              f"{sum(x.infeasible_plans for x in sz)}, worlds moved over {ZOO_MOVED} rad "
              f"{n_moved} of {N_ZOO} (largest {max(moved):.4f} rad); launches K5 "
              f"x{nz['rollout']} (lanes {ksim.k5_geometry(r.num_joints, r.num_factors)}), K6 "
              f"x{nz['oracle_check']}")
        if it_z < 1 or nz["rollout"] != it_z or nz["oracle_check"] != it_z:
            fail(f"zoo {name}: K5 x{nz['rollout']}, K6 x{nz['oracle_check']} in {it_z} "
                 f"iterations")
        no_k3(nz, f"zoo {name}'s closed loop")
        if _flagged(sz):
            fail(f"zoo {name}: worlds {_flagged(sz)} raised a safety flag")
        err_z = check_loop_calls(r, cfg_z, captured, dev, f"zoo {name}")
        captured.clear()
        out["zoo_loop"][name] = {"iterations": it_z, "wall_s": t_z, "max_abs_err": err_z,
                                 "goal": sum(x.goal_reached for x in sz),
                                 "true_param_scale": scale, "feasible_plans": n_feas,
                                 "worlds_moved": n_moved, "largest_move_rad": max(moved)}
    return rows, out


# ---------------------------------------------------------------------------
# the smooth collision mode: K4's screened rows and K7 / K8 by log-sum-exp
# ---------------------------------------------------------------------------


SMOOTH_KERNELS = ("collision_rows", "alm_newton", "alm_values")


def _smooth_specials(name, inputs) -> int:
    """expf and logf of a smooth K4 / K7 / K8 call: 2C + 1 for every
    (query, screened row)."""
    if name == "collision_rows":
        A, p_all = inputs[0], inputs[5]
        Wn, _, C, R = A.shape
        return Wn * p_all.shape[1] * R * (2 * C + 1)
    rows, kq = inputs[0], inputs[1]
    return rows.args.W * kq.shape[1] * rows.args.K * (2 * rows.args.C + 1)


def _smooth_bound(nbytes, flops, specials) -> tuple:
    """(ms, 'bytes' or 'operations'): bytes over the memory rate, float32
    operations over their peak and the expf / logf over the special-function
    rate, the longest."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = max(flops / H100_FP32_FLOP_PER_S, specials / H100_SFU_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_smooth_captures(captured, dev, label, timed: bool) -> dict:
    """K4 (its smooth screened rows and the exact full-set check), K7 / K8
    and K14 against their plain versions on every call recorded on a
    smooth-mode path, at phase 3's tolerances, each run twice for the same
    bits (K14 bit for bit), timed when asked; fails on a mismatch or when a
    smooth K4 / K7 / K8 shape or a K14 phase was not recorded.  Returns
    {name: sums over the smooth shapes} for K4 / K7 / K8."""
    from armour_tpu_torch.utils.timing import median_ms

    sums, all_ok, loop = {}, True, 0
    for (name, key), inputs in captured.items():
        if name == "collision_rows":
            res = check_rows(inputs, dev)
        elif name in ALM_KERNELS:
            res = check_alm(name, key, inputs, dev)
        else:
            continue
        ok, err, kern, plain, nbytes, flops, note = res
        smooth = "smooth" in key
        loop += name == "alm_loop"
        line = f"  {name} {key}: {'ok' if ok else 'MISMATCH'} ({note})"
        ms = pms = float("nan")
        if timed:
            ms, pms = kernel_ms(kern, dev), median_ms(plain, dev, TIMING_ITERS)
            line += f"; kernel {ms:.4f} ms, plain {pms:.4f} ms"
        if smooth:
            spec = _smooth_specials(name, inputs)
            b_ms, _ = _smooth_bound(nbytes, flops, spec)
            line += (f", {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP, {spec / 1e6:.2f} M "
                     f"expf / logf, bound {b_ms:.4f} ms")
            r = sums.setdefault(name, {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0,
                                       "specials": 0, "err": 0.0, "calls": 0})
            for f, x in (("ms", ms), ("plain_ms", pms), ("bytes", nbytes), ("flops", flops),
                         ("specials", spec), ("calls", 1)):
                r[f] += x
            r["err"] = max(r["err"], err)
        print(line)
        all_ok &= ok
    missing = [n for n in SMOOTH_KERNELS if n not in sums] + ([] if loop else ["alm_loop"])
    if missing or not all_ok:
        fail(f"{label}: smooth-mode kernels against their plain versions: not recorded "
             f"{missing}, all within tolerance {all_ok}")
    return sums


def smooth_step(label, robot, cfg, basis, args, obs_d, dev, kernels_of_step, timed: bool):
    """One counted smooth-mode step (a warm-up step records the calls, then
    the launch counters are set to 0 and read after a second step): every
    kernel in kernels_of_step must launch, K1 / K2 not; the results' shapes,
    k finite exactly where feasible, every feasible k certified by the plain
    exact full-set check; a plain solve of the plan, recorded and counted
    (K4's smooth screened rows run there: its host and device launches, and
    when timed their device time in one profiled plain solve); the recorded
    K4 / K7 / K8 / K14 calls against their plain versions, timed when asked;
    then solver_phase on the plan (the fused solve against the eager and
    the plain one).  Returns {res, launches, device_launches, sums, solve,
    k4_plain, k4_plain_device, k4_plain_device_ms}."""
    from armour_tpu_torch import kernels, nlp
    from armour_tpu_torch.collision import collision_constraints_plain
    from armour_tpu_torch.planner import make_batch_planner, plan_problem
    from armour_tpu_torch.utils.timing import wall_s

    step = make_batch_planner(robot, cfg)
    with kernels.capture() as captured:
        t_first, _ = wall_s(lambda: step(*args, obs_d), dev)
    kernels.reset_counts()
    t_main, res = wall_s(lambda: step(*args, obs_d), dev)
    launches, dlaunches = kernels.counts(), kernels.device_counts()
    Wn = args[0].shape[0]
    print(f"{label}: W={Wn} step {t_main * 1e3:.1f} ms (first call {t_first * 1e3:.1f} ms); "
          f"launches {launches}")
    missing = [n for n in kernels_of_step if launches[n] == 0]
    extra = [n for n in OP_KERNELS if launches[n]]
    if missing or extra:
        fail(f"{label}: kernels not launched {missing}, launched but not of the step {extra}")
    no_k3(launches, label)
    k, feas = res.k, res.feasible
    if k.shape != (Wn, robot.num_factors) or feas.shape != (Wn,):
        fail(f"{label}: unexpected result shapes {tuple(k.shape)} {tuple(feas.shape)}")
    if not bool(torch.isfinite(k[feas]).all()) or bool((k[feas].abs() > 1.0 + 1e-6).any()):
        fail(f"{label}: a feasible k is not finite or leaves [-1, 1]")
    if bool(torch.isfinite(k[~feas]).any()):
        fail(f"{label}: an infeasible world returned a finite k")
    prob = plan_problem(*args, obs_d, robot, cfg, basis)
    k_chk = torch.where(feas[:, None], k, torch.zeros_like(k))[:, None]
    v = torch.stack(nlp.max_violations(k_chk, prob, cfg, basis,
                                       collision_fn=collision_constraints_plain), dim=-1)[:, 0]
    cert = nlp.viol_feasible(v, cfg)
    if not bool(cert[feas].all()):
        fail(f"{label}: the plain exact full-set check rejects feasible worlds "
             f"{torch.nonzero(feas & ~cert).flatten().tolist()}")
    print(f"  {int(feas.sum())}/{Wn} worlds feasible; every feasible k passes the plain exact "
          f"full-set check")
    kernels.reset_counts()
    with kernels.capture() as cap:
        nlp.solve(prob, cfg, basis, plain=True)
    k4_plain = kernels.counts()["collision_rows"]
    k4_dev = kernels.device_counts()["collision_rows"]
    k4_ms = None
    if timed:
        tl = device_timeline(lambda: nlp.solve(prob, cfg, basis, plain=True), dev)
        smooth_k4 = [us for n, us in tl if "k4_rows<true" in n]
        k4_ms = sum(smooth_k4) / 1e3 if tl else None
        print(f"  the plain solve: K4's smooth screened rows x{k4_plain} (device launches "
              f"{k4_dev}; profiled {len(smooth_k4)}), "
              f"{'not measured' if k4_ms is None else f'{k4_ms:.4f} ms'} of device time")
    captured.update({kk: vv for kk, vv in cap.items() if kk[0] == "collision_rows"})
    cap.clear()
    sums = check_smooth_captures(captured, dev, label, timed)
    captured.clear()
    solve = solver_phase(prob, cfg, basis, dev)
    return {"res": res, "launches": launches, "device_launches": dlaunches, "sums": sums,
            "solve": solve, "k4_plain": k4_plain, "k4_plain_device": k4_dev,
            "k4_plain_device_ms": k4_ms}


def smooth_phase(robot, cfg, basis, scene, one, dev, hard) -> tuple:
    """Phase 15: the smooth collision mode (cfg.smooth_obstacle_constraints,
    smooth_tau = SMOOTH_TAU) on the card, see the module docstring.  hard:
    phase 4's feasible count, step time, device breakdown and kernel rows.
    Returns ({K4 / K7 / K8: its smooth shapes' numbers for the kernels
    line}, numbers)."""
    import dataclasses

    from armour_tpu_torch import kernels
    from armour_tpu_torch.batch_sim import run_trials_batched
    from armour_tpu_torch.collision import ObstacleSet, pad_obstacles, stack_obstacles
    from armour_tpu_torch.config import ArmourConfig, derive_ultimate_bound
    from armour_tpu_torch.models import zoo
    from armour_tpu_torch.planner import make_batch_planner, make_rescue_planner, strong_config
    from armour_tpu_torch.pz.basis import make_basis
    from armour_tpu_torch.utils.timing import wall_s
    from armour_tpu_torch.worlds import load_world_csv

    q0, qd0, qdd0, q_des, obs = scene
    cfg_s = dataclasses.replace(cfg, smooth_obstacle_constraints=True, smooth_tau=SMOOTH_TAU)
    args = tuple(torch.as_tensor(x, dtype=cfg.dtype).to(dev) for x in (q0, qd0, qdd0, q_des))
    obs_d = ObstacleSet(centers=obs.centers.to(dev), generators=obs.generators.to(dev),
                        mask=obs.mask.to(dev))

    # (i) the W = 64 Bernstein step
    out = smooth_step(f"phase 15 (i): smooth mode (tau {SMOOTH_TAU} m), Bernstein", robot,
                      cfg_s, basis, args, obs_d, dev, BERNSTEIN_KERNELS, timed=True)
    res, launches, sums = out["res"], out["launches"], out["sums"]
    for name in ("jrs_bernstein", "screen_collision", "reach_assembly"):
        if launches[name] != 1:
            fail(f"phase 15 (i): kernel {name} launched {launches[name]} times, not once")
    n_s = int(res.feasible.sum())
    solve_cmp = out["solve"]
    step = make_batch_planner(robot, cfg_s)
    t_step = statistics.median([wall_s(lambda: step(*args, obs_d), dev)[0] for _ in range(3)])
    bd = profile_step(lambda: step(*args, obs_d), dev, t_step)
    print(f"  smooth step {t_step * 1e3:.1f} ms (median of 3) beside the hard step "
          f"{hard['step_s'] * 1e3:.1f} ms (phase 4); {bd.get('device_activities', 'not measured')}"
          f" device activities, busy share {bd.get('device_busy_share', float('nan')):.3f}; "
          f"feasible {n_s}/{N_WORLDS} beside the hard mode's {hard['feasible']}/{N_WORLDS}")
    hard_ms = {r["name"]: r["ms"] for r in hard["krows"]}
    rows = {}
    for name in SMOOTH_KERNELS:
        s = sums[name]
        b_ms, b_by = _smooth_bound(s["bytes"], s["flops"], s["specials"])
        d_h = hard["breakdown"].get("hand_device_ms", {}).get(name, float("nan"))
        if name == "collision_rows":
            # K4's smooth rows run in the plain solve only (the step's K4
            # call is the exact full-set check): one plain solve's launches
            # and device time
            n_l, n_d, d_s = out["k4_plain"], out["k4_plain_device"], out["k4_plain_device_ms"]
            where = "one plain solve"
        else:
            n_l, n_d = launches[name], out["device_launches"][name]
            d_s = bd.get("hand_device_ms", {}).get(name)
            where = "one smooth step"
        rows[name] = {"launches": n_l, "device_launches": n_d, "device_ms_in": where,
                      "max_abs_err": s["err"],
                      "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": None, "variants": s["calls"],
                      "specials": s["specials"], "device_ms": d_s}
        d_txt = "not measured" if d_s is None else f"{d_s:.4f} ms"
        print(f"  {name}, smooth shapes: event {s['ms']:.4f} ms over {s['calls']} shapes "
              f"(hard, phase 3: {hard_ms.get(name, float('nan')):.4f}), device {d_txt} in "
              f"{where} (hard, in phase 4's step: {d_h:.4f}), bound {b_ms:.4f} ms ({b_by}: "
              f"{s['bytes'] / 1e6:.1f} MB, {s['flops'] / 1e9:.3f} GFLOP, "
              f"{s['specials'] / 1e6:.2f} M expf / logf), plain {s['plain_ms']:.4f} ms")
    cpu_step = make_batch_planner(robot, cfg_s, device="cpu")
    t_cpu, res_cpu = wall_s(lambda: cpu_step(q0[:N_CPU], qd0[:N_CPU], qdd0[:N_CPU],
                                             q_des[:N_CPU], obs_slice(obs, slice(0, N_CPU))),
                            "cpu")
    card_v, cpu_v = res.feasible[:N_CPU].cpu().tolist(), res_cpu.feasible.tolist()
    flips = sum(a != b for a, b in zip(card_v, cpu_v))
    print(f"  first {N_CPU} worlds feasible in the smooth mode: card {card_v}, CPU plain "
          f"{cpu_v} ({flips} differ; CPU step {t_cpu:.1f} s)")
    if flips > 1:
        fail("phase 15 (i): card and CPU verdicts differ on more than one world")

    # (ii) the ARMTD step, the dumbbell's grasp step, the UR5's W = 8 step
    cfg_a = dataclasses.replace(cfg_s, traj_family="armtd")
    a_args = (args[0], armtd_inputs(args[0], cfg, N_WORLDS, dev), args[2], args[3])
    out_a = smooth_step("phase 15 (ii): smooth ARMTD", robot, cfg_a, basis, a_args, obs_d, dev,
                        ("jrs_armtd",) + STEP_KERNELS, timed=False)
    dumbbell = zoo.kinova_dumbbell()
    mu, rr = GRASP_PERMISSIVE
    cfg_g = ArmourConfig.for_robot(dumbbell, derive_ub=False,
                                   ub=derive_ultimate_bound(dumbbell, v_max=GRASP_V_MAX),
                                   dtype=torch.float32, grasp_constraints=True, grasp_mu=mu,
                                   grasp_support_radius=rr, smooth_obstacle_constraints=True,
                                   smooth_tau=SMOOTH_TAU)
    gq = scenes(dumbbell, cfg_g, N_WORLDS)
    g_args = tuple(torch.as_tensor(x, dtype=cfg.dtype).to(dev) for x in gq[:4])
    g_obs = ObstacleSet(centers=gq[4].centers.to(dev), generators=gq[4].generators.to(dev),
                        mask=gq[4].mask.to(dev))
    out_g = smooth_step(
        f"phase 15 (ii): smooth grasp ({dumbbell.name}, contact {mu}, {rr})", dumbbell, cfg_g,
        make_basis(dumbbell.num_factors, cfg_g.max_poly_degree), g_args, g_obs, dev,
        BERNSTEIN_KERNELS + ("grasp_rows",), timed=False)
    ur5 = zoo.load_zoo_robot("ur5")
    cfg_u = ArmourConfig.for_robot(ur5, dtype=torch.float32, smooth_obstacle_constraints=True,
                                   smooth_tau=SMOOTH_TAU)
    lo = np.maximum(ur5.position_limits_lb, -np.pi)
    hi = np.minimum(ur5.position_limits_ub, np.pi)
    uq = (lo + hi) / 2.0 + np.random.default_rng(15).uniform(-0.1, 0.1, (N_ZOO, 6))
    worlds = [load_world_csv(p) for p in sorted(glob.glob("saved_worlds/random/*.csv"))[:N_ZOO]]
    u_obs = stack_obstacles([pad_obstacles(w.obstacle_centers, w.obstacle_generators,
                                           cfg_u.max_obstacles, cfg_u.dtype) for w in worlds])
    u_obs_d = ObstacleSet(centers=u_obs.centers.to(dev), generators=u_obs.generators.to(dev),
                          mask=u_obs.mask.to(dev))
    uqd = torch.as_tensor(uq, dtype=cfg.dtype).to(dev)
    uz = torch.zeros_like(uqd)
    out_u = smooth_step("phase 15 (ii): smooth UR5 (F = 6)", ur5, cfg_u,
                        make_basis(6, cfg_u.max_poly_degree), (uqd, uz, uz, uqd + 0.05), u_obs_d,
                        dev, BERNSTEIN_KERNELS, timed=False)

    # (iii) the rescue profile and the real-time planner in the smooth mode,
    # every K7 / K8 / K14 / K9 / K10 / K12 / K13 / K15 shape held against its
    # plain version as phases 7 and 8 hold the hard mode's
    if not strong_config(cfg_s).smooth_obstacle_constraints:
        fail("phase 15 (iii): strong_config dropped the smooth mode")
    rescue_phase(robot, cfg_s, basis, args, obs_d, dev, label="phase 15 (iii): smooth")
    rescue = make_rescue_planner(robot, cfg_s)
    kernels.reset_counts()
    with kernels.capture() as captured:
        t_r = [wall_s(lambda a=a: rescue(*a), dev) for a in one[:N_CPU]]
    n = kernels.counts()
    print(f"  smooth rescue planner (make_rescue_planner) batch-1 over {N_CPU} worlds: "
          f"{statistics.median(t for t, _ in t_r[1:]) * 1e3:.1f} ms (median after the first), "
          f"feasible {sum(bool(r.feasible) for _, r in t_r)}/{N_CPU}; launches {n}")
    if any(n[k] == 0 for k in BERNSTEIN_KERNELS):
        fail("phase 15 (iii): a kernel of the step was not launched by the rescue planner")
    no_k3(n, "phase 15 (iii)'s rescue planner")
    check_alm_captures(captured, dev, "smooth rescue planner (W = 1)")
    check_chain_captures(captured, dev, "smooth rescue planner (W = 1)")
    check_jrs_screen_captures(captured, dev, "smooth rescue planner (W = 1)")
    captured.clear()
    rt = realtime_phase(robot, cfg_s, one, dev, label="phase 15 (iii): smooth")

    # (iv) the flagship's closed loop in the smooth mode, as phase 5
    worlds = [load_world_csv(p) for p in sorted(glob.glob("saved_worlds/random/*.csv"))[:N_WORLDS]]
    stats: dict = {}
    kernels.reset_counts()
    t_loop, summaries = wall_s(lambda: run_trials_batched(
        worlds, robot, cfg_s, max_iterations=LOOP_ITERATIONS, true_param_scale=1.0, seed=0,
        rescue_solver=True, guidance="straight", stats=stats), dev)
    n = kernels.counts()
    n_it = stats["batch_iterations"]
    flagged = _flagged(summaries)
    print(f"phase 15 (iv): smooth closed loop W={N_WORLDS}, {n_it} lockstep iterations with "
          f"rescue in {t_loop:.1f} s; launches {n}; infeasible plans "
          f"{sum(x.infeasible_plans for x in summaries)}, rescued {stats['recovered_rows']}/"
          f"{stats['rescued_rows']} rows; safety flags in worlds {flagged}")
    if n_it < 1 or any(n[k] == 0 for k in BERNSTEIN_KERNELS):
        fail("phase 15 (iv): no iteration, or a kernel of the step was not launched")
    no_k3(n, "phase 15 (iv)")
    if n["rollout"] != n_it or n["oracle_check"] != n_it:
        fail(f"phase 15 (iv): K5 x{n['rollout']}, K6 x{n['oracle_check']} in {n_it} iterations")
    if flagged:
        fail(f"phase 15 (iv): worlds {flagged} raised a safety flag")
    perf = {"smooth_tau": SMOOTH_TAU, "smooth_feasible": n_s, "hard_feasible": hard["feasible"],
            "smooth_step_ms": t_step * 1e3, "smooth_cpu_flips": flips,
            **{f"smooth_{lab}_feasible": int(o["res"].feasible.sum())
               for lab, o in (("armtd", out_a), ("grasp", out_g), ("ur5", out_u))},
            **{f"smooth_{lab}_solve": o["solve"]
               for lab, o in (("armtd", out_a), ("grasp", out_g), ("ur5", out_u))},
            **{f"smooth_{kk}": vv for kk, vv in rt.items()}, "smooth_loop_iterations": n_it,
            "smooth_loop_wall_s": t_loop,
            **{f"smooth_{kk}": vv for kk, vv in solve_cmp.items()},
            **{f"smooth_{kk}": vv for kk, vv in bd.items()}}
    return rows, perf


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def _same_summary(a, b, times: bool) -> bool:
    """Two TrialSummary records equal, planning_times (the host clock) too
    only when times."""
    import dataclasses

    return (a if times else dataclasses.replace(a, planning_times=b.planning_times)) == b


def serial_suite_phase(robot, cfg, paths, tmp, dev) -> tuple:
    """Phase 16 (i): the serial suite on the card, counted, its K5 / K6 and
    K7-K15 calls at batch 1 against their plain versions; then a suite that
    resumes from the first two worlds' records: they never reach a
    planner, the others give the fresh run's summaries."""
    import os

    from armour_tpu_torch import experiments as texp, kernels, planner as tplanner
    from armour_tpu_torch.collision import pad_obstacles
    from armour_tpu_torch.utils.timing import wall_s
    from armour_tpu_torch.worlds import load_world_csv

    names = [os.path.basename(p) for p in paths]
    fresh_path = os.path.join(tmp, "serial.json")
    stats: dict = {}
    kernels.reset_counts()
    with kernels.capture() as captured:
        t_fresh, fresh = wall_s(lambda: texp.run_world_suite(
            paths, robot, cfg, HARNESS_ITERATIONS, 1.0, 0, False, fresh_path, stats=stats), dev)
    n = kernels.counts()
    iters = sum(r.summary.iterations for r in fresh)
    its = [x for w in names for x in stats[w]["iterations"]]
    plan_ms = [x["plan_s"] * 1e3 for x in its]
    move_ms = [x["move_s"] * 1e3 for x in its]
    oracles_ms = [x["oracles_s"] * 1e3 for x in its]
    print(f"phase 16 (i): serial suite (run_world_suite, batch 1) over {names}, at most "
          f"{HARNESS_ITERATIONS} iterations: {[r.bucket() for r in fresh]}, "
          f"{[r.summary.iterations for r in fresh]} iterations, {t_fresh:.1f} s; per "
          f"iteration plan {statistics.median(plan_ms):.2f} ms (median; max "
          f"{max(plan_ms):.2f}), move (K5 + the state to host) "
          f"{statistics.median(move_ms):.2f} ms (max {max(move_ms):.2f}), oracles (K6 + "
          f"flags to host) {statistics.median(oracles_ms):.2f} ms; launches {n}")
    for name in BERNSTEIN_KERNELS:
        if n[name] == 0:
            fail(f"kernel {name} was not launched by the serial suite")
    no_k3(n, "the serial suite")
    for name in ("rollout", "oracle_check"):
        if n[name] != iters:
            fail(f"kernel {name} launched {n[name]} times in {iters} serial iterations")
    if _flagged([r.summary for r in fresh]):
        fail(f"the serial suite raised a safety flag in {_flagged([r.summary for r in fresh])}")
    check_loop_calls(robot, cfg, captured, dev, "phase 16 (i) batch 1")
    check_alm_captures(captured, dev, "phase 16 (i) serial suite")
    check_chain_captures(captured, dev, "phase 16 (i) serial suite")
    check_jrs_screen_captures(captured, dev, "phase 16 (i) serial suite")
    captured.clear()

    # resume from the first two worlds' records: record every planner call's
    # obstacle set (make_rescue_planner builds on make_planner)
    resume_path = os.path.join(tmp, "resume.json")
    texp.save_results(fresh[:2], resume_path)
    seen, make = [], tplanner.make_planner

    def recording(robot_, cfg_, **kw):
        step = make(robot_, cfg_, **kw)

        def call(q0, qd0, qdd0, q_des, obs):
            seen.append(obs.centers.cpu())
            return step(q0, qd0, qdd0, q_des, obs)
        return call

    stats_r: dict = {}
    tplanner.make_planner = recording
    try:
        resumed = texp.run_world_suite(paths, robot, cfg, HARNESS_ITERATIONS, 1.0, 0, False,
                                       resume_path, resume=True, stats=stats_r)
    finally:
        tplanner.make_planner = make
    padded = [pad_obstacles(w.obstacle_centers, w.obstacle_generators, cfg.max_obstacles,
                            cfg.dtype).centers for w in map(load_world_csv, paths)]
    calls = [sum(torch.equal(c, p) for c in seen) for p in padded]
    same = [_same_summary(a.summary, b.summary, i < 2)
            for i, (a, b) in enumerate(zip(resumed, fresh))]
    print(f"  resumed from {names[:2]}: ran {sorted(stats_r)}; planner calls by world {calls} "
          f"(of {len(seen)}); summaries equal to the fresh run's {same}")
    if sorted(stats_r) != names[2:] or calls[0] or calls[1] or not all(calls[2:]) \
            or sum(calls) != len(seen):
        fail("the resumed serial suite planned a reloaded world or skipped a missing one")
    if not all(same):
        fail("the resumed serial suite's summaries differ from the fresh run's")
    return fresh, {"serial_suite_s": t_fresh, "serial_iterations": iters,
                   "serial_plan_ms_median": statistics.median(plan_ms),
                   "serial_move_ms_median": statistics.median(move_ms),
                   "serial_oracles_ms_median": statistics.median(oracles_ms),
                   "serial_buckets": [r.bucket() for r in fresh]}


def batched_resume_phase(robot, cfg, paths, tmp, dev) -> dict:
    """Phase 16 (ii): the batched suite over the same worlds, then again
    with world 0's record dropped: only world 0 runs (as a sub-batch with
    the full run's true parameters), keeping its bucket and iterations."""
    import os

    from armour_tpu_torch import experiments as texp, kernels
    from armour_tpu_torch.utils.timing import wall_s

    b_path = os.path.join(tmp, "batched.json")
    kernels.reset_counts()
    t_b, fresh = wall_s(lambda: texp.run_world_suite_batched(
        paths, robot, cfg, HARNESS_ITERATIONS, 1.0, 0, False, b_path), dev)
    n = kernels.counts()
    with open(b_path) as f:
        doc = json.load(f)
    doc["results"] = [d for d in doc["results"] if d["world"] != fresh[0].world]
    with open(b_path, "w") as f:
        json.dump(doc, f)
    stats: dict = {}
    kernels.reset_counts()
    again = texp.run_world_suite_batched(paths, robot, cfg, HARNESS_ITERATIONS, 1.0, 0, False,
                                         b_path, None, True, "straight", True, stats=stats)
    n_r = kernels.counts()
    a, b = again[0].summary, fresh[0].summary
    print(f"phase 16 (ii): batched suite over the same worlds: {[r.bucket() for r in fresh]}, "
          f"{[r.summary.iterations for r in fresh]} iterations, {t_b:.1f} s, launches {n}; "
          f"resumed with {fresh[0].world} dropped: {stats.get('resumed_worlds')} reloaded, "
          f"{fresh[0].world} {again[0].bucket()} after {a.iterations} iterations (fresh: "
          f"{fresh[0].bucket()} after {b.iterations}); launches {n_r}")
    for name in BERNSTEIN_KERNELS + ("rollout", "oracle_check"):
        if n[name] == 0 or n_r[name] == 0:
            fail(f"kernel {name} was not launched by the batched suite or its resume")
    no_k3(n, "the batched suite")
    no_k3(n_r, "the batched suite's resume")
    if stats.get("resumed_worlds") != len(paths) - 1 or n_r["rollout"] != a.iterations:
        fail("the batched resume did not run world 0 alone")
    if (again[0].bucket(), a.iterations, a.infeasible_plans) != \
            (fresh[0].bucket(), b.iterations, b.infeasible_plans):
        fail("the batched resume's rerun world differs from the fresh run")
    if [r.bucket() for r in again] != [r.bucket() for r in fresh]:
        fail("the batched resume's reloaded worlds differ from the fresh run")
    return {"batched_suite_s": t_b}


def traced_trial_phase(robot, cfg, path, fresh, tmp, dev) -> dict:
    """Phase 16 (iii): one traced trial (run_trial(trace_path=)) on the
    suite's first world: the JAX writer's keys, its q rows K5's logs every
    trace_stride control steps, its summary the serial suite's."""
    import os

    from armour_tpu_torch import kernels, planner as tplanner, simulator as tsim
    from armour_tpu_torch.collision import pad_obstacles
    from armour_tpu_torch.worlds import load_world_csv

    w = load_world_csv(path)
    obs = pad_obstacles(w.obstacle_centers, w.obstacle_generators, cfg.max_obstacles, cfg.dtype)
    tp = tsim.sample_true_params(robot, np.random.default_rng((0, 0)), scale=1.0)
    base, rows = tsim.make_rollout(robot, cfg), []

    def rollout(q, qd, ref, tp_):
        q2, qd2, logs = base(q, qd, ref, tp_)
        rows.append(logs["q"][0, ::10].cpu().numpy())
        return q2, qd2, logs

    trace = os.path.join(tmp, "trace.npz")
    kernels.reset_counts()
    s = tsim.run_trial(w, robot, cfg, tplanner.make_planner(robot, cfg), obs, tp,
                       HARNESS_ITERATIONS, rollout=rollout,
                       rescue_step=tplanner.make_rescue_planner(robot, cfg), trace_path=trace)
    n = kernels.counts()
    tr = np.load(trace)
    layout = {k: (str(tr[k].dtype), tr[k].shape) for k in tr.files}
    q_rows = np.stack(rows)
    ok = (sorted(tr.files) == sorted(TRACE_KEYS) and tr["k"].shape == (s.iterations, 7)
          and tr["q"].shape == (s.iterations, 50, 7) and np.array_equal(tr["q"], q_rows)
          and tr["q"].dtype == np.float32 and str(tr["robot_name"]) == robot.name
          and float(tr["trace_dt"]) == 1e-3 * 10)
    print(f"phase 16 (iii): traced trial on {os.path.basename(path)}: {s.iterations} "
          f"iterations, launches {n}; trace {layout}; q rows equal K5's logs every 10 steps: "
          f"{np.array_equal(tr['q'], q_rows)}; summary equal to the serial suite's: "
          f"{_same_summary(s, fresh.summary, False)}")
    if not ok:
        fail("the replay trace does not have the JAX layout or K5's logs")
    if n["rollout"] != s.iterations or n["oracle_check"] != s.iterations:
        fail("the traced trial did not launch K5 and K6 once an iteration")
    if not _same_summary(s, fresh.summary, False):
        fail("the traced trial's summary differs from the serial suite's for the same world")
    return {"trace_iterations": s.iterations}


def check_sweep_rollout(robot, cfg, inp, dev, label) -> float:
    """K5 against rollout_plain on a sweep move: q and qd within K5's
    tolerances; u within K5_TOL_U (|u| + 1) of the plain version, or, where
    the plain float32 version itself misses the plain float64 one on the
    same inputs by more (the robust and Althoff terms amplify float32
    rounding at the sweep's tracking errors), within that miss: the worst
    |du| / (K5_TOL_U (|u| + 1)) over the move against the plain float32
    version at most max(1, the same ratio of the float32 plain against the
    float64 plain).  Returns the plain float32 version's milliseconds."""
    from armour_tpu_torch import simulator as tsim
    from armour_tpu_torch.kernels import sim as ksim

    def plain(x):
        return tsim.rollout_plain(robot, cfg, *(x[k] for k in ("q", "qd", "q_des", "qd_des",
                                                               "qdd_des", "tp", "control_dt",
                                                               "substeps", "controller",
                                                               "noise", "gains")))

    got = ksim.rollout(robot, cfg, **inp)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ref = plain(inp)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    x64 = {k: (v.double() if torch.is_tensor(v) else v) for k, v in inp.items()}
    x64["tp"] = inp["tp"].to(torch.float64, dev)
    ref64 = plain(x64)
    dq = max(float((got[i] - ref[i]).abs().max()) for i in (0, 2))
    dqd = max(float((got[i] - ref[i]).abs().max()) for i in (1, 3))
    u, u32, u64 = got[4].double(), ref[4].double(), ref64[4]
    tol = K5_TOL_U * (u32.abs() + 1.0)
    f32 = (u32 - u64).abs() / tol
    worst, own = float(((u - u32).abs() / tol).max()), float(f32.max())
    print(f"  rollout {label} [{tuple(inp['q_des'].shape)}]: max |dq| {dq:.3g} rad <= "
          f"{K5_TOL_Q}, max |dqd| {dqd:.3g} rad/s <= {K5_TOL_QD}; worst |du|/({K5_TOL_U}(|u|+1)) "
          f"against the plain float32 version {worst:.3g} <= max(1, {own:.3g}: the plain "
          f"float32 against the plain float64 version); the kernel against float64 "
          f"{float(((u - u64).abs() / tol).max()):.3g}; control steps where float32 alone "
          f"exceeds K5_TOL_U {int((f32 > 1).any(-1).any(0).sum())} of {u.shape[1]}; plain "
          f"{ms:.1f} ms")
    if dq > K5_TOL_Q or dqd > K5_TOL_QD or worst > max(1.0, own):
        fail(f"K5 disagrees with rollout_plain on the {label}")
    return ms


def sweep_phase(robot, cfg, tmp, dev) -> dict:
    """Phase 16 (iv): the controller sweep on K5, counted; one (level,
    controller) against rollout_plain; every entry beside the JAX package's
    float32 run (results_controller_sweep.json), printed, not gated."""
    import dataclasses
    import os

    from armour_tpu_torch import experiments as texp, kernels, simulator as tsim
    from armour_tpu_torch.utils.timing import wall_s

    kernels.reset_counts()
    t_sweep, sw = wall_s(lambda: texp.robust_controller_sweep(
        robot, cfg, results_path=os.path.join(tmp, "sweep.json")), dev)
    n = kernels.counts()
    levels, ctrls = sw["uncertainties"], list(sw["controllers"])
    print(f"phase 16 (iv): controller sweep, {len(levels)} levels x {len(ctrls)} controllers x "
          f"{sw['n_samples']} samples, float32, in {t_sweep:.2f} s; launches {n}")
    if n["rollout"] != len(levels) * len(ctrls) or sum(n.values()) != n["rollout"]:
        fail(f"the sweep launched {n}, not K5 once a (level, controller)")
    u, ctrl = SWEEP_CHECKED
    q0, qd0, refs = texp.sweep_draws(robot, cfg, sw["n_samples"], 0, dev)
    robot_u = dataclasses.replace(robot, mass_uncertainty=u, inertia_uncertainty=u)
    with kernels.capture() as cap:
        tsim.make_rollout(robot_u, cfg, controller=ctrl)(
            q0, qd0, refs, texp.sweep_true_params(robot, cfg, u, sw["n_samples"], dev))
    inp = next(v for (name, _), v in cap.items() if name == "rollout")
    plain_ms = check_sweep_rollout(robot_u, cfg, inp, dev, f"sweep level {u} {ctrl}")
    with open(SWEEP_FILE) as f:
        ref = json.load(f)
    if ref["uncertainties"] != levels or ref["n_samples"] != sw["n_samples"]:
        fail(f"{SWEEP_FILE} holds another sweep")
    worst = 0.0
    for c in ctrls:
        for m, got in sw["controllers"][c].items():
            want = ref["controllers"][c][m]
            rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
            worst = max(worst, max(rel))
            print(f"  {c} {m}: card {[f'{x:.6g}' for x in got]}; {SWEEP_FILE} "
                  f"{[f'{x:.6g}' for x in want]}; max relative difference {max(rel):.3g}")
    print(f"  largest relative difference from {SWEEP_FILE}: {worst:.3g} (recorded, not "
          f"gated; above {SWEEP_FINDING} it is a finding to bisect)")
    return {"sweep_s": t_sweep, "sweep_max_rel_diff": worst, "sweep_plain_check_ms": plain_ms}


def oracle_phase(robot, cfg, basis, dev) -> dict:
    """Phase 16 (v): one flagship world's JRS (K12), FK (K9) and nominal
    RNEA (K10) on the card against the float64 sparse oracle run on the
    same JRS (pz/oracle_pipeline.py): K9's k-coefficients within
    ORACLE_COEF_TOL and its radii at least the oracle's less ORACLE_SLACK
    at ORACLE_TIMES, every link; K10's centres sliced at 5 seeded k within
    ORACLE_TAU_TOL of oracle_rnea's (threshold ORACLE_THRESHOLD) and its
    radii at least the oracle's less ORACLE_TAU_TOL.  The radius ratios
    (the dense basis' outward rounding) are printed, not gated."""
    from armour_tpu_torch import dynamics, kernels, kinematics
    from armour_tpu_torch.jrs import build_jrs
    from armour_tpu_torch.pz.oracle_pipeline import jrs_to_oracle, oracle_fk, oracle_rnea

    q0, qd0, qdd0, _, _ = scenes(robot, cfg, 1)
    args = [torch.as_tensor(x, dtype=cfg.dtype).to(dev) for x in (q0, qd0, qdd0)]
    kernels.reset_counts()
    with kernels.capture() as captured:
        jrs = build_jrs(*args, robot, cfg, basis)
        links = kinematics.forward_occupancy(jrs, robot, cfg, basis)
        u_nom = dynamics.rnea_pz(jrs, robot, cfg, basis, uncertain=False)
        torch.cuda.synchronize(dev)
    n = kernels.counts()
    for name in ("jrs_bernstein", "fk_chain", "rnea_chain"):
        if n[name] != 1:
            fail(f"phase 16 (v): kernel {name} launched {n[name]} times, not once")
    check_chain_captures(captured, dev, "phase 16 (v) oracle world")
    captured.clear()
    coef = links.coef[0].double().cpu().numpy()                      # [T, J, 3, B]
    drad_all = (np.abs(coef[..., 1:]).sum(-1) + np.abs(links.egen[0].double().cpu().numpy()).sum(-1)
                + links.rad[0].double().cpu().numpy())                # [T, J, 3]
    t0 = time.perf_counter()
    coef_err, below, ratio = 0.0, 0.0, 0.0
    for t in ORACLE_TIMES:
        for i, ref in enumerate(oracle_fk(jrs_to_oracle(jrs, robot, basis, t), robot)):
            want = np.zeros_like(coef[t, i])
            want[:, 0] = ref.center
            for key, v in ref.k_poly().items():
                d = [0] * robot.num_factors
                for (_, j), e in key:
                    d[j] = e
                if sum(d) <= basis.max_degree:
                    want[:, basis.index[tuple(d)]] += v
            coef_err = max(coef_err, float(np.abs(coef[t, i] - want).max()))
            _, orad = ref.to_interval()
            below = max(below, float((orad - drad_all[t, i]).max()))
            ratio = max(ratio, float((drad_all[t, i] / orad).max()))
    t_fk = time.perf_counter() - t0
    t0 = time.perf_counter()
    otau = oracle_rnea(jrs_to_oracle(jrs, robot, basis, ORACLE_RNEA_T), robot, uncertain=False,
                       threshold=ORACLE_THRESHOLD)
    t_rnea = time.perf_counter() - t0
    uc = u_nom.coef[0, ORACLE_RNEA_T].double().cpu()
    ur = (u_nom.egen[0, ORACLE_RNEA_T].double().abs().sum(-1)
          + u_nom.rad[0, ORACLE_RNEA_T].double()).cpu().numpy()
    rng = np.random.default_rng(6)
    tau_err, tau_below, tau_ratio = 0.0, -np.inf, [np.inf, 0.0]
    for _ in range(5):
        k = rng.uniform(-1, 1, robot.num_factors)
        dc = (uc @ basis.phi(torch.as_tensor(k))).numpy()
        for i in range(robot.num_factors):
            oc, orad = otau[i].slice_at(k)
            tau_err = max(tau_err, abs(float(dc[i]) - float(oc)))
            tau_below = max(tau_below, float(orad) - float(ur[i]))
            tau_ratio = [min(tau_ratio[0], float(ur[i] / orad)), max(tau_ratio[1],
                                                                   float(ur[i] / orad))]
    print(f"phase 16 (v): the first flagship world's JRS (K12), FK (K9) and nominal RNEA (K10) "
          f"on the card against the float64 sparse oracle; launches {n}")
    print(f"  K9 at t = {ORACLE_TIMES}, {robot.num_joints} links: max |d k-coefficient| "
          f"{coef_err:.3g} m (tolerance {ORACLE_COEF_TOL}); the oracle's radius exceeds the "
          f"card's by at most {below:.3g} m (slack {ORACLE_SLACK}); card / oracle radius at "
          f"most {ratio:.4f}; oracle_fk {t_fk:.1f} s on the host")
    print(f"  K10 at t = {ORACLE_RNEA_T}, 5 seeded k: max |d centre| {tau_err:.3g} Nm "
          f"(tolerance {ORACLE_TAU_TOL}); the oracle's radius exceeds the card's by at most "
          f"{tau_below:.3g} Nm (slack {ORACLE_TAU_TOL}); card / oracle radius in "
          f"[{tau_ratio[0]:.4f}, {tau_ratio[1]:.4f}]; oracle_rnea (threshold "
          f"{ORACLE_THRESHOLD}) {t_rnea:.1f} s on the host")
    if coef_err > ORACLE_COEF_TOL or below > ORACLE_SLACK:
        fail("K9's reach sets disagree with the sparse oracle")
    if tau_err > ORACLE_TAU_TOL or tau_below > ORACLE_TAU_TOL:
        fail("K10's nominal torque disagrees with the sparse oracle")
    return {"oracle_fk_coef_err": coef_err, "oracle_fk_radius_shortfall": below,
            "oracle_fk_radius_ratio_max": ratio, "oracle_rnea_centre_err": tau_err,
            "oracle_rnea_radius_shortfall": tau_below, "oracle_rnea_radius_ratio": tau_ratio}


def harness_phase(robot, cfg, basis, dev) -> dict:
    """Phase 16: the harness on the card, each path counted on its own."""
    import tempfile

    paths = sorted(glob.glob("saved_worlds/random/*.csv"))[:HARNESS_WORLDS]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        fresh, out = serial_suite_phase(robot, cfg, paths, tmp, dev)
        out.update(batched_resume_phase(robot, cfg, paths, tmp, dev))
        out.update(traced_trial_phase(robot, cfg, paths[0], fresh[0], tmp, dev))
        out.update(sweep_phase(robot, cfg, tmp, dev))
    out.update(oracle_phase(robot, cfg, basis, dev))
    out["harness_phase_s"] = time.perf_counter() - t0
    print(f"phase 16: {out['harness_phase_s']:.1f} s")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs the card")
    import armour_tpu_torch  # noqa: F401  (precision pins)
    from armour_tpu_torch import kernels, nlp
    from armour_tpu_torch.collision import ObstacleSet, collision_constraints_plain
    from armour_tpu_torch.config import ArmourConfig
    from armour_tpu_torch.kernels import reach as reach_k, solver as solver_k
    from armour_tpu_torch.kernels.build import FLAGS as BUILD_FLAGS, build_all
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
    print(f"phase 1: {len(reports)} kernel libraries ready in {time.perf_counter() - t0:.1f} s, "
          f"built with nvcc {' '.join(BUILD_FLAGS)}")
    for name, log in reports.items():
        for line in log.splitlines():
            if ("Function properties for" in line or "registers" in line or "spill" in line
                    or "stack frame" in line):
                print(f"  {name}: {line.strip()}")
    print("  dynamic shared memory per block at the flagship widths (B = 120, E = 38): K7 "
          "step (a) at S = 4 " + ", ".join(f"R = {r}: {solver_k.k7_rows_smem(120, 7, 4, r)} B"
                                           for r in solver_k.K7_TILES)
          + "; K8 step (a) " + ", ".join(f"R = {r}: {solver_k.k8_rows_smem(120, r)} B"
                                         for r in solver_k.K8_TILES)
          + "; K9 " + ", ".join(f"{ng} elements: "
                                f"{reach_k.k9_smem(159, reach_k.lin_ld(7, 38), ng)} B"
                                for ng in (1, 2, 8))
          + "; K10 " + ", ".join(f"{ng} elements: "
                                 f"{reach_k.k10_smem(159, reach_k.lin_ld(7, 38), ng)} B"
                                 for ng in (1, 2, 4)))

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
    launches, device_launches = kernels.counts(), kernels.device_counts()
    in_finish = dict(kernels.IN_FINISH)
    print(f"phase 2: W={N_WORLDS} planning step {t_main * 1e3:.1f} ms "
          f"(first call {t_first * 1e3:.1f} ms); launches {launches}; device launches "
          f"{device_launches}")
    print(f"  K14: {launches['alm_loop']} launches (the cull, the selection), its other "
          f"phases run by a K7 / K8 finish {sum(in_finish.values())} times ({in_finish}); host "
          f"launcher calls of the solve (K7 + K8 + K14): "
          f"{launches['alm_newton'] + launches['alm_values'] + launches['alm_loop']}")
    if launches["alm_loop"] > 2:
        fail(f"K14 launched {launches['alm_loop']} times in one step, not at most 2")
    for name in BERNSTEIN_KERNELS:
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the main path")
    no_k3(launches, "the main path")
    for name in ("jrs_bernstein", "screen_collision", "reach_assembly"):
        if launches[name] != 1:
            fail(f"kernel {name} launched {launches[name]} times in one step, not once")
    for name in OP_KERNELS:
        if launches[name] != 0:
            fail(f"kernel {name} was launched on the main path: the reach sets should run "
                 f"as the chain kernels K9 / K10")
    if launches["grasp_rows"] != 0:
        fail("K16 was launched on the flagship's step, which has no grasp rows")

    # ---- phase 3: kernels against their plain versions ----
    jrs64 = next(v[0] for k, v in captured.items() if k[0] == "rnea_chain")
    op_rec, op_launches, op_device, t_com = uncertain_com_path(
        jrs64, robot, cfg, (q0, qd0, qdd0, q_des, obs), dev)
    captured.update(op_rec)
    add_direct_k3(captured)
    print(f"phase 3: {len(captured)} recorded kernel calls against their plain versions "
          f"(K1 / K2 on the uncertain-COM path's calls and the FK product of joint 1; K3 on "
          f"the step's cells, a direct call: no planning path launches it)")
    krows = kernel_phase(captured, {**launches, **op_launches},
                         {**device_launches, **op_device}, dev)
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
    solve_cmp = solver_phase(prob, cfg, basis, dev)
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
    print(f"  W={N_WORLDS} step {t_step * 1e3:.1f} ms (median of 3), reach sets "
          f"{t_rs * 1e3:.1f} ms (reachset_ms), solve {(t_step - t_rs) * 1e3:.1f} ms; "
          f"{breakdown.get('device_activities', 'not measured')} device activities, busy "
          f"share {breakdown.get('device_busy_share', float('nan')):.3f}")
    window = reach_window(lambda: plan_problem(*args_dev, obs_dev, robot, cfg, basis), dev,
                          f"reach sets of the W={N_WORLDS} step")
    print_k13_k15(krows, breakdown, "Bernstein step")
    prob = plan_problem(*args_dev, obs_dev, robot, cfg, basis)
    k4_perf = k4_modes(prob, cfg, basis, krows, breakdown, dev)
    del prob
    peak = step_peak(lambda: step64(q0, qd0, qdd0, q_des, obs), dev)
    print(f"  W={N_WORLDS} step peak device memory {peak['step_peak_gb']:.3f} GB, "
          f"{peak['step_peak_above_held_gb']:.3f} GB above the {peak['held_gb']:.3f} GB held "
          f"before it (torch.cuda.max_memory_allocated)")

    # batch-1 latency over the first N_LATENCY worlds
    step1 = make_planner(robot, cfg)
    one = [(q0[i], qd0[i], qdd0[i], q_des[i], obs_slice(obs, i)) for i in range(N_LATENCY)]
    wall_s(lambda: step1(*one[0]), dev)
    lats = [wall_s(lambda a=a: step1(*a), dev)[0] for a in one]
    p50, p99 = float(np.percentile(lats, 50)), float(np.percentile(lats, 99))
    sync(dev)

    # ---- phase 5: the closed loop, counted; phase 6: K5 / K6 vs plain ----
    loop_launches, loop_inputs, loop_stats, t_loop, buckets = closed_loop_phase(robot, cfg, dev)
    krows += closed_loop_kernel_rows(robot, cfg, loop_launches, loop_inputs, dev)
    loop_inputs.clear()
    its = loop_stats["iterations"]
    loop = {"worlds": N_WORLDS, "iterations": loop_stats["batch_iterations"],
            "wall_s": t_loop, "buckets": buckets,
            "rescue_iterations": loop_stats["rescue_iterations"],
            "plan_ms": [r["plan_s"] * 1e3 for r in its],
            "rescue_ms": [None if r["rescue_s"] is None else r["rescue_s"] * 1e3 for r in its],
            "rollout_ms": [r["rollout_s"] * 1e3 for r in its],
            "oracles_ms": [r["oracles_s"] * 1e3 for r in its],
            "iteration_ms": [r["iteration_s"] * 1e3 for r in its]}
    print("closed_loop: " + json.dumps(loop))

    # ---- phase 7: the rescue profile's solve; phase 8: the real-time planner ----
    rescue_phase(robot, cfg, basis, args_dev, obs_dev, dev)
    realtime = realtime_phase(robot, cfg, one, dev)

    # ---- phase 9: containment; phase 10: the entry points ----
    contain = containment_phase(jrs64, robot, cfg, basis, dev)
    del jrs64
    entry = armour_io_phase(robot, cfg, dev)
    entry.update(rest_checker_phase(robot, cfg, args_dev, obs_dev, dev))

    # ---- phase 11: a hard scenario ----
    hard = hard_phase(robot, cfg, dev)

    # ---- phase 12: the ARMTD family ----
    k11, armtd_perf = armtd_phase(robot, cfg, basis, q0, q_des, obs, dev, t_step)
    krows.append(k11)

    # ---- phase 13: the grasp path and the zoo ----
    k16, grasp_perf = grasp_phase(dev)
    krows.append(k16)

    # ---- phase 14: the closed loop at J = 9 and F < J ----
    rows9, loop9 = grasp_loop_phase(dev)
    for row in krows:
        for r9 in rows9:
            if row["name"] == r9["name"]:
                row["dumbbell_w64"] = {k: r9[k] for k in (
                    "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "serial_chain_ms", "device_ms") if k in r9}

    # ---- phase 15: the smooth collision mode ----
    smooth_rows, smooth_perf = smooth_phase(
        robot, cfg, basis, (q0, qd0, qdd0, q_des, obs), one, dev,
        {"feasible": n_feas, "step_s": t_step, "breakdown": breakdown, "krows": krows})
    for row in krows:
        if row["name"] in smooth_rows:
            row["smooth_w64"] = smooth_rows[row["name"]]

    # ---- phase 16: the harness ----
    harness = harness_phase(robot, cfg, basis, dev)

    perf = {"card": card, "worlds": N_WORLDS, "feasible": n_feas,
            "solves_per_s": N_WORLDS / t_step, "step_ms": t_step * 1e3,
            "reachset_ms": t_rs * 1e3, "solver_ms": (t_step - t_rs) * 1e3,
            "latency_batch1_p50_ms": p50 * 1e3, "latency_batch1_p99_ms": p99 * 1e3,
            "uncertain_com_step_ms": t_com,
            "budget_ms": 500.0, "batch1_ok": p99 < 0.5,
            "peak_mem_gb": max(peak["run_peak_before_gb"],
                               torch.cuda.max_memory_allocated(dev) / 1e9),
            **{f"w64_{kk}": vv for kk, vv in peak.items()}, **k4_perf, **breakdown, **window,
            **solve_cmp, **realtime, **contain, **entry, **hard, **armtd_perf, **grasp_perf,
            "grasp_loop": loop9, **smooth_perf, **harness}
    print("planning: " + json.dumps(perf))
    print(card)
    print(json.dumps({"kernels": krows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

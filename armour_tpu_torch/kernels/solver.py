"""Launchers of the ALM solver's row kernels K7 (alm_newton) and K8
(alm_values, and its max mode alm_maxima), and of K14 (alm_loop), the solve
loop's bookkeeping between them: its cull and selection launch on their
own (LOOP); every other phase runs in the finish of the K7 / K8 call that
feeds it (epilogue: an AlmEpilogue in the call's arguments, ALM_EPILOGUES
its fields per phase; nlp.loop_pairs hands it to the row pass).  Called by nlp.py for CUDA tensors only;
each checks device, dtype, shapes and contiguity, raises on anything its
kernel does not take, allocates the outputs with torch.empty and launches
on the current stream, without a host synchronisation.

alm_rows() gathers a plan's per-world inputs once per solve (float32 and
contiguous on the card, the torque limits and state limits tightened as the
plain version tightens them, the state limits also untightened for the max
mode, the trajectory family's switch and constants); every launch of the
solve reuses them.
k7_geometry, k8_geometry and k14_geometry are the launch geometries (row
tiles, query groups, grids), pure Python so that the CPU tests check them;
K7's and K8's scratch (link centres, partial sums) is allocated by
alm_newton and alm_values with torch.empty.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import re
import types

import numpy as np
import torch

from . import H100_SMS, launched, ran_in_finish, record
from .build import launcher
from .collision import _require, _stream
from ..pz.basis import KBasis

MAX_B, MAX_F, MAX_DEG = 128, 8, 3
FACTORS = (6, 7)          # the kernels are instantiated for these F (the UR5's 6, the 7-DOF arms')
SMEM_LIMIT = 232448       # bytes of shared memory a block can use on Hopper


K14_THREADS = 128
K14_MAX_A, K14_MAX_S, K14_MAX_F = 16, 8, 8
# csrc/alm_loop.cuh's ALM_EPI_* in order: the phases a K7 / K8 finish runs
EPI_PHASES = ("none", "init", "ladder", "accept", "outer", "pull_start", "pull_step", "pull_end",
              "finish")


class AlmEpilogue(ctypes.Structure):
    """csrc/alm_loop.cuh:AlmEpilogue, the solve loop's phase a K7 / K8 call
    runs in its finish (phase 0: none)."""

    _fields_ = [("phase", ctypes.c_int), ("A", ctypes.c_int),
                ("k", ctypes.c_void_p), ("m0", ctypes.c_void_p), ("best_k", ctypes.c_void_p),
                ("best_cost", ctypes.c_void_p), ("lo", ctypes.c_void_p), ("hi", ctypes.c_void_p),
                ("end_feas", ctypes.c_void_p), ("k_out", ctypes.c_void_p),
                ("best_k_out", ctypes.c_void_p), ("best_cost_out", ctypes.c_void_p),
                ("lam_out", ctypes.c_void_p), ("rho_out", ctypes.c_void_p),
                ("lo_out", ctypes.c_void_p), ("hi_out", ctypes.c_void_p),
                ("mid_out", ctypes.c_void_p), ("alphas", ctypes.c_float * K14_MAX_A)]


class AlmArgs(ctypes.Structure):
    _fields_ = [("u_coef", ctypes.c_void_p), ("u_hi", ctypes.c_void_p),
                ("g_coef", ctypes.c_void_p), ("g_rad", ctypes.c_void_p),
                ("center", ctypes.c_void_p), ("A", ctypes.c_void_p), ("d", ctypes.c_void_p),
                ("delta", ctypes.c_void_p), ("row", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("traj", ctypes.c_void_p), ("limits", ctypes.c_void_p),
                ("continuous", ctypes.c_void_p), ("k", ctypes.c_void_p), ("lam", ctypes.c_void_p),
                ("rho", ctypes.c_void_p), ("seed", ctypes.c_void_p), ("value", ctypes.c_void_p),
                ("feas", ctypes.c_void_p), ("step", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("H", ctypes.c_void_p), ("c", ctypes.c_void_p), ("cost", ctypes.c_void_p),
                ("vmax", ctypes.c_void_p),
                ("W", ctypes.c_int), ("Q", ctypes.c_int), ("S", ctypes.c_int),
                ("M", ctypes.c_int), ("TF", ctypes.c_int), ("TJ", ctypes.c_int),
                ("C", ctypes.c_int), ("K", ctypes.c_int), ("B", ctypes.c_int),
                ("F", ctypes.c_int), ("TG", ctypes.c_int), ("armtd", ctypes.c_int),
                ("maxima", ctypes.c_int),
                ("cost_scale", ctypes.c_float), ("kw", ctypes.c_float),
                ("qb0", ctypes.c_float), ("qb1", ctypes.c_float), ("qb2", ctypes.c_float),
                ("qb3", ctypes.c_float), ("two_pi", ctypes.c_float), ("pi", ctypes.c_float),
                ("dur", ctypes.c_float), ("thr_torque", ctypes.c_float),
                ("thr_col", ctypes.c_float), ("thr_state", ctypes.c_float),
                ("col_margin", ctypes.c_float), ("thr_grasp", ctypes.c_float),
                ("tp", ctypes.c_float), ("dts", ctypes.c_float),
                ("g_tp", ctypes.c_float), ("g_ts", ctypes.c_float),
                ("degs", ctypes.c_ubyte * (MAX_B * MAX_F)), ("epi", AlmEpilogue)]


def _degs_template(basis: KBasis) -> AlmArgs:
    """The basis' degree table in the kernels' parameters, built once per
    basis and kept in basis.kernel_args."""
    tab = basis.kernel_args
    if "alm" not in tab:
        B, nf = basis.degs.shape
        if B > MAX_B or nf > MAX_F or int(basis.degs.max()) > MAX_DEG:
            raise ValueError(f"basis (B={B}, nf={nf}, degree {int(basis.degs.max())}) "
                             "exceeds the ALM kernels' tables")
        args = AlmArgs()
        deg = np.zeros((MAX_B, MAX_F), dtype=np.uint8)
        deg[:B, :nf] = basis.degree_table()
        ctypes.memmove(args.degs, deg.tobytes(), deg.nbytes)
        tab["alm"] = args
    return tab["alm"]


@dataclasses.dataclass
class AlmRows:
    """One plan's inputs to K7 / K8.  prob, cfg and basis are kept for the
    plain versions (nlp.alm_newton_plain / alm_values_plain)."""

    prob: object
    cfg: object
    basis: KBasis
    tensors: dict            # name -> CUDA tensor held for the kernels' pointers
    args: AlmArgs            # the per-plan part of the launch arguments
    M: int


def _bezier_weights(s: float):
    """q_des's weights of beta0, beta1, beta2 and beta3 at a scalar s
    (bezier.q_des), and d q_des / d k_actual (= the last)."""
    b0 = -((s - 1.0) ** 5)
    b1 = 5.0 * s * (s - 1.0) ** 4
    b2 = -10.0 * s**2 * (s - 1.0) ** 3
    b3 = 10.0 * s**3 * (s - 1.0) ** 2
    b4 = -5.0 * s**4 * (s - 1.0)
    b5 = s**5
    return b0, b1, b2, b3 + b4 + b5


def alm_rows(prob, cfg, basis: KBasis) -> AlmRows:
    """Gather and check a plan's inputs to K7 / K8 (three small launches per
    solve: the torque limits, the trajectory scalars, the state limits).  A
    plan with grasp rows (prob.grasp) passes them as views: no copy."""
    if cfg.smooth_obstacle_constraints:
        raise NotImplementedError("smooth obstacle constraints are not ported yet")
    Wn, F = prob.q_des.shape
    if F not in FACTORS or F != basis.nf:
        raise ValueError(f"the ALM kernels take F in {FACTORS} matching the basis, got {F}")
    frs, sc = prob.frs, prob.screened
    _, T, J = frs.center_coef.shape[:3]
    B = basis.size
    TJ = T * J
    C, K = sc.A.shape[2], sc.A.shape[3]
    if cfg.turn_off_input_constraints:
        TF = 0
        u_coef = torch.zeros(1, device=prob.q_des.device, dtype=torch.float32)
        u_hi = u_coef
    else:
        Tt = prob.torque.u_coef.shape[1]
        TF = Tt * F
        u_coef = prob.torque.u_coef.reshape(Wn, TF, B).contiguous()
        u_hi = (prob.limits.torque - prob.torque.torque_radius).reshape(Wn, TF).contiguous()
        _require(u_coef, "u_coef", (Wn, TF, B))
    if prob.grasp is None:
        TG = 0
        g_coef = g_rad = torch.zeros(1, device=prob.q_des.device, dtype=torch.float32)
    else:
        TG = 3 * prob.grasp.g_coef.shape[1]
        g_coef = prob.grasp.g_coef.reshape(Wn, TG, B).contiguous()
        g_rad = prob.grasp.g_rad.reshape(Wn, TG).contiguous()
        _require(g_coef, "grasp g_coef", (Wn, TG, B))
        _require(g_rad, "grasp g_rad", (Wn, TG))
    center = frs.center_coef.reshape(Wn, TJ * 3, B).contiguous()
    _require(center, "center_coef", (Wn, TJ * 3, B))
    _require(sc.A, "screened A", (Wn, 3, C, K))
    _require(sc.d, "screened d", (Wn, C, K))
    _require(sc.delta, "screened delta", (Wn, C, K))
    _require(sc.row, "screened row", (Wn, K), torch.int32)
    _require(sc.mask, "screened mask", (Wn, K), torch.bool)
    tr = prob.traj
    armtd = tr.family == "armtd"
    # the ARMTD rows and cost read the plain version's float32 qd0 in row 1
    traj = torch.stack([tr.q0, tr.qd0 if armtd else tr.Tqd0, tr.TTqdd0, tr.k_scale, prob.q_des],
                       dim=1).contiguous()
    _require(traj, "trajectory scalars", (Wn, 5, F))
    lim, ub, m = prob.limits, cfg.ub, cfg.state_limit_margin
    # margin-tightened for the stack's rows; untightened, as max_violations
    # forms them, for the max mode
    limits = torch.stack([lim.pos_lb + ub.qe + m, lim.pos_ub - ub.qe - m,
                          lim.speed - ub.qde - m, lim.pos_lb + ub.qe, lim.pos_ub - ub.qe,
                          lim.speed - ub.qde]).contiguous()
    _require(limits, "state limits", (6, F))
    continuous = lim.continuous.contiguous()
    _require(continuous, "continuous", (F,), torch.bool)

    args = AlmArgs()
    ctypes.memmove(ctypes.addressof(args), ctypes.addressof(_degs_template(basis)),
                   ctypes.sizeof(AlmArgs))
    tensors = {"u_coef": u_coef, "u_hi": u_hi, "g_coef": g_coef, "g_rad": g_rad,
               "center": center, "traj": traj, "limits": limits, "continuous": continuous}
    for name, t in (("u_coef", u_coef), ("u_hi", u_hi), ("g_coef", g_coef), ("g_rad", g_rad),
                    ("center", center), ("A", sc.A),
                    ("d", sc.d), ("delta", sc.delta), ("row", sc.row), ("mask", sc.mask),
                    ("traj", traj), ("limits", limits), ("continuous", continuous)):
        setattr(args, name, t.data_ptr())
    M = 2 * TF + TG + K + 8 * F
    args.W, args.M, args.TF, args.TJ, args.C, args.K, args.B, args.F = Wn, M, TF, TJ, C, K, B, F
    args.TG = TG
    s_plan = cfg.t_plan / cfg.duration
    b0, b1, b2, b3 = _bezier_weights(s_plan)
    tp, ts = cfg.t_plan, cfg.duration
    args.armtd = int(armtd)
    args.cost_scale, args.kw = cfg.cost_scale, (0.5 * tp * tp if armtd else b3)
    args.qb0, args.qb1, args.qb2, args.qb3 = b0, b1, b2, b3
    # the ARMTD constants as the plain version rounds them: Python doubles
    # rounded once to float32
    args.tp, args.dts = tp, ts - tp
    args.g_tp, args.g_ts = 0.5 * tp * tp, 0.5 * tp * tp + 0.5 * tp * (ts - tp)
    args.two_pi, args.pi = 2.0 * math.pi, math.pi
    args.dur = cfg.duration
    args.thr_torque = cfg.torque_violation_threshold
    args.thr_col = cfg.collision_violation_threshold
    args.thr_state = 0.5 * cfg.state_limit_margin
    args.col_margin = cfg.collision_search_margin
    args.thr_grasp = cfg.grasp_violation_threshold
    return AlmRows(prob=prob, cfg=cfg, basis=basis, tensors=tensors, args=args, M=M)


def _state(rows: AlmRows, k, lam, rho, Q: int):
    a = rows.args
    Wn, F, M = a.W, a.F, a.M
    S = rho.shape[1] if rho.dim() == 2 else -1
    _require(k, "k", (Wn, Q, F))
    _require(lam, "lam", (Wn, S, M))
    _require(rho, "rho", (Wn, S))
    return S


def _launch_args(rows: AlmRows, k, lam, rho, Q: int, S: int) -> AlmArgs:
    args = AlmArgs()
    ctypes.memmove(ctypes.addressof(args), ctypes.addressof(rows.args), ctypes.sizeof(AlmArgs))
    args.k, args.lam, args.rho = k.data_ptr(), lam.data_ptr(), rho.data_ptr()
    args.Q, args.S = Q, S
    return args


K7_MAXS = 8               # seeds one K7 call takes
K7_ROWS_THREADS, K7_FINISH_THREADS, K7_FINISH_CHUNKS = 256, 256, 6
K7_TILES = (64, 32, 16, 8)           # polynomial rows per CTA of K7's step (a)
K7_COL_TILES = (128, 64, 32)         # screened rows per CTA of K7's step (b)


def k7_nacc(F: int) -> int:
    """K7's accumulators per (world, seed): g (F), H's lower triangle, the
    penalty and the violation count (alm_newton.cu:K7Sizes)."""
    return F + F * (F + 1) // 2 + 2


def k7_rows_smem(B: int, F: int, S: int, R: int) -> int:
    """Bytes of shared memory of K7's step (a) with S seeds and R rows per
    CTA (alm_newton.cu:k7_rows_smem)."""
    P = k8_pitch(B)
    return 4 * (8 * K7_MAXS + S * (1 + F) * P + R * P) + B * MAX_F


def k7_rows_static_smem(F: int, S: int, R: int) -> int:
    """Bytes of static shared memory of K7's step (a): the per-warp partial
    sums red[SM][ceil(R / 32)][NACC], SM the seed slots that hold S."""
    slots = next(m for m in (1, 2, 4, 8) if S <= m)
    return 4 * slots * -(-R // 32) * k7_nacc(F)


@dataclasses.dataclass(frozen=True)
class K7Geometry:
    """K7's launch geometry: R polynomial rows per CTA of step (a), RB
    screened rows per CTA of step (b); step (a)'s tiles from t_first on hold
    torque rows and write partials, as does every tile of step (b)."""

    R: int
    RB: int
    tiles_a: int
    t_first: int
    tiles_b: int

    @property
    def npart(self) -> int:
        return self.tiles_a - self.t_first + self.tiles_b

    def ctas(self, Wn: int, S: int) -> tuple:
        """CTAs of steps (a), (b) and (c)."""
        return Wn * self.tiles_a, Wn * self.tiles_b, Wn * S


def k7_geometry(Wn: int, S: int, n_centre: int, n_torque: int, K: int,
                sms: int = H100_SMS) -> K7Geometry:
    """The largest row tiles that still give 2 x sms CTAs in K7's steps (a)
    and (b) (the smallest where none does): each polynomial row is read
    once per call for all S seeds, and the grid fills the card at W = 1 as
    at W = 64.  n_centre: link-centre rows (3 T J), n_torque: torque and
    grasp rows (T F + 3 T in a grasp plan), K: screened rows, per world."""
    if not 1 <= S <= K7_MAXS:
        raise ValueError(f"alm_newton takes 1..{K7_MAXS} seeds, got {S}")
    target = 2 * sms
    n_poly = n_centre + n_torque
    R = next((r for r in K7_TILES if Wn * -(-n_poly // r) >= target), K7_TILES[-1])
    RB = next((r for r in K7_COL_TILES if Wn * -(-K // r) >= target), K7_COL_TILES[-1])
    return K7Geometry(R=R, RB=RB, tiles_a=-(-n_poly // R), t_first=n_centre // R,
                      tiles_b=-(-K // RB))


def alm_newton(rows: AlmRows, k, lam, rho, want_system: bool = False, epi=None):
    """K7: (step [W,S,F], m0 [W,S], feas [W,S], cost [W,S]) at the seeds k
    [W,S,F] with multipliers lam [W,S,M] and penalties rho [W,S]; with
    want_system also g [W,S,F] and H [W,S,F,F].  Three device launches (two
    without screened rows); the scratch (link centres and their gradients,
    partial sums) is allocated here.  epi: the solve loop's ladder for the
    finish to run (an Epilogue), or None."""
    S = k.shape[1] if k.dim() == 3 else -1
    if _state(rows, k, lam, rho, S) != S:
        raise ValueError("alm_newton takes one query per seed")
    a = rows.args
    Wn, F = a.W, a.F
    if Wn * S and (S > K7_MAXS or S * (1 + F) > k8_pitch(a.B)):
        raise ValueError(f"alm_newton takes at most {K7_MAXS} seeds, got {S}")
    dev = k.device
    step = torch.empty(Wn, S, F, device=dev, dtype=torch.float32)
    m0 = torch.empty(Wn, S, device=dev, dtype=torch.float32)
    feas = torch.empty(Wn, S, device=dev, dtype=torch.bool)
    cost = torch.empty(Wn, S, device=dev, dtype=torch.float32)
    g = torch.empty(Wn, S, F, device=dev, dtype=torch.float32) if want_system else None
    H = torch.empty(Wn, S, F, F, device=dev, dtype=torch.float32) if want_system else None
    record("alm_newton", (Wn, S, rows.M, want_system), (rows, k, lam, rho))
    if Wn * S:
        geo = k7_geometry(Wn, S, 3 * a.TJ, a.TF + a.TG, a.K,
                          torch.cuda.get_device_properties(dev).multi_processor_count)
        if k7_rows_smem(a.B, F, S, geo.R) + k7_rows_static_smem(F, S, geo.R) > SMEM_LIMIT:
            raise ValueError(f"K7's row tiles need more than {SMEM_LIMIT} bytes of shared memory")
        pd = torch.empty(Wn, S, 3 * a.TJ, 1 + F, device=dev, dtype=torch.float32)
        part = torch.empty(Wn, geo.npart, S, k7_nacc(F), device=dev, dtype=torch.float32)
        args = _launch_args(rows, k, lam, rho, S, S)
        args.value, args.feas, args.step = m0.data_ptr(), feas.data_ptr(), step.data_ptr()
        args.cost = cost.data_ptr()
        if want_system:
            args.g, args.H = g.data_ptr(), H.data_ptr()
        _set_epilogue(args, epi, "alm_newton")
        fn = launcher("alm_newton", "k7_launch",
                      [ctypes.POINTER(AlmArgs), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p])
        err = fn(ctypes.byref(args), pd.data_ptr(), part.data_ptr(), geo.R, geo.RB, _stream(k))
        if err:
            raise RuntimeError(f"alm_newton launch failed: cudaError {err}")
        launched("alm_newton", 3 if a.K else 2)
        if epi is not None:
            ran_in_finish(epi.phase)
    if want_system:
        return step, m0, feas, cost, g, H
    return step, m0, feas, cost


K8_MAXQ = 16              # queries one K8 call takes
K8_ROWS_THREADS, K8_COL_THREADS = 256, 128
K8_TILES = (64, 32, 16, 8)          # polynomial rows per CTA of K8's step (a)
K8_GROUPS = (16, 12, 8, 6, 4, 2, 1)  # queries per thread of K8's step (b)


def k8_pitch(B: int) -> int:
    """Floats per staged row and basis vector in K7's and K8's step (a)
    (csrc/alm_rows.cuh:alm_pitch)."""
    p = -(-B // 4) * 4
    return p + 4 if (p // 4) % 2 == 0 else p


def k8_rows_smem(B: int, R: int) -> int:
    """Bytes of shared memory of K8's step (a) with R rows per CTA
    (alm_values.cu:k8_rows_smem)."""
    P = k8_pitch(B)
    return 4 * (8 * K8_MAXQ + K8_MAXQ * P + R * P + 2 * K8_MAXQ * R) + B * MAX_F


@dataclasses.dataclass(frozen=True)
class K8Geometry:
    """K8's launch geometry: R polynomial rows per CTA of step (a), G
    queries per thread of step (b) (128 screened rows per CTA), the tiles of
    each step and the scratch's padded query count Qp."""

    R: int
    G: int
    tiles_a: int
    tiles_b: int
    Qp: int

    @property
    def ntiles(self) -> int:
        return self.tiles_a + self.tiles_b

    def ctas(self, Wn: int, Q: int) -> tuple:
        """CTAs of step (a) and step (b)."""
        return Wn * self.tiles_a, Wn * self.tiles_b * -(-Q // self.G)


def k8_geometry(Wn: int, Q: int, n_poly: int, K: int, sms: int = H100_SMS) -> K8Geometry:
    """The largest row tile and the widest query group (at most the
    narrowest that holds all Q queries) that still give 2 x sms CTAs (the
    smallest ones where none does): each row is read once per call for as
    many queries as the card allows, and the grid fills the card at W = 1
    as at W = 64.  n_poly: polynomial rows per world (3 T J centres + T F
    torques + the grasp rows); K: screened rows per world."""
    if not 1 <= Q <= K8_MAXQ:
        raise ValueError(f"alm_values takes 1..{K8_MAXQ} queries, got {Q}")
    target = 2 * sms
    R = next((r for r in K8_TILES if Wn * -(-n_poly // r) >= target), K8_TILES[-1])
    tiles_b = -(-K // K8_COL_THREADS)
    widest = min(g for g in K8_GROUPS if g >= Q)
    G = next((g for g in K8_GROUPS
              if g <= widest and Wn * tiles_b * -(-Q // g) >= target), 1)
    return K8Geometry(R=R, G=G, tiles_a=-(-n_poly // R), tiles_b=tiles_b, Qp=-(-Q // G) * G)


def alm_values(rows: AlmRows, kq, lam, rho, seed_of_q, want_c: bool = False, epi=None):
    """K8: (merit [W,Q], feas [W,Q], cost [W,Q], c [W,Q,M] or None) at the
    query points kq [W,Q,F], query q taking the multipliers lam [W,S,M] and
    penalty rho [W,S] of seed seed_of_q[q] (int32 [Q] on the card).  epi:
    a phase of the solve loop for the finish to run (an Epilogue), or
    None."""
    Q = kq.shape[1] if kq.dim() == 3 else -1
    S = _state(rows, kq, lam, rho, Q)
    _require(seed_of_q, "seed_of_q", (Q,), torch.int32)
    a = rows.args
    Wn, M = a.W, rows.M
    dev = kq.device
    merit = torch.empty(Wn, Q, device=dev, dtype=torch.float32)
    feas = torch.empty(Wn, Q, device=dev, dtype=torch.bool)
    cost = torch.empty(Wn, Q, device=dev, dtype=torch.float32)
    c = torch.empty(Wn, Q, M, device=dev, dtype=torch.float32) if want_c else None
    record("alm_values", (Wn, Q, S, rows.M, want_c), (rows, kq, lam, rho, seed_of_q, want_c))
    if Wn * Q:
        geo = k8_geometry(Wn, Q, 3 * a.TJ + a.TF + a.TG, a.K,
                          torch.cuda.get_device_properties(dev).multi_processor_count)
        p = torch.empty(Wn, geo.Qp, 3, a.TJ, device=dev, dtype=torch.float32)
        part = torch.empty(Wn, geo.ntiles, Q, 2, device=dev, dtype=torch.float32)
        args = _launch_args(rows, kq, lam, rho, Q, S)
        args.seed = seed_of_q.data_ptr()
        args.value, args.feas, args.cost = merit.data_ptr(), feas.data_ptr(), cost.data_ptr()
        if want_c:
            args.c = c.data_ptr()
        _set_epilogue(args, epi, "alm_values")
        _k8_launch(args, p, part, geo, kq)
        launched("alm_values", 3 if a.K else 2)
        if epi is not None:
            ran_in_finish(epi.phase)
    return merit, feas, cost, c


def _k8_launch(args: AlmArgs, p, part, geo: K8Geometry, kq) -> None:
    fn = launcher("alm_values", "k8_launch",
                  [ctypes.POINTER(AlmArgs), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p])
    err = fn(ctypes.byref(args), None if p is None else p.data_ptr(), part.data_ptr(), geo.R,
             geo.G, _stream(kq))
    if err:
        raise RuntimeError(f"alm_values launch failed: cudaError {err}")


def alm_maxima(rows: AlmRows, kq):
    """K8's max mode: (v_torque, v_state, v_grasp) [W,Q] at kq [W,Q,F], the
    torque, state and grasp maxima of nlp.max_violations (max |u| - hi over
    the torque rows, -BIG without them; the 8 F state rows against the
    untightened limits; the max of the grasp rows, -BIG without them).  Two
    device launches: step (a) over the torque and grasp rows alone (no link
    centres, no scratch p) and the finish."""
    Q = kq.shape[1] if kq.dim() == 3 else -1
    a = rows.args
    Wn = a.W
    _require(kq, "k", (Wn, Q, a.F))
    dev = kq.device
    vmax = torch.empty(Wn, Q, 3, device=dev, dtype=torch.float32)
    record("alm_values", (Wn, Q, "maxima"), (rows, kq, "maxima"))
    if Wn * Q:
        geo = k8_geometry(Wn, Q, a.TF + a.TG, a.K,
                          torch.cuda.get_device_properties(dev).multi_processor_count)
        part = torch.empty(Wn, geo.tiles_a, Q, 2, device=dev, dtype=torch.float32)
        args = AlmArgs()
        ctypes.memmove(ctypes.addressof(args), ctypes.addressof(a), ctypes.sizeof(AlmArgs))
        args.k, args.Q, args.maxima, args.vmax = kq.data_ptr(), Q, 1, vmax.data_ptr()
        _k8_launch(args, None, part, geo, kq)
        launched("alm_values", 2 if a.TF + a.TG else 1)
    return vmax[..., 0], vmax[..., 1], vmax[..., 2]


# ---------------------------------------------------------------------------
# K14: the solve loop's bookkeeping (csrc/alm_loop.cuh, csrc/alm_loop.cu)
# ---------------------------------------------------------------------------

# The phases that run as the epilogue of the row pass feeding them: the row
# kernel, then the AlmEpilogue fields the phase reads beside that pass's
# own outputs and those it writes, each name[dims] a tensor (":bool" a bool
# one, else float32) of the given sizes.  Sizes: W worlds, S seeds, F
# factors, A ladder points per seed, Q = S A, S2 = 2 S, M multipliers.  The
# row pass's query points: the seeds' iterate, but the accept's (the ladder,
# Q = S A) and the pull-in steps' (the midpoints).
ALM_EPILOGUES = {
    "init": ("alm_values", "", "best_k_out[W,S,F] best_cost_out[W,S]"),
    "ladder": ("alm_newton", "best_k[W,S,F] best_cost[W,S]",
               "k_out[W,Q,F] best_k_out[W,S,F] best_cost_out[W,S]"),
    "accept": ("alm_values", "k[W,S,F] m0[W,S] best_k[W,S,F] best_cost[W,S]",
               "k_out[W,S,F] best_k_out[W,S,F] best_cost_out[W,S]"),
    "outer": ("alm_values", "best_k[W,S,F] best_cost[W,S]",
              "lam_out[W,S,M] rho_out[W,S] best_k_out[W,S,F] best_cost_out[W,S]"),
    "pull_start": ("alm_values", "best_k[W,S,F] best_cost[W,S]",
                   "lo_out[W,S,F] hi_out[W,S,F] mid_out[W,S,F]"),
    "pull_step": ("alm_values", "lo[W,S,F] hi[W,S,F]",
                  "lo_out[W,S,F] hi_out[W,S,F] mid_out[W,S,F]"),
    "pull_end": ("alm_values", "k[W,S,F] lo[W,S,F] end_feas[W,S]:bool best_cost[W,S]",
                 "k_out[W,S,F]"),
    "finish": ("alm_values", "k[W,S,F] best_k[W,S,F] best_cost[W,S]",
               "k_out[W,S2,F] best_cost_out[W,S]"),
}

# K14's C launchers (csrc/alm_loop.cu), every parameter in order: name[dims]
# a tensor as above; name:float a float; a bare name an int (a size, or a
# grid dimension "blocks*" from k14_geometry); "stream" the stream.  keep:
# kept seeds.  tests/test_torch_alm_loop.py holds this table against the
# source.
K14_PROTOS = {
    "k14_cull": "k[W,S,F] lam[W,S,M] rho[W,S] best_k[W,S,F] best_cost[W,S] v[W,S] cost[W,S] "
                "k_out[W,keep,F] lam_out[W,keep,M] rho_out[W,keep] best_k_out[W,keep,F] "
                "best_cost_out[W,keep] W S keep F M blocks_m blocks_wk stream",
    "k14_select": "kb[W,S2,F] v[W,S2,4] best_cost[W,S] cost_final[W,S] t0:float t1:float "
                  "t2:float t3:float k_out[W,F] feasible_out[W]:bool cost_out[W] viol_out[W,4] "
                  "W S F blocks stream",
}
_PARAM = re.compile(r"(\w+)(?:\[([\w,]+)\])?(?::(\w+))?$")


def _parse(spec: str) -> tuple:
    out = []
    for tok in spec.split():
        name, dims, tag = _PARAM.match(tok).groups()
        if dims is not None:
            kind = "bool" if tag == "bool" else "tensor"
        else:
            kind = "stream" if name == "stream" else (tag or "int")
        out.append((name, kind, tuple(int(d) if d.isdigit() else d
                                      for d in dims.split(",")) if dims else ()))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def k14_params(symbol: str) -> tuple:
    """K14_PROTOS[symbol] as (name, kind, dims): kind "tensor", "bool"
    (a bool tensor), "float", "int" or "stream"; dims the sizes of a
    tensor."""
    return _parse(K14_PROTOS[symbol])


@functools.lru_cache(maxsize=None)
def epilogue_fields(phase: str) -> tuple:
    """ALM_EPILOGUES[phase] as (row kernel, inputs, outputs), each field
    (name, kind, dims) as k14_params gives them."""
    kernel, ins, outs = ALM_EPILOGUES[phase]
    return kernel, _parse(ins), _parse(outs)


def k14_geometry(phase: str, Wn: int, S: int, M: int = 0, keep: int = 0) -> tuple:
    """K14's grid for the phases with launches of their own, in blocks of
    K14_THREADS: "select" a thread per world; "cull" (blocks over M,
    W keep) CTAs."""
    if not 1 <= S <= K14_MAX_S:
        raise ValueError(f"alm_loop takes 1..{K14_MAX_S} seeds, got {S}")
    if phase == "cull":
        if not 1 <= keep <= S:
            raise ValueError(f"the cull keeps 1..{S} seeds, got {keep}")
        return (-(-M // K14_THREADS), Wn * keep)
    if phase == "select":
        return (-(-Wn // K14_THREADS),)
    raise ValueError(f"K14 launches no phase {phase!r} of its own (see ALM_EPILOGUES)")


@functools.lru_cache(maxsize=None)
def _k14_ctypes(symbol: str) -> tuple:
    """The ctypes parameter types of K14's launcher `symbol`, and the names
    of its grid parameters."""
    params = k14_params(symbol)
    types_ = [{"float": ctypes.c_float, "int": ctypes.c_int}.get(kind, ctypes.c_void_p)
              for _, kind, _ in params]
    return types_, tuple(n for n, _, _ in params if n.startswith("blocks"))


def _shape(dims, sz) -> tuple:
    return tuple(d if type(d) is int else sz[d] for d in dims)


def _sizes(**sizes) -> dict:
    return dict(sizes, n=sizes["W"] * sizes["S"], S2=2 * sizes["S"],
                Q=sizes["S"] * sizes.get("A", 0))


def _loop_call(symbol: str, sizes: dict, rec: tuple, **vals) -> None:
    """Launch K14's phase `symbol`: its grid from k14_geometry, each named
    value checked against K14_PROTOS (a tensor's device, dtype, shape and
    contiguity), the int parameters taken from `sizes`; record the call
    as rec = (key, inputs) and count it."""
    sz = _sizes(**sizes)
    grid = k14_geometry(symbol[len("k14_"):], sz["W"], sz["S"], sz.get("M", 0), sz.get("keep", 0))
    argtypes, blocks = _k14_ctypes(symbol)
    sz.update(zip(blocks, grid))
    call, first = [], None
    for name, kind, dims in k14_params(symbol):
        if kind == "tensor" or kind == "bool":
            x = vals.pop(name)
            _require(x, name, _shape(dims, sz), torch.bool if kind == "bool" else torch.float32)
            first = x if first is None else first
            call.append(x.data_ptr())
        elif kind == "float":
            call.append(float(vals.pop(name)))
        elif kind == "int":
            call.append(int(sz[name]))
        else:
            call.append(name)                 # the stream, once every tensor is checked
    if vals:
        raise TypeError(f"{symbol} takes no {sorted(vals)}")
    record("alm_loop", *rec)
    if min(grid) > 0:
        call[call.index("stream")] = _stream(first)
        err = launcher("alm_loop", symbol, argtypes)(*call)
        if err:
            raise RuntimeError(f"alm_loop ({symbol}) launch failed: cudaError {err}")
        launched("alm_loop")


def _seeds(k, what="k"):
    """(W, S, F) of the iterate k [W, S, F]: the sizes K14 takes (the
    tensors are checked against them by _loop_call)."""
    if k.dim() != 3:
        raise ValueError(f"{what} must be [W, S, F], got {tuple(k.shape)}")
    Wn, S, F = k.shape
    if not 1 <= S <= K14_MAX_S or F > K14_MAX_F:
        raise ValueError(f"alm_loop takes 1..{K14_MAX_S} seeds and F <= {K14_MAX_F}, got "
                         f"{tuple(k.shape)}")
    return Wn, S, F


def _empty(*shape, like, dtype=torch.float32):
    return torch.empty(*shape, device=like.device, dtype=dtype)


@dataclasses.dataclass
class Epilogue:
    """A phase of the solve loop for the finish of the row pass that feeds
    it: its descriptor (AlmArgs.epi) and the outputs the finish writes, in
    ALM_EPILOGUES' order."""

    phase: str
    desc: AlmEpilogue
    out: tuple


def epilogue(rows: AlmRows, alphas, phase: str, q, lam, rho, **vals) -> Epilogue:
    """The Epilogue of `phase` (ALM_EPILOGUES) for the row pass at the query
    points q [W,Q,F] with multipliers lam [W,S,M] and penalties rho [W,S]
    (K7 for the ladder, else K8): each of the phase's inputs `vals` checked
    (device, dtype, shape, contiguity) and its pointer set, each output
    allocated with torch.empty.  Records the step as ("alm_loop", (phase,
    W, S, Q, M)) with inputs (rows, alphas, (q, lam, rho, *vals)), the
    step's arguments in nlp.loop_pairs' order."""
    if rho.dim() != 2 or q.dim() != 3:
        raise ValueError(f"the {phase} phase takes rho [W, S] and query points [W, Q, F]")
    Wn, S, F, Q = rows.args.W, rho.shape[1], rows.args.F, q.shape[1]
    if not 1 <= S <= K14_MAX_S:
        raise ValueError(f"alm_loop takes 1..{K14_MAX_S} seeds, got {S}")
    A = len(alphas) if phase == "ladder" else Q // S if phase == "accept" else 0
    if phase == "ladder" and S * A > K14_MAX_A:
        raise ValueError(f"alm_loop takes S * A <= {K14_MAX_A} ladder points, got {S} x {A}")
    if phase == "accept" and (A < 1 or A * S != Q or Q > K14_MAX_A):
        raise ValueError(f"the ladder block has {Q} points for {S} seeds")
    if phase not in ("ladder", "accept") and Q != S:
        raise ValueError(f"the {phase} phase takes one query per seed, got {Q} for {S}")
    _require(q, "query points", (Wn, Q, F))
    step = (q, lam, rho) + tuple(vals.values())
    _, ins, outs = epilogue_fields(phase)
    sz = _sizes(W=Wn, S=S, F=F, A=A, M=rows.M)
    e = AlmEpilogue()
    e.phase, e.A = EPI_PHASES.index(phase), A
    for name, kind, dims in ins:
        x = vals.pop(name)
        _require(x, name, _shape(dims, sz), torch.bool if kind == "bool" else torch.float32)
        setattr(e, name, x.data_ptr())
    if vals:
        raise TypeError(f"the {phase} phase takes no {sorted(vals)}")
    out = []
    for name, kind, dims in outs:
        t = torch.empty(_shape(dims, sz), device=q.device,
                        dtype=torch.bool if kind == "bool" else torch.float32)
        setattr(e, name, t.data_ptr())
        out.append(t)
    if phase == "ladder":
        for i, x in enumerate(alphas):
            e.alphas[i] = x
    record("alm_loop", (phase, Wn, S, Q, rows.M), (rows, tuple(alphas), step))
    return Epilogue(phase, e, tuple(out))


def _set_epilogue(args: AlmArgs, epi, kernel: str) -> None:
    """Hand the row pass `kernel` the phase epi (an Epilogue or None)."""
    if epi is None:
        return
    if ALM_EPILOGUES[epi.phase][0] != kernel:
        raise ValueError(f"{kernel}'s finish does not run the {epi.phase} phase")
    args.epi = epi.desc


def loop_cull(k, lam, rho, best_k, best_cost, v, cost, keep: int):
    """K14 cull (nlp.alm_cull_plain): the kept (k, lam, rho, best_k,
    best_cost)."""
    Wn, S, F = _seeds(k)
    M = lam.shape[-1]
    out = (_empty(Wn, keep, F, like=k), _empty(Wn, keep, M, like=k), _empty(Wn, keep, like=k),
           _empty(Wn, keep, F, like=k), _empty(Wn, keep, like=k))
    _loop_call("k14_cull", dict(W=Wn, S=S, F=F, M=M, keep=keep),
               (("cull", Wn, S, M, keep), (k, lam, rho, best_k, best_cost, v, cost, keep)),
               k=k, lam=lam, rho=rho, best_k=best_k, best_cost=best_cost, v=v, cost=cost,
               **dict(zip(("k_out", "lam_out", "rho_out", "best_k_out", "best_cost_out"), out)))
    return out


def loop_select(kb, v, best_cost, cost_final, thresholds):
    """K14 selection (nlp.alm_select_plain): (k [W,F], feasible [W], cost
    [W], viol [W,4])."""
    if kb.dim() != 3 or kb.shape[1] % 2:
        raise ValueError(f"kb must be [W, 2S, F], got {tuple(kb.shape)}")
    Wn, S2, F = kb.shape
    S = S2 // 2
    out = (_empty(Wn, F, like=kb), _empty(Wn, like=kb, dtype=torch.bool), _empty(Wn, like=kb),
           _empty(Wn, 4, like=kb))
    t = tuple(float(x) for x in thresholds)
    _loop_call("k14_select", dict(W=Wn, S=S, F=F),
               (("select", Wn, S), (kb, v, best_cost, cost_final, t)),
               kb=kb, v=v, best_cost=best_cost, cost_final=cost_final, t0=t[0], t1=t[1],
               t2=t[2], t3=t[3], k_out=out[0], feasible_out=out[1], cost_out=out[2],
               viol_out=out[3])
    return out


# the phases with launches of their own (the others: epilogue)
LOOP = types.SimpleNamespace(cull=loop_cull, select=loop_select)

"""Certified bounds on the mass-matrix eigenvalue range over the joint box
(counterpart of armour_tpu/certify.py).

The ultimate bound eps = sqrt(2 V_max / m_min), and with it every JRS error
radius, rests on m_min being a true lower bound of lambda_min(M(q)) over the
reachable joint box.  Two sound bounds:

  1. Armature (Weyl) bound: M(q) = M_links(q) + diag(armature) with
     M_links(q) PSD, so lambda_min(M) >= min_i armature_i.  For the Kinova
     (armature 8.03..11.99) this alone certifies m_min = 8.03.

  2. Interval branch and bound on M_links, for robots with little or no
     armature: an interval enclosure [M_lo, M_hi] of the link mass matrix
     over a q-sub-box (interval cos / sin pushed through the unit-qdd RNEA
     recursion of rnea_numeric.mass_matrix), then

        lambda_min(M(q)) >= lambda_min(M_center) - maxrowsum(M_radius)

     per box, refined by splitting the widest joint range, with the
     prune-above-incumbent rule.  The base joint is fixed at its midpoint:
     rotating joint 1 rotates the whole arm rigidly and leaves M unchanged.

Everything here is numpy in float64 and runs on the host, once per robot
(interval_link_mass_matrix is the offline hot op; its plain version is
all there is).  The point samples that seed the incumbents are this
package's rnea_numeric.mass_matrix in float64 on the CPU.  A relative
outward slop of 1e-12 per interval product covers non-directed rounding.
"""

from __future__ import annotations

import heapq

import numpy as np

from .robot import RobotModel

_SLOP = 1e-12


def _link_mass_matrix_fn(robot: RobotModel):
    """q (numpy float64 [F]) -> M_links(q) as numpy, through this package's
    numeric RNEA in float64 on the CPU."""
    import torch

    from .rnea_numeric import mass_matrix

    def mm(q):
        qt = torch.as_tensor(np.asarray(q, dtype=np.float64))
        return mass_matrix(robot, qt, include_armature=False).numpy()

    return mm


# ---------------------------------------------------------------------------
# interval arithmetic (lo/hi ndarray pairs, vectorised over leading dims)
# ---------------------------------------------------------------------------


def _imul(alo, ahi, blo, bhi):
    p = np.stack([alo * blo, alo * bhi, ahi * blo, ahi * bhi])
    lo, hi = p.min(axis=0), p.max(axis=0)
    pad = _SLOP * np.maximum(np.abs(lo), np.abs(hi))
    return lo - pad, hi + pad


def _imatvec(Mlo, Mhi, vlo, vhi):
    """[..., 3, 3] x [..., 3] interval matvec."""
    plo, phi = _imul(Mlo, Mhi, vlo[..., None, :], vhi[..., None, :])
    return plo.sum(axis=-1), phi.sum(axis=-1)


def _icross(alo, ahi, blo, bhi):
    def comp(i, j):
        return _imul(alo[..., i], ahi[..., i], blo[..., j], bhi[..., j])

    out_lo, out_hi = [], []
    for i, j in ((1, 2), (2, 0), (0, 1)):
        plo1, phi1 = comp(i, j)
        plo2, phi2 = comp(j, i)
        out_lo.append(plo1 - phi2)
        out_hi.append(phi1 - plo2)
    return np.stack(out_lo, axis=-1), np.stack(out_hi, axis=-1)


def _icos(a, b):
    """Interval enclosure of cos over [a, b] (b - a <= 2 pi assumed safe)."""
    ca, cb = np.cos(a), np.cos(b)
    lo = np.minimum(ca, cb)
    hi = np.maximum(ca, cb)
    # hi -> 1 if [a,b] contains an even multiple of pi; lo -> -1 if odd
    k_lo = np.ceil(a / (2 * np.pi))
    hi = np.where(2 * np.pi * k_lo <= b, 1.0, hi)
    k_lo2 = np.ceil((a - np.pi) / (2 * np.pi))
    lo = np.where(np.pi + 2 * np.pi * k_lo2 <= b, -1.0, lo)
    return lo - _SLOP, hi + _SLOP


def _isin(a, b):
    return _icos(a - np.pi / 2, b - np.pi / 2)


def _interval_joint_rot(robot: RobotModel, i: int, qlo, qhi):
    """Interval enclosure of R_i = rotm_i @ axis_rot(q_i): [..., 3, 3] pair."""
    batch = qlo.shape
    axis = int(robot.axes[i])
    rotm = np.asarray(robot.rot_mats[i], float)
    if axis == 0 or i >= robot.num_factors:
        R = np.broadcast_to(rotm, batch + (3, 3))
        return R.copy(), R.copy()
    sgn = 1.0 if axis > 0 else -1.0
    a, b = np.minimum(sgn * qlo, sgn * qhi), np.maximum(sgn * qlo, sgn * qhi)
    clo, chi = _icos(a, b)
    slo, shi = _isin(a, b)
    Alo = np.zeros(batch + (3, 3))
    Ahi = np.zeros(batch + (3, 3))
    ax = abs(axis) - 1
    idx = [(1, 2), (2, 0), (0, 1)][ax]
    i0, i1 = idx
    Alo[..., ax, ax] = Ahi[..., ax, ax] = 1.0
    Alo[..., i0, i0], Ahi[..., i0, i0] = clo, chi
    Alo[..., i1, i1], Ahi[..., i1, i1] = clo, chi
    Alo[..., i0, i1], Ahi[..., i0, i1] = -shi, -slo
    Alo[..., i1, i0], Ahi[..., i1, i0] = slo, shi
    rl = np.broadcast_to(rotm, batch + (3, 3))
    plo, phi = _imul(rl[..., :, :, None], rl[..., :, :, None],
                     Alo[..., None, :, :], Ahi[..., None, :, :])
    return plo.sum(axis=-2), phi.sum(axis=-2)


def interval_link_mass_matrix(robot: RobotModel, qlo: np.ndarray,
                              qhi: np.ndarray):
    """Interval enclosure [M_lo, M_hi] of the LINK part of the mass matrix
    (no armature) over the joint box [qlo, qhi]; batched over leading dims.

    Mirrors rnea_numeric.mass_matrix: unit-qdd passivity RNEA columns with
    qd = 0 and gravity off, every state variable an interval."""
    J = robot.num_joints
    F = robot.num_factors
    batch = qlo.shape[:-1]
    mass = np.asarray(robot.mass, float)
    com = np.asarray(robot.com, float)
    inertia = np.asarray(robot.inertia, float)
    trans = np.asarray(robot.trans, float)

    Rl, Rh = [], []
    for i in range(J):
        if i < F:
            ql_i, qh_i = qlo[..., i], qhi[..., i]
        else:
            ql_i = qh_i = np.zeros(batch)
        lo, hi = _interval_joint_rot(robot, i, ql_i, qh_i)
        Rl.append(lo)
        Rh.append(hi)

    Mlo = np.zeros(batch + (F, F))
    Mhi = np.zeros(batch + (F, F))
    for j in range(F):
        # forward: unit qdd at joint j, qd = 0, no gravity
        wd_lo = np.zeros(batch + (3,))
        wd_hi = np.zeros(batch + (3,))
        la_lo = np.zeros(batch + (3,))
        la_hi = np.zeros(batch + (3,))
        Fs, Ns = [], []
        for i in range(J):
            Rtl = np.swapaxes(Rl[i], -1, -2)
            Rth = np.swapaxes(Rh[i], -1, -2)
            cl, ch = _icross(wd_lo, wd_hi,
                             np.broadcast_to(trans[i], batch + (3,)),
                             np.broadcast_to(trans[i], batch + (3,)))
            la_lo, la_hi = _imatvec(Rtl, Rth, la_lo + cl, la_hi + ch)
            wd_lo, wd_hi = _imatvec(Rtl, Rth, wd_lo, wd_hi)
            axis = int(robot.axes[i])
            if axis != 0 and i < F and i == j:
                e = np.zeros(3)
                e[abs(axis) - 1] = 1.0 if axis > 0 else -1.0
                wd_lo = wd_lo + e
                wd_hi = wd_hi + e
            cl, ch = _icross(wd_lo, wd_hi,
                             np.broadcast_to(com[i], batch + (3,)),
                             np.broadcast_to(com[i], batch + (3,)))
            Fs.append((mass[i] * (la_lo + cl), mass[i] * (la_hi + ch)))
            Ib = np.broadcast_to(inertia[i], batch + (3, 3))
            nlo, nhi = _imatvec(Ib, Ib, wd_lo, wd_hi)
            Ns.append((nlo, nhi))

        f_lo = np.zeros(batch + (3,))
        f_hi = np.zeros(batch + (3,))
        n_lo = np.zeros(batch + (3,))
        n_hi = np.zeros(batch + (3,))
        for i in reversed(range(J)):
            if i + 1 < J:
                Ril, Rih = Rl[i + 1], Rh[i + 1]
            else:
                eye = np.broadcast_to(np.eye(3), batch + (3, 3))
                Ril = Rih = eye
            rf_lo, rf_hi = _imatvec(Ril, Rih, f_lo, f_hi)
            rn_lo, rn_hi = _imatvec(Ril, Rih, n_lo, n_hi)
            c1l, c1h = _icross(np.broadcast_to(com[i], batch + (3,)),
                               np.broadcast_to(com[i], batch + (3,)),
                               Fs[i][0], Fs[i][1])
            c2l, c2h = _icross(np.broadcast_to(trans[i + 1], batch + (3,)),
                               np.broadcast_to(trans[i + 1], batch + (3,)),
                               rf_lo, rf_hi)
            n_lo = Ns[i][0] + rn_lo + c1l + c2l
            n_hi = Ns[i][1] + rn_hi + c1h + c2h
            f_lo = rf_lo + Fs[i][0]
            f_hi = rf_hi + Fs[i][1]
            axis = int(robot.axes[i])
            if axis != 0 and i < F:
                ax = abs(axis) - 1
                sgn = 1.0 if axis > 0 else -1.0
                tl = sgn * (n_lo[..., ax] if sgn > 0 else n_hi[..., ax])
                th = sgn * (n_hi[..., ax] if sgn > 0 else n_lo[..., ax])
                Mlo[..., i, j] = tl
                Mhi[..., i, j] = th
    return Mlo, Mhi


def _box_lower_bound(robot: RobotModel, qlo, qhi):
    """Certified lower bound of lambda_min(M_links(q)) for each box in the
    batch: lambda_min(M_center_enclosure) - maxrowsum(radius)."""
    Mlo, Mhi = interval_link_mass_matrix(robot, qlo, qhi)
    Mc = 0.5 * (Mlo + Mhi)
    Mr = 0.5 * (Mhi - Mlo)
    # enforce symmetry of the center (the enclosure of a symmetric matrix
    # family may be asymmetric; symmetrising the center shifts it by at most
    # the radius asymmetry, which maxrowsum of the symmetrised radius covers)
    Mr = np.maximum(Mr, np.swapaxes(Mr, -1, -2)) + np.abs(
        0.5 * (Mc - np.swapaxes(Mc, -1, -2)))
    Mc = 0.5 * (Mc + np.swapaxes(Mc, -1, -2))
    ev = np.linalg.eigvalsh(Mc)[..., 0]
    rho = Mr.sum(axis=-1).max(axis=-1)
    return ev - rho


def certified_link_m_min(robot: RobotModel, max_boxes: int = 4000,
                         target_gap: float = 0.05) -> float:
    """Branch-and-bound certified lower bound of min_q lambda_min(M_links(q))
    over the joint box (continuous joints span [-pi, pi]; base joint fixed —
    see module docstring).  Stops when the global bound is within
    `target_gap` (absolute) of the incumbent upper bound or the box budget is
    exhausted; either way the returned value is SOUND (it is the min over
    all leaf bounds)."""
    F = robot.num_factors
    lo = np.where(np.asarray(robot.position_limits_lb) < -100, -np.pi,
                  np.maximum(robot.position_limits_lb, -np.pi)).astype(float)
    hi = np.where(np.asarray(robot.position_limits_ub) > 100, np.pi,
                  np.minimum(robot.position_limits_ub, np.pi)).astype(float)
    # base joint: M is invariant under rigid rotation of the whole arm
    mid0 = 0.5 * (lo[0] + hi[0])
    lo[0] = hi[0] = mid0

    mm = _link_mass_matrix_fn(robot)

    def sample_ub(qlo, qhi):
        qc = 0.5 * (qlo + qhi)
        M = mm(qc)
        return float(np.linalg.eigvalsh(M)[..., 0].min())

    incumbent = sample_ub(lo, hi)
    root_bound = float(_box_lower_bound(robot, lo[None], hi[None])[0])
    # heap of (bound, id, qlo, qhi); refine the weakest bound first
    heap = [(root_bound, 0, lo, hi)]
    counter = 1
    n_eval = 1
    while heap and n_eval < max_boxes:
        bound, _, qlo, qhi = heapq.heappop(heap)
        if bound >= incumbent - target_gap:
            heapq.heappush(heap, (bound, -1, qlo, qhi))
            break
        d = int(np.argmax(qhi - qlo))
        mid = 0.5 * (qlo[d] + qhi[d])
        kids_lo, kids_hi = [], []
        for half in (0, 1):
            a, b = qlo.copy(), qhi.copy()
            if half == 0:
                b[d] = mid
            else:
                a[d] = mid
            kids_lo.append(a)
            kids_hi.append(b)
        bounds = _box_lower_bound(robot, np.stack(kids_lo), np.stack(kids_hi))
        for a, b, bb in zip(kids_lo, kids_hi, bounds):
            incumbent = min(incumbent, sample_ub(a, b))
            heapq.heappush(heap, (float(bb), counter, a, b))
            counter += 1
        n_eval += 2
    certified = min(b for b, *_ in heap) if heap else root_bound
    return max(certified, 0.0)   # M_links is PSD: 0 is always sound


def certified_m_min(robot: RobotModel, max_boxes: int = 4000,
                    target_gap: float = 0.05) -> float:
    """Certified lower bound of lambda_min(M(q)) over the joint box:
    armature Weyl bound + branch-and-bound link bound.

    lambda_min(M_links + diag(a)) >= lambda_min(M_links) + min_i a_i."""
    a = np.asarray(robot.armature, float)[: robot.num_factors]
    a_min = float(a.min())
    if a_min >= 1.0:
        # the armature bound alone is already strong; skip the (expensive)
        # link-part refinement — it can only add a small positive amount
        return a_min
    return a_min + certified_link_m_min(robot, max_boxes, target_gap)


def _box_upper_bound(robot: RobotModel, qlo, qhi):
    """Certified upper bound of lambda_max(M_links(q)) per box:
    lambda_max(M_center) + maxrowsum(radius) (Weyl for symmetric interval
    matrices; same symmetrisation argument as _box_lower_bound)."""
    Mlo, Mhi = interval_link_mass_matrix(robot, qlo, qhi)
    Mc = 0.5 * (Mlo + Mhi)
    Mr = 0.5 * (Mhi - Mlo)
    Mr = np.maximum(Mr, np.swapaxes(Mr, -1, -2)) + np.abs(
        0.5 * (Mc - np.swapaxes(Mc, -1, -2)))
    Mc = 0.5 * (Mc + np.swapaxes(Mc, -1, -2))
    ev = np.linalg.eigvalsh(Mc)[..., -1]
    rho = Mr.sum(axis=-1).max(axis=-1)
    return ev + rho


def certified_link_m_max(robot: RobotModel, max_boxes: int = 2000,
                         target_gap: float = 0.2) -> float:
    """Branch-and-bound certified UPPER bound of max_q lambda_max(M_links(q))
    (the mirror of certified_link_m_min: max-heap on the per-box upper
    bound, incumbent = best sampled lambda_max, prune boxes whose bound is
    below it).  Sound on any budget: the return is the max over all leaf
    bounds."""
    F = robot.num_factors
    lo = np.where(np.asarray(robot.position_limits_lb) < -100, -np.pi,
                  np.maximum(robot.position_limits_lb, -np.pi)).astype(float)
    hi = np.where(np.asarray(robot.position_limits_ub) > 100, np.pi,
                  np.minimum(robot.position_limits_ub, np.pi)).astype(float)
    mid0 = 0.5 * (lo[0] + hi[0])
    lo[0] = hi[0] = mid0

    mm = _link_mass_matrix_fn(robot)

    def sample_lb(qlo, qhi):
        qc = 0.5 * (qlo + qhi)
        M = mm(qc)
        return float(np.linalg.eigvalsh(M)[..., -1].max())

    incumbent = sample_lb(lo, hi)
    root = float(_box_upper_bound(robot, lo[None], hi[None])[0])
    heap = [(-root, 0, lo, hi)]     # max-heap via negation
    counter = 1
    n_eval = 1
    while heap and n_eval < max_boxes:
        nb, _, qlo, qhi = heapq.heappop(heap)
        bound = -nb
        if bound <= incumbent + target_gap:
            heapq.heappush(heap, (nb, -1, qlo, qhi))
            break
        d = int(np.argmax(qhi - qlo))
        mid = 0.5 * (qlo[d] + qhi[d])
        kids_lo, kids_hi = [], []
        for half in (0, 1):
            a, b = qlo.copy(), qhi.copy()
            if half == 0:
                b[d] = mid
            else:
                a[d] = mid
            kids_lo.append(a)
            kids_hi.append(b)
        bounds = _box_upper_bound(robot, np.stack(kids_lo), np.stack(kids_hi))
        for a, b, bb in zip(kids_lo, kids_hi, bounds):
            incumbent = max(incumbent, sample_lb(a, b))
            heapq.heappush(heap, (-float(bb), counter, a, b))
            counter += 1
        n_eval += 2
    return max(-b for b, *_ in heap) if heap else root


def certified_m_max(robot: RobotModel, use_bb: bool = False,
                    max_boxes: int = 2000, target_gap: float = 0.2) -> float:
    """Certified UPPER bound of lambda_max(M(q)): max armature (Weyl) +
    refined trace bound on the link part.

    trace(M_links) = sum_i S_i' I^C_i S_i with I^C_i the composite inertia
    of the subtree about joint i's axis; each term is bounded by
    sum_{j>=i} (m_j d_ij^2 + tr(I_j)) where d_ij = sum of DOWNSTREAM link
    offsets from joint i to joint j plus |com_j| — a per-joint distance
    (round-4 weak #7 used the full chain length L for every pair, 46.1 for
    the Kinova; the refinement gives 16.9 vs the sampled bracket 15.0, a
    13% certified-vs-sampled gap).  lambda_max <= trace since M_links is
    PSD.

    use_bb additionally intersects with the interval branch-and-bound upper
    bound (certified_link_m_max) — measured NOT to converge usefully in the
    7-joint box (the interval radius shrinks like box width while the gap
    to the sampled max is ~2x), so it is off by default.

    m_max feeds the robust-input torque buffer alpha*(M_max - M_min)*eps
    (armour_main.cu:171-210); derive_ultimate_bound keeps the sampled
    bracket when the certified bound would more than double the padding,
    recording the split in ub_cache.json provenance."""
    F = robot.num_factors
    J = robot.num_joints
    a = np.asarray(robot.armature, float)[:F]
    trans = np.asarray(robot.trans, float)
    com = np.asarray(robot.com, float)
    mass = np.asarray(robot.mass, float)
    tr_I = np.trace(np.asarray(robot.inertia, float), axis1=-2, axis2=-1)
    seg = np.linalg.norm(trans, axis=-1)        # [J+1]
    com_n = np.linalg.norm(com, axis=-1)        # [J]
    diag_bound = np.zeros(F)
    for i in range(F):
        for j in range(i, J):
            d_ij = float(seg[i + 1: j + 1].sum() + com_n[j])
            diag_bound[i] += mass[j] * d_ij * d_ij + tr_I[j]
    bound = float(a.max() + diag_bound.sum())
    if use_bb:
        bound = min(bound, float(a.max())
                    + certified_link_m_max(robot, max_boxes, target_gap))
    return bound

"""Degree-5 Bezier (Bernstein) trajectory closed forms (counterpart of
armour_tpu/bezier.py).  Elementwise over tensors; s may be a tensor or a
Python number.  Divisions by a constant go through utils.div (an IEEE
division on the card too)."""

from __future__ import annotations

import torch

from .utils import div


def q_des(q0, Tqd0, TTqdd0, k_actual, s):
    """Position at normalized time s in [0, 1]."""
    b0 = -((s - 1.0) ** 5)
    b1 = 5.0 * s * (s - 1.0) ** 4
    b2 = -10.0 * s**2 * (s - 1.0) ** 3
    b3 = 10.0 * s**3 * (s - 1.0) ** 2
    b4 = -5.0 * s**4 * (s - 1.0)
    b5 = s**5
    beta0 = q0
    beta1 = q0 + div(Tqd0, 5.0)
    beta2 = q0 + div(2.0 * Tqd0, 5.0) + div(TTqdd0, 20.0)
    beta3 = q0 + k_actual
    return b0 * beta0 + b1 * beta1 + b2 * beta2 + (b3 + b4 + b5) * beta3


def q_des_k_weight(s):
    """d q_des / d k_actual at s: the weight b3 + b4 + b5 of beta3, which
    equals s^3 (6 s^2 - 15 s + 10)."""
    b3 = 10.0 * s**3 * (s - 1.0) ** 2
    b4 = -5.0 * s**4 * (s - 1.0)
    b5 = s**5
    return b3 + b4 + b5


def qd_des(q0, Tqd0, TTqdd0, k_actual, s):
    """d(q_des)/ds (divide by duration for real-time velocity)."""
    db0 = -5.0 * (s - 1.0) ** 4
    db1 = 20.0 * s * (s - 1.0) ** 3 + 5.0 * (s - 1.0) ** 4
    db2 = -20.0 * s * (s - 1.0) ** 3 - 30.0 * s**2 * (s - 1.0) ** 2
    db3 = 10.0 * s**3 * (2.0 * s - 2.0) + 30.0 * s**2 * (s - 1.0) ** 2
    db4 = -20.0 * s**3 * (s - 1.0) - 5.0 * s**4
    db5 = 5.0 * s**4
    beta0 = q0
    beta1 = q0 + div(Tqd0, 5.0)
    beta2 = q0 + div(2.0 * Tqd0, 5.0) + div(TTqdd0, 20.0)
    beta3 = q0 + k_actual
    return db0 * beta0 + db1 * beta1 + db2 * beta2 + (db3 + db4 + db5) * beta3


def qdd_des(q0, Tqd0, TTqdd0, k_actual, s):
    """d2(q_des)/ds2 (divide by duration^2 for real-time acceleration)."""
    t5 = s - 1.0
    t8 = t5 * t5
    t9 = t8 * t5
    ddb0 = -20.0 * t9
    ddb1 = 40.0 * t9 + 60.0 * s * t8
    ddb2 = -20.0 * t9 - 120.0 * s * t8 - 30.0 * s**2 * (2.0 * s - 2.0)
    ddb3 = 20.0 * s**3 + 60.0 * s * t8 + 60.0 * s**2 * (2.0 * s - 2.0)
    ddb4 = -40.0 * s**3 - 60.0 * s**2 * t5
    ddb5 = 20.0 * s**3
    beta0 = q0
    beta1 = q0 + div(Tqd0, 5.0)
    beta2 = q0 + div(2.0 * Tqd0, 5.0) + div(TTqdd0, 20.0)
    beta3 = q0 + k_actual
    return ddb0 * beta0 + ddb1 * beta1 + ddb2 * beta2 + (ddb3 + ddb4 + ddb5) * beta3


def q_des_k_indep(q0, Tqd0, TTqdd0, s):
    return (
        q0
        + Tqd0 * s
        - 6.0 * Tqd0 * s**3
        + 8.0 * Tqd0 * s**4
        - 3.0 * Tqd0 * s**5
        + 0.5 * TTqdd0 * s**2
        - 1.5 * TTqdd0 * s**3
        + 1.5 * TTqdd0 * s**4
        - 0.5 * TTqdd0 * s**5
    )


def qd_des_k_indep(q0, Tqd0, TTqdd0, s, duration=1.0):
    return div(
        0.5
        * (s - 1.0) ** 2
        * (2.0 * Tqd0 + 4.0 * Tqd0 * s + 2.0 * TTqdd0 * s - 30.0 * Tqd0 * s**2 - 5.0 * TTqdd0 * s**2),
        duration)


def qdd_des_k_indep(q0, Tqd0, TTqdd0, s, duration=1.0):
    return div(
        -(s - 1.0)
        * (TTqdd0 - (36.0 * Tqd0 + 8.0 * TTqdd0) * s + (60.0 * Tqd0 + 10.0 * TTqdd0) * s**2),
        duration * duration)


# interior critical points of the k-independent parts; denominators vanish
# at rest starts and callers filter non-finite roots


def q_des_k_indep_extrema(Tqd0, TTqdd0):
    den = 5.0 * (6.0 * Tqd0 + TTqdd0)
    disc = torch.sqrt(64.0 * Tqd0**2 + 14.0 * Tqd0 * TTqdd0 + TTqdd0**2)
    return (2.0 * Tqd0 + TTqdd0 + disc) / den, (2.0 * Tqd0 + TTqdd0 - disc) / den


def qd_des_k_indep_extrema(Tqd0, TTqdd0):
    den = 10.0 * (6.0 * Tqd0 + TTqdd0)
    disc = torch.sqrt(6.0 * (54.0 * Tqd0**2 + 14.0 * Tqd0 * TTqdd0 + TTqdd0**2))
    return (18.0 * Tqd0 + 4.0 * TTqdd0 + disc) / den, (18.0 * Tqd0 + 4.0 * TTqdd0 - disc) / den


def qdd_des_k_indep_extrema(Tqd0, TTqdd0):
    den = 10.0 * (6.0 * Tqd0 + TTqdd0)
    disc = torch.sqrt(2.0 * (152.0 * Tqd0**2 + 42.0 * Tqd0 * TTqdd0 + 3.0 * TTqdd0**2))
    return (32.0 * Tqd0 + 6.0 * TTqdd0 + disc) / den, (32.0 * Tqd0 + 6.0 * TTqdd0 - disc) / den


# whole-trajectory extrema in k (state-limit constraints)


def q_extrema_in_k(Tqd0, TTqdd0, k_actual):
    den = 5.0 * (6.0 * Tqd0 - 12.0 * k_actual + TTqdd0)
    disc_sq = 64.0 * Tqd0**2 + 14.0 * Tqd0 * TTqdd0 - 120.0 * k_actual * Tqd0 + TTqdd0**2
    disc = torch.sqrt(torch.clamp(disc_sq, min=0.0))
    valid = disc_sq >= 0.0
    return (2.0 * Tqd0 + TTqdd0 + disc) / den, (2.0 * Tqd0 + TTqdd0 - disc) / den, valid


def qd_extrema_in_k(Tqd0, TTqdd0, k_actual):
    den = 10.0 * (6.0 * Tqd0 - 12.0 * k_actual + TTqdd0)
    disc_sq = 6.0 * (
        150.0 * k_actual**2
        - 180.0 * k_actual * Tqd0
        - 20.0 * k_actual * TTqdd0
        + 54.0 * Tqd0**2
        + 14.0 * Tqd0 * TTqdd0
        + TTqdd0**2
    )
    disc = torch.sqrt(torch.clamp(disc_sq, min=0.0))
    valid = disc_sq >= 0.0
    e2 = (18.0 * Tqd0 - 30.0 * k_actual + 4.0 * TTqdd0 + disc) / den
    e3 = (18.0 * Tqd0 - 30.0 * k_actual + 4.0 * TTqdd0 - disc) / den
    return e2, e3, valid

"""Elementwise interval arithmetic on (lo, hi) tensor pairs (counterpart of
armour_tpu/pz/interval.py)."""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def sym(r):
    """[-r, r] for r >= 0."""
    return -r, r


def add(a, b):
    return a[0] + b[0], a[1] + b[1]


def scale(a, s):
    lo = torch.where(s >= 0, a[0] * s, a[1] * s)
    hi = torch.where(s >= 0, a[1] * s, a[0] * s)
    return lo, hi


def mul(a, b):
    p1 = a[0] * b[0]
    p2 = a[0] * b[1]
    p3 = a[1] * b[0]
    p4 = a[1] * b[1]
    return (torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
            torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)))


def _contains_multiple(lo, hi, period, offset):
    """Does [lo, hi] contain offset + period * n for some integer n?"""
    n = torch.ceil((lo - offset) / period)
    return offset + n * period <= hi


def cos(a):
    lo, hi = a
    clo, chi = torch.cos(lo), torch.cos(hi)
    one = torch.ones_like(clo)
    cmax = torch.where(_contains_multiple(lo, hi, TWO_PI, 0.0), one, torch.maximum(clo, chi))
    cmin = torch.where(_contains_multiple(lo, hi, TWO_PI, math.pi), -one, torch.minimum(clo, chi))
    return cmin, cmax


def sin(a):
    lo, hi = a
    slo, shi = torch.sin(lo), torch.sin(hi)
    one = torch.ones_like(slo)
    smax = torch.where(_contains_multiple(lo, hi, TWO_PI, math.pi / 2), one, torch.maximum(slo, shi))
    smin = torch.where(_contains_multiple(lo, hi, TWO_PI, -math.pi / 2), -one, torch.minimum(slo, shi))
    return smin, smax


def center(a):
    return (a[0] + a[1]) * 0.5


def radius(a):
    return (a[1] - a[0]) * 0.5

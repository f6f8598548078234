"""Single typed configuration for the planner (counterpart of
armour_tpu/config.py).

Every field and derived constant matches the JAX package's ArmourConfig;
only `dtype` is a torch dtype.  A per-robot UltimateBound comes from
derive_ultimate_bound: the cached entry of models/ub_cache.json (this
package's copy), or, with an explicit v_max or use_cache=False, the sampled
eigenvalue bracket of the mass matrix (mass_eigenvalue_bracket, float64 on
the CPU through rnea_numeric) and the certified bounds of certify.py.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
from pathlib import Path
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class UltimateBound:
    """Tracking-error ultimate bound of the robust CBF controller:
    eps = sqrt(2 V_max / M_min); qe/qde/qdae/qddae are the generator radii
    injected into the JRS."""

    alpha: float = 10.0
    v_max: float = 1e-2
    m_max: float = 15.79635774
    m_min: float = 5.095620491878957
    k_r: float = 5.0

    @property
    def eps(self) -> float:
        return math.sqrt(2.0 * self.v_max / self.m_min)

    @property
    def qe(self) -> float:
        return self.eps / self.k_r

    @property
    def qde(self) -> float:
        return 2.0 * self.eps

    @property
    def qdae(self) -> float:
        return self.eps

    @property
    def qddae(self) -> float:
        return 2.0 * self.k_r * self.eps


@dataclasses.dataclass(frozen=True)
class ArmourConfig:
    """Planner + reachability + solver configuration (field meanings and
    defaults as in armour_tpu/config.py:66-181)."""

    duration: float = 1.0
    t_plan: float = 0.5
    num_time_steps: int = 128
    k_range: Tuple[float, ...] = tuple([math.pi / 48] * 7)
    traj_family: str = "bernstein"

    simplify_threshold: float = 5e-4
    max_poly_degree: int = 3
    float_slop: float = 1e-6

    max_obstacles: int = 40
    obstacle_generators: int = 3

    collision_violation_threshold: float = 1e-4
    torque_violation_threshold: float = 1e-2
    collision_search_margin: float = 0.005
    smooth_obstacle_constraints: bool = False
    smooth_tau: float = 0.01

    cost_scale: float = 10.0

    solver_outer_iters: int = 4
    solver_inner_iters: int = 3
    solver_seeds: int = 4
    solver_cull_after: int = 1
    solver_keep_seeds: int = 2
    solver_alphas: Tuple[float, ...] = (1.0, 0.25, 0.03125)
    screen_k: int = 4096
    screen_obstacle_quota: int = 0
    solver_tol: float = 1e-4
    turn_off_input_constraints: bool = False
    state_limit_margin: float = 1e-4

    grasp_constraints: bool = False
    grasp_mu: float = 0.5
    grasp_support_radius: float = 0.05
    grasp_normal_axis: int = 2
    grasp_violation_threshold: float = 1e-4

    ub: UltimateBound = dataclasses.field(default_factory=UltimateBound)

    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.num_time_steps % 2:
            raise ValueError("num_time_steps must be even")

    @property
    def ds(self) -> float:
        return 1.0 / self.num_time_steps

    @classmethod
    def for_robot(cls, robot, derive_ub: bool = True, **overrides) -> "ArmourConfig":
        """Config with per-factor knobs sized to the robot (the default
        k_range is the 7-DOF flagship's).  By default the UltimateBound is
        derived for the robot (derive_ultimate_bound); pass derive_ub=False
        or an explicit ub= to skip."""
        if "k_range" not in overrides:
            overrides["k_range"] = tuple([math.pi / 48] * robot.num_factors)
        if derive_ub and "ub" not in overrides:
            overrides["ub"] = derive_ultimate_bound(robot)
        return cls(**overrides)


def mass_eigenvalue_bracket(robot, n_samples: int = 512, seed: int = 0,
                            margin: float = 0.1, refine_steps: int = 12):
    """(m_min, m_max) bracket of lambda(M(q)) over the joint-limit box
    (armour_tpu/config.py:201-253), a heuristic: the extremes of n_samples
    seeded samples, the 8 worst of each refined by 12 steps of projected
    gradient descent on lambda_min (ascent on lambda_max), then shrunk /
    grown by `margin`.  The gradient is the Rayleigh quotient's of the
    frozen extremal eigenvector, by torch.autograd; float64 on the CPU."""
    import numpy as np

    from .rnea_numeric import mass_matrix

    rng = np.random.default_rng(seed)
    lo = np.maximum(np.asarray(robot.position_limits_lb), -math.pi)
    hi = np.minimum(np.asarray(robot.position_limits_ub), math.pi)
    qs = torch.as_tensor(rng.uniform(lo, hi, (n_samples, robot.num_factors)),
                         dtype=torch.float64)
    lo_t = torch.as_tensor(lo, dtype=torch.float64)
    hi_t = torch.as_tensor(hi, dtype=torch.float64)

    def eig_ends(q):
        e = torch.linalg.eigvalsh(mass_matrix(robot, q))
        return e[..., 0], e[..., -1]

    def refine(q, sign):
        for _ in range(refine_steps):
            with torch.no_grad():
                _, V = torch.linalg.eigh(mass_matrix(robot, q))
                v = V[..., 0] if sign < 0 else V[..., -1]
            qq = q.detach().requires_grad_(True)
            rq = torch.einsum("...i,...ij,...j->...", v, mass_matrix(robot, qq), v)
            (g,) = torch.autograd.grad(rq.sum(), qq)
            q = torch.clamp(q - sign * 0.1 * g, lo_t, hi_t)
        with torch.no_grad():
            a, b = eig_ends(q)
        return a if sign < 0 else b

    with torch.no_grad():
        e_lo, e_hi = eig_ends(qs)
    worst_lo = qs[torch.argsort(e_lo, stable=True)[:8]]
    worst_hi = qs[torch.argsort(-e_hi, stable=True)[:8]]
    r_lo, r_hi = refine(worst_lo, -1), refine(worst_hi, +1)
    m_lo = min(float(e_lo.min()), float(r_lo.min()))
    m_hi = max(float(e_hi.max()), float(r_hi.max()))
    m_min = m_lo * (1.0 - margin)
    m_max = m_hi * (1.0 + margin)
    if not m_min > 0.0:
        raise ValueError("mass matrix must be positive definite")
    return m_min, m_max


def derive_ultimate_bound(robot, v_max: float = None, alpha: float = 10.0,
                          k_r: float = 5.0, n_samples: int = 512,
                          seed: int = 0, margin: float = 0.1,
                          qde_fraction: float = 0.4,
                          use_cache: bool = True,
                          return_provenance: bool = False) -> UltimateBound:
    """Per-robot UltimateBound (armour_tpu/config.py:261-332).

    V_max is a controller design knob.  Without one, eps is chosen first,

        eps = min(sqrt(2 * 1e-2 / m_min), qde_fraction * min(speed_limits) / 2),

    and V_max co-derived as 0.5 * m_min * eps^2; such results are cached per
    robot name in models/ub_cache.json and read from there.  m_min is the
    certified bound (certify.certified_m_min) where it is at least 0.6 of the
    sampled bracket's, else the sampled heuristic; m_max the sampled
    bracket's.  return_provenance adds the dict of how m_min was chosen."""
    if use_cache and v_max is None:
        cached = _ub_cache().get(_ub_cache_key(robot, alpha, k_r, n_samples,
                                               seed, margin, qde_fraction))
        if cached is not None:
            fields = {f.name for f in dataclasses.fields(UltimateBound)}
            ub = UltimateBound(**{k: v for k, v in cached.items() if k in fields})
            return (ub, cached.get("provenance")) if return_provenance else ub

    from .certify import certified_m_max, certified_m_min

    m_min, m_max = mass_eigenvalue_bracket(robot, n_samples, seed, margin)
    m_sampled = m_min
    m_cert = certified_m_min(robot, max_boxes=600)
    certified = m_cert >= 0.6 * m_min
    if certified:
        m_min = m_cert
    if v_max is None:
        eps = min(math.sqrt(2.0 * 1e-2 / m_min),
                  qde_fraction * float(min(robot.speed_limits)) / 2.0)
        v_max = 0.5 * m_min * eps * eps
    ub = UltimateBound(alpha=alpha, v_max=v_max, m_max=m_max, m_min=m_min, k_r=k_r)
    if not return_provenance:
        return ub
    return ub, {"certified": bool(certified), "m_cert": float(m_cert),
                "m_min_sampled": float(m_sampled),
                "m_max_cert": float(certified_m_max(robot)),
                "m_max_sampled": float(m_max)}


def _ub_cache_key(robot, alpha, k_r, n_samples, seed, margin, qde_fraction):
    return (f"{robot.name}|a{alpha}|kr{k_r}|n{n_samples}|s{seed}|m{margin}"
            f"|f{qde_fraction}")


@functools.lru_cache(maxsize=None)
def _ub_cache() -> dict:
    p = Path(__file__).parent / "models" / "ub_cache.json"
    return json.loads(p.read_text()) if p.exists() else {}


DEFAULT_CONFIG = ArmourConfig()

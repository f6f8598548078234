"""Single typed configuration for the planner (counterpart of
armour_tpu/config.py:30-181).

Every field and derived constant matches the JAX package's ArmourConfig;
only `dtype` is a torch dtype.  Deriving a per-robot UltimateBound needs the
numeric RNEA and the certified eigenvalue bounds, which this package does not
carry yet: `ArmourConfig.for_robot(derive_ub=True)` and
`derive_ultimate_bound` raise NotImplementedError.  The flagship Kinova runs
with the default UltimateBound.
"""

from __future__ import annotations

import dataclasses
import math
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
        """Config with per-factor knobs sized to the robot.  derive_ub=True
        needs derive_ultimate_bound, which this package does not carry yet."""
        if "k_range" not in overrides:
            overrides["k_range"] = tuple([math.pi / 48] * robot.num_factors)
        if derive_ub and "ub" not in overrides:
            overrides["ub"] = derive_ultimate_bound(robot)
        return cls(**overrides)


def derive_ultimate_bound(robot, **kwargs) -> UltimateBound:
    """Per-robot UltimateBound (armour_tpu/config.py:261-332).  It needs the
    numeric RNEA and the certified mass-matrix bounds, which are not ported
    yet."""
    raise NotImplementedError(
        "derive_ultimate_bound needs rnea_numeric and certify, which the "
        "PyTorch port does not carry yet; pass ub= explicitly")


DEFAULT_CONFIG = ArmourConfig()

"""Robot model: geometry, inertial parameters and limits as numpy arrays
(copy of armour_tpu/robot.py; the stages turn the arrays into tensors on
their own device)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def rpy_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """Fixed-frame rotation from roll/pitch/yaw."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    return np.array(
        [
            [cp * cy, -cp * sy, sp],
            [cr * sy + cy * sp * sr, cr * cy - sp * sr * sy, -cp * sr],
            [sr * sy - cr * cy * sp, cy * sr + cr * sp * sy, cp * cr],
        ]
    )


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Serial manipulator description.  J = num_joints (moving links),
    F = num_factors (actuated joints)."""

    name: str
    num_joints: int
    num_factors: int
    axes: np.ndarray               # [J] int, 1/2/3 = x/y/z, 0 = fixed
    trans: np.ndarray              # [J+1, 3]
    rots: np.ndarray               # [J, 3] rpy
    rot_mats: np.ndarray           # [J, 3, 3]
    mass: np.ndarray               # [J]
    com: np.ndarray                # [J, 3]
    inertia: np.ndarray            # [J, 3, 3]
    mass_uncertainty: float
    inertia_uncertainty: float
    com_uncertainty: float
    friction: np.ndarray           # [J]
    damping: np.ndarray            # [J]
    armature: np.ndarray           # [J]
    position_limits_lb: np.ndarray  # [F] (1000 = continuous)
    position_limits_ub: np.ndarray  # [F]
    speed_limits: np.ndarray       # [F]
    torque_limits: np.ndarray      # [F]
    gravity: float
    link_center: np.ndarray        # [J, 3]
    link_generators: np.ndarray    # [J, 3]
    continuous_joints: Optional[np.ndarray] = None  # [F] bool

    def __post_init__(self):
        if self.continuous_joints is None:
            object.__setattr__(
                self, "continuous_joints",
                np.asarray(self.position_limits_ub >= 999.0))

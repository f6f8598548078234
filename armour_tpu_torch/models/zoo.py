"""Multi-robot model zoo (counterpart of armour_tpu/models/zoo.py).

The robots of the reference's URDF zoo (Kinova Gen3 as parsed from the URDF
and carrying the dumbbell payload, Fetch arm, KUKA iiwa, Panda, UR5) as
RobotModel constructors backed by the pre-extracted numeric bundle
zoo_data.json (this package's own copy).  Link boxes are the bundle's boxes;
the flagship Kinova in models/kinova.py carries exact ones.  Every zoo robot
runs through the same planning stack: the pipeline is data-driven.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np

from ..robot import RobotModel, rpy_matrix

_DATA = Path(__file__).parent / "zoo_data.json"


@functools.lru_cache(maxsize=None)
def _bundle() -> dict:
    return json.loads(_DATA.read_text())


def list_robots():
    return sorted(_bundle().keys())


def load_zoo_robot(name: str, mass_uncertainty: float = 0.03,
                   inertia_uncertainty: float = 0.03) -> RobotModel:
    d = _bundle()[name]

    def arr(k):
        return np.asarray(d[k], dtype=np.float64)

    rots = arr("rots")
    return RobotModel(
        name=name,
        num_joints=int(d["num_joints"]),
        num_factors=int(d["num_factors"]),
        axes=np.asarray(d["axes"], dtype=np.int64),
        trans=arr("trans"),
        rots=rots,
        rot_mats=np.stack([rpy_matrix(*r) for r in rots]),
        mass=arr("mass"),
        com=arr("com"),
        inertia=arr("inertia"),
        mass_uncertainty=mass_uncertainty,
        inertia_uncertainty=inertia_uncertainty,
        com_uncertainty=0.0,
        friction=arr("friction"),
        damping=arr("damping"),
        armature=arr("armature"),
        position_limits_lb=arr("position_limits_lb"),
        position_limits_ub=arr("position_limits_ub"),
        speed_limits=arr("speed_limits"),
        torque_limits=arr("torque_limits"),
        gravity=float(d["gravity"]),
        link_center=arr("link_center"),
        link_generators=arr("link_generators"),
    )


def fetch_arm() -> RobotModel:
    """Fetch 7-DOF arm (the ARMTD-comparison robot)."""
    return load_zoo_robot("fetch_arm")


def kuka_iiwa() -> RobotModel:
    """KUKA LBR iiwa7 R800 7-DOF."""
    return load_zoo_robot("kuka_iiwa")


def panda() -> RobotModel:
    """Franka Emika Panda 7-DOF."""
    return load_zoo_robot("panda")


def ur5() -> RobotModel:
    """Universal Robots UR5 6-DOF."""
    return load_zoo_robot("ur5")


def kinova_urdf() -> RobotModel:
    """Kinova Gen3 as parsed from the URDF (the flagship in models/kinova.py
    is the header-derived model)."""
    return load_zoo_robot("kinova_urdf")


def kinova_dumbbell() -> RobotModel:
    """Kinova Gen3 carrying the dumbbell payload: 9 bodies, 7 actuated
    joints, the last two fixed (the grasp path's robot)."""
    return load_zoo_robot("kinova_dumbbell")

"""Minimal URDF -> RobotModel parser (serial chains); a copy of
armour_tpu/models/urdf.py returning the port's RobotModel (numpy arrays).

Covers the role of urdfs/urdf_utils/{get_kinematic_params, get_inertial_params,
load_robot_params}.m: walk the URDF's joint chain from the base, collect per-
joint origins (xyz/rpy), rotation axes, inertial parameters and limits, and
derive link bounding boxes.  Rotation axes must be (+-) coordinate axes (the
reference has the same restriction: axes encoded as signed 1/2/3,
KinovaWithoutGripperInfo.h:17).

Link bounding boxes: the reference derives them from the collision meshes
(create_pz_bounding_boxes.m).  Without a mesh processor we approximate each
link's box as the axis-aligned span from the joint origin to the child joint
origin, inflated by `link_radius` — conservative for arm-like links; pass
explicit boxes for exact geometry (models/kinova.py carries the exact,
mesh-derived values).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from ..robot import RobotModel, rpy_matrix


def _floats(s: Optional[str], default="0 0 0") -> np.ndarray:
    return np.array([float(x) for x in (s or default).split()])


def _axis_code(axis_xyz: np.ndarray) -> int:
    """Map an axis vector to signed 1/2/3 (0 if fixed)."""
    idx = int(np.argmax(np.abs(axis_xyz)))
    if abs(axis_xyz[idx]) < 0.9:
        raise ValueError(f"non-coordinate joint axis {axis_xyz} unsupported")
    return (idx + 1) * (1 if axis_xyz[idx] > 0 else -1)


def load_urdf(path: str, name: Optional[str] = None,
              mass_uncertainty: float = 0.03,
              inertia_uncertainty: float = 0.03,
              link_radius: float = 0.05,
              link_boxes: Optional[Dict[str, np.ndarray]] = None,
              gravity: float = 9.81) -> RobotModel:
    tree = ET.parse(path)
    root = tree.getroot()

    links = {l.get("name"): l for l in root.findall("link")}
    joints = list(root.findall("joint"))

    # build the serial chain: parent -> joint map, find base (never a child)
    child_of = {}
    joint_by_parent = {}
    for j in joints:
        p = j.find("parent").get("link")
        c = j.find("child").get("link")
        child_of[c] = j
        joint_by_parent[p] = j
    base = None
    for lname in links:
        if lname not in child_of:
            base = lname
            break
    assert base is not None, "no base link found"

    chain = []
    cur = base
    while cur in joint_by_parent:
        j = joint_by_parent[cur]
        chain.append(j)
        cur = j.find("child").get("link")

    # drop trailing fixed joints with no inertia (frames/eef markers)
    def has_inertia(lname):
        l = links[lname]
        inr = l.find("inertial")
        return inr is not None and inr.find("mass") is not None

    while chain and chain[-1].get("type") == "fixed" and not has_inertia(
        chain[-1].find("child").get("link")
    ):
        chain.pop()

    J = len(chain)
    trans = np.zeros((J + 1, 3))
    rots = np.zeros((J, 3))
    axes = np.zeros(J, dtype=np.int64)
    mass = np.zeros(J)
    com = np.zeros((J, 3))
    inertia = np.zeros((J, 3, 3))
    pos_lb, pos_ub, vel, eff = [], [], [], []
    lname_of = []

    for i, j in enumerate(chain):
        origin = j.find("origin")
        trans[i] = _floats(origin.get("xyz") if origin is not None else None)
        rots[i] = _floats(origin.get("rpy") if origin is not None else None)
        jtype = j.get("type")
        if jtype in ("revolute", "continuous"):
            ax = j.find("axis")
            axes[i] = _axis_code(_floats(ax.get("xyz") if ax is not None else "1 0 0"))
        elif jtype == "fixed":
            axes[i] = 0
        else:
            raise ValueError(f"unsupported joint type {jtype}")

        child = j.find("child").get("link")
        lname_of.append(child)
        l = links[child]
        inr = l.find("inertial")
        if inr is not None and inr.find("mass") is not None:
            mass[i] = float(inr.find("mass").get("value"))
            io = inr.find("origin")
            com[i] = _floats(io.get("xyz") if io is not None else None)
            it = inr.find("inertia")
            if it is not None:
                ixx = float(it.get("ixx", 0)); iyy = float(it.get("iyy", 0))
                izz = float(it.get("izz", 0)); ixy = float(it.get("ixy", 0))
                ixz = float(it.get("ixz", 0)); iyz = float(it.get("iyz", 0))
                inertia[i] = np.array(
                    [[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]]
                )

        if jtype != "fixed":
            lim = j.find("limit")
            if jtype == "continuous" or lim is None:
                pos_lb.append(-1000.0); pos_ub.append(1000.0)
                vel.append(float(lim.get("velocity", 10.0)) if lim is not None else 10.0)
                eff.append(float(lim.get("effort", 100.0)) if lim is not None else 100.0)
            else:
                pos_lb.append(float(lim.get("lower", -1000.0)))
                pos_ub.append(float(lim.get("upper", 1000.0)))
                vel.append(float(lim.get("velocity", 10.0)))
                eff.append(float(lim.get("effort", 100.0)))

    F = len(pos_lb)
    assert all(axes[F:] == 0), "fixed joints must trail the actuated chain"

    # link boxes: span to the child joint origin, inflated by link_radius
    link_center = np.zeros((J, 3))
    link_gens = np.zeros((J, 3))
    for i in range(J):
        nxt = trans[i + 1]
        if link_boxes and lname_of[i] in link_boxes:
            c, g = link_boxes[lname_of[i]]
            link_center[i] = c
            link_gens[i] = g
        else:
            link_center[i] = nxt / 2.0
            link_gens[i] = np.abs(nxt) / 2.0 + link_radius

    return RobotModel(
        name=name or root.get("name", "urdf_robot"),
        num_joints=J,
        num_factors=F,
        axes=axes,
        trans=trans,
        rots=rots,
        rot_mats=np.stack([rpy_matrix(*r) for r in rots]),
        mass=mass,
        com=com,
        inertia=inertia,
        mass_uncertainty=mass_uncertainty,
        inertia_uncertainty=inertia_uncertainty,
        com_uncertainty=0.0,
        friction=np.zeros(J),
        damping=np.zeros(J),
        armature=np.zeros(J),
        position_limits_lb=np.asarray(pos_lb),
        position_limits_ub=np.asarray(pos_ub),
        speed_limits=np.asarray(vel),
        torque_limits=np.asarray(eff),
        gravity=gravity,
        link_center=link_center,
        link_generators=link_gens,
    )

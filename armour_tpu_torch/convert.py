"""Carrying state across from the JAX package.

The planner has no learned weights; its state is the config, the robot, the
obstacle set and the set representations passed between stages.  These
functions turn the JAX package's objects, handed over as numpy arrays or
field dicts (name -> value, e.g. {f.name: getattr(obj, f.name)}), into this
package's objects.  They never import the JAX package: the caller converts
its arrays with numpy.asarray.  Array shapes are kept as given; the stages
of this package expect a leading worlds axis.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .collision import Hyperplanes, ObstacleSet, ScreenedCollision
from .config import ArmourConfig, UltimateBound
from .dynamics import TorqueFRS
from .grasp import ContactWrenchFRS, GraspFRS
from .kinematics import LinkFRS
from .pz.bpz import BPZ
from .robot import RobotModel
from .simulator import TrueParams
from .trajectory import PlanRef

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def torch_dtype(dtype) -> torch.dtype:
    """A numpy/JAX dtype (object, class or name) as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "__name__", None) or getattr(dtype, "name", None) or str(dtype)
    name = str(np.dtype(name))
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]


def config_from_fields(fields: Mapping) -> ArmourConfig:
    """ArmourConfig from the JAX config's fields; maps the dtype and the
    nested UltimateBound."""
    names = {f.name for f in dataclasses.fields(ArmourConfig)}
    kw = {k: v for k, v in fields.items() if k in names}
    if "dtype" in kw:
        kw["dtype"] = torch_dtype(kw["dtype"])
    ub = kw.get("ub")
    if ub is not None and not isinstance(ub, UltimateBound):
        ub_names = [f.name for f in dataclasses.fields(UltimateBound)]
        kw["ub"] = UltimateBound(**{n: (ub[n] if isinstance(ub, Mapping) else getattr(ub, n))
                                    for n in ub_names})
    if "k_range" in kw:
        kw["k_range"] = tuple(float(x) for x in kw["k_range"])
    if "solver_alphas" in kw:
        kw["solver_alphas"] = tuple(float(x) for x in kw["solver_alphas"])
    return ArmourConfig(**kw)


def ultimate_bound_from_fields(fields) -> UltimateBound:
    """UltimateBound from the JAX UltimateBound (or a mapping of its
    fields)."""
    names = [f.name for f in dataclasses.fields(UltimateBound)]
    return UltimateBound(**{n: float(fields[n] if isinstance(fields, Mapping)
                                     else getattr(fields, n)) for n in names})


def robot_from_fields(fields: Mapping) -> RobotModel:
    """RobotModel from the JAX robot's fields (numpy arrays stay numpy):
    the flagship or a zoo robot (models/zoo.py)."""
    names = {f.name for f in dataclasses.fields(RobotModel)}
    kw = {k: (np.asarray(v) if isinstance(v, np.ndarray) else v)
          for k, v in fields.items() if k in names}
    return RobotModel(**kw)


def _t(x, dtype, device):
    return torch.as_tensor(np.array(x), dtype=dtype).to(device)


def obstacles_from_numpy(centers, generators, mask, dtype=torch.float64,
                         device="cpu") -> ObstacleSet:
    return ObstacleSet(centers=_t(centers, dtype, device),
                       generators=_t(generators, dtype, device),
                       mask=_t(mask, torch.bool, device))


def bpz_from_numpy(coef, egen, rad, dtype=torch.float64, device="cpu") -> BPZ:
    return BPZ(coef=_t(coef, dtype, device), egen=_t(egen, dtype, device),
               rad=_t(rad, dtype, device))


def linkfrs_from_numpy(center_coef, shape_gens, radius, dtype=torch.float64,
                       device="cpu") -> LinkFRS:
    return LinkFRS(center_coef=_t(center_coef, dtype, device),
                   shape_gens=_t(shape_gens, dtype, device),
                   radius=_t(radius, dtype, device))


def hyperplanes_from_numpy(A, d, delta, dims, dtype=torch.float64,
                           device="cpu") -> Hyperplanes:
    return Hyperplanes(A=_t(A, dtype, device), d=_t(d, dtype, device),
                       delta=_t(delta, dtype, device), dims=tuple(int(x) for x in dims))


def screened_from_numpy(A, d, delta, row, mask, dtype=torch.float64,
                        device="cpu") -> ScreenedCollision:
    return ScreenedCollision(A=_t(A, dtype, device), d=_t(d, dtype, device),
                             delta=_t(delta, dtype, device),
                             row=_t(row, torch.int32, device),
                             mask=_t(mask, torch.bool, device))


def torque_frs_from_numpy(u_coef, torque_radius, dtype=torch.float64,
                          device="cpu") -> TorqueFRS:
    return TorqueFRS(u_coef=_t(u_coef, dtype, device),
                     torque_radius=_t(torque_radius, dtype, device))


def true_params_from_numpy(mass, inertia, com, dtype=torch.float64,
                           device="cpu") -> TrueParams:
    return TrueParams(mass=_t(mass, dtype, device), inertia=_t(inertia, dtype, device),
                      com=_t(com, dtype, device))


def planref_from_numpy(q0, qd0, qdd0, k_act, prev_q0, prev_qd0, prev_qdd0, prev_k_act,
                       dtype=torch.float64, device="cpu") -> PlanRef:
    return PlanRef(*(_t(x, dtype, device) for x in
                     (q0, qd0, qdd0, k_act, prev_q0, prev_qd0, prev_qdd0, prev_k_act)))


def grasp_frs_from_numpy(g_coef, g_rad, dtype=torch.float64, device="cpu") -> GraspFRS:
    return GraspFRS(g_coef=_t(g_coef, dtype, device), g_rad=_t(g_rad, dtype, device))


def contact_wrench_from_numpy(f_nom, n_nom, f_int, n_int, dtype=torch.float64,
                              device="cpu") -> ContactWrenchFRS:
    """ContactWrenchFRS from four (coef, egen, rad) triples."""
    return ContactWrenchFRS(*(bpz_from_numpy(*p, dtype=dtype, device=device)
                              for p in (f_nom, n_nom, f_int, n_int)))

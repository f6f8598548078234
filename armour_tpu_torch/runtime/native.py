"""ctypes binding of the native real-time runtime (native/armour_rt.cpp):
the robust CBF controller, the numeric RNEA and the plant rollout in C++ on
the host, float64 (the port's counterpart of armour_tpu/runtime/native.py).

The shared library is compiled with g++ at first use into the port's
git-ignored build directory, armour_tpu_torch/_build/, named by a hash of
the source and the flags (never next to the source), and reused while the
source is unchanged.  Its float64 twins are rnea_numeric.rnea,
controller.robust_control and simulator.rollout_plain
(tests/test_torch_native.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np

SRC = Path(__file__).resolve().parents[2] / "native" / "armour_rt.cpp"
BUILD = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lib = None


def build_library(force: bool = False) -> Path:
    """Compile native/armour_rt.cpp into _build/ (cached by a hash of the
    source and the flags; a finished library is moved into place in one
    rename, so a concurrent build never loads a partial file)."""
    src = SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    lib = BUILD / f"libarmour_rt-{tag}.so"
    if force or not lib.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        try:
            subprocess.run(["g++", *FLAGS, str(SRC), "-o", tmp], check=True)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return lib


class _ArtModel(ctypes.Structure):
    _fields_ = [
        ("num_joints", ctypes.c_int),
        ("num_factors", ctypes.c_int),
        ("axes", ctypes.POINTER(ctypes.c_int)),
        ("trans", ctypes.POINTER(ctypes.c_double)),
        ("rot_mats", ctypes.POINTER(ctypes.c_double)),
        ("mass", ctypes.POINTER(ctypes.c_double)),
        ("com", ctypes.POINTER(ctypes.c_double)),
        ("inertia", ctypes.POINTER(ctypes.c_double)),
        ("armature", ctypes.POINTER(ctypes.c_double)),
        ("damping", ctypes.POINTER(ctypes.c_double)),
        ("gravity", ctypes.c_double),
        ("mass_uncertainty", ctypes.c_double),
        ("inertia_uncertainty", ctypes.c_double),
    ]


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        D = ctypes.POINTER(ctypes.c_double)
        lib.art_rnea.argtypes = [ctypes.POINTER(_ArtModel)] + [D] * 6 + [
            ctypes.c_int, ctypes.c_int, D]
        lib.art_robust_control.argtypes = [
            ctypes.POINTER(_ArtModel), ctypes.c_double, ctypes.c_double,
            ctypes.c_double] + [D] * 8
        lib.art_rollout.argtypes = [
            ctypes.POINTER(_ArtModel), D, D, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int] + [D] * 8
        for fn in (lib.art_rnea, lib.art_robust_control, lib.art_rollout):
            fn.restype = None
        _lib = lib
    return _lib


def _f64(x, shape=None) -> np.ndarray:
    """x as a contiguous float64 host array, of `shape` when given (the C
    side reads exactly that many values)."""
    if hasattr(x, "detach"):
        x = x.detach().to("cpu").double().numpy()
    a = np.ascontiguousarray(x, dtype=np.float64)
    if shape is not None and a.shape != tuple(shape):
        raise ValueError(f"expected shape {tuple(shape)}, got {a.shape}")
    return a


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeRuntime:
    """Host-side real-time controller and rollout bound to one RobotModel;
    cfg supplies the controller's gains (cfg.ub)."""

    def __init__(self, robot, cfg=None):
        _load()
        self.robot = robot
        self.cfg = cfg
        # the C struct borrows these arrays' memory: keep them alive
        self._axes = np.ascontiguousarray(robot.axes, dtype=np.int32)
        self._arrays = [_f64(getattr(robot, f)) for f in
                        ("trans", "rot_mats", "mass", "com", "inertia", "armature",
                         "damping")]
        trans, rot_mats, mass, com, inertia, armature, damping = map(_ptr, self._arrays)
        self._model = _ArtModel(
            num_joints=int(robot.num_joints), num_factors=int(robot.num_factors),
            axes=self._axes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            trans=trans, rot_mats=rot_mats, mass=mass, com=com, inertia=inertia,
            armature=armature, damping=damping, gravity=float(robot.gravity),
            mass_uncertainty=float(robot.mass_uncertainty),
            inertia_uncertainty=float(robot.inertia_uncertainty))

    @property
    def _ub(self):
        if self.cfg is None:
            raise ValueError("NativeRuntime needs a cfg for the controller's gains")
        return self.cfg.ub

    def rnea(self, q, qd, qd_aux, qdd, mass=None, inertia=None,
             set_gravity: bool = True, include_armature: bool = True) -> np.ndarray:
        F, J = self.robot.num_factors, self.robot.num_joints
        q, qd, qd_aux, qdd = (_f64(x, (F,)) for x in (q, qd, qd_aux, qdd))
        m = None if mass is None else _f64(mass, (J,))
        inr = None if inertia is None else _f64(inertia, (J, 3, 3))
        tau = np.zeros(F)
        _load().art_rnea(ctypes.byref(self._model), _ptr(q), _ptr(qd), _ptr(qd_aux),
                         _ptr(qdd), None if m is None else _ptr(m),
                         None if inr is None else _ptr(inr),
                         int(set_gravity), int(include_armature), _ptr(tau))
        return tau

    def control(self, q, qd, q_des, qd_des, qdd_des) -> Tuple[np.ndarray, np.ndarray,
                                                                np.ndarray]:
        """u, tau, v of the robust CBF control update
        (controller.robust_control's twin)."""
        ub = self._ub
        F = self.robot.num_factors
        arrs = [_f64(x, (F,)) for x in (q, qd, q_des, qd_des, qdd_des)]
        u, tau, v = np.zeros(F), np.zeros(F), np.zeros(F)
        _load().art_robust_control(ctypes.byref(self._model), float(ub.k_r),
                                   float(ub.alpha), float(ub.v_max),
                                   *(_ptr(a) for a in arrs), _ptr(u), _ptr(tau), _ptr(v))
        return u, tau, v

    def rollout(self, q0, qd0, q_des, qd_des, qdd_des, true_mass, true_inertia,
                dt: float = 1e-3, substeps: int = 2):
        """Closed-loop rollout under zero-order-hold control at dt; the
        reference arrays are [n_steps, F], one row a control tick.  Returns
        (q_log, qd_log, u_log)."""
        ub = self._ub
        F, J = self.robot.num_factors, self.robot.num_joints
        q_des = _f64(q_des)
        n = q_des.shape[0]
        q_des, qd_des, qdd_des = (_f64(x, (n, F)) for x in (q_des, qd_des, qdd_des))
        q0, qd0 = _f64(q0, (F,)), _f64(qd0, (F,))
        tm, ti = _f64(true_mass, (J,)), _f64(true_inertia, (J, 3, 3))
        q_log, qd_log, u_log = np.zeros((n, F)), np.zeros((n, F)), np.zeros((n, F))
        _load().art_rollout(ctypes.byref(self._model), _ptr(tm), _ptr(ti),
                            float(ub.k_r), float(ub.alpha), float(ub.v_max), float(dt),
                            int(substeps), int(n), _ptr(q0), _ptr(qd0), _ptr(q_des),
                            _ptr(qd_des), _ptr(qdd_des), _ptr(q_log), _ptr(qd_log),
                            _ptr(u_log))
        return q_log, qd_log, u_log

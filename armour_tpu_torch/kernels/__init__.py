"""Hand-written CUDA kernels for Hopper (sm_90a) and their launch counters.

  K1 pz_matmul_linear   csrc/pz_matmul_linear.cu   (kernels/pz.py)
  K2 pz_cross           csrc/pz_cross.cu           (kernels/pz.py)
  K3 build_hyperplanes  csrc/build_hyperplanes.cu  (kernels/collision.py)
  K4 collision_rows     csrc/collision_rows.cu     (kernels/collision.py)
  K5 rollout            csrc/rollout.cu            (kernels/sim.py)
  K6 oracle_check       csrc/oracle_check.cu       (kernels/sim.py)
  K7 alm_newton         csrc/alm_newton.cu         (kernels/solver.py)
  K8 alm_values         csrc/alm_values.cu         (kernels/solver.py)
  K9 fk_chain           csrc/fk_chain.cu           (kernels/reach.py)
  K10 rnea_chain        csrc/rnea_chain.cu         (kernels/reach.py)
  K11 jrs_armtd         csrc/jrs_armtd.cu          (kernels/jrs.py)
  K12 jrs_bernstein     csrc/jrs_bernstein.cu      (kernels/jrs.py)
  K13 screen_collision  csrc/screen_collision.cu   (kernels/collision.py)
  K14 alm_loop          csrc/alm_loop.cu           (kernels/solver.py)
  K15 reach_assembly    csrc/reach_assembly.cu     (kernels/reach.py)
  K16 grasp_rows        csrc/grasp_rows.cu         (kernels/grasp.py)

The public wrappers live beside their plain PyTorch versions (pz/bpz.py,
collision.py, simulator.py, nlp.py, kinematics.py, dynamics.py, armtd.py,
jrs.py, grasp.py): a CPU tensor takes the plain version, a CUDA tensor launches the
kernel through the launchers here or raises.  Each launcher calls
launched(name) where it launches its kernel and nowhere else: LAUNCHES[name]
counts the wrapper's calls, DEVICE_LAUNCHES[name] the device kernels they
launched (K7, K8 and K13 run three per call, K8's max mode two, every
other kernel one).  K14 launches only its cull and selection; its other
phases run in K7's / K8's finish, counted by phase in IN_FINISH.
Sources are compiled with nvcc at first use (kernels/build.py); every
launcher calls its C function inside build.on_device, on its tensors'
device and that device's current stream.
"""

from __future__ import annotations

import contextlib

KERNELS = ("pz_matmul_linear", "pz_cross", "build_hyperplanes", "collision_rows",
           "rollout", "oracle_check", "alm_newton", "alm_values", "fk_chain", "rnea_chain",
           "jrs_armtd", "jrs_bernstein", "screen_collision", "alm_loop", "reach_assembly",
           "grasp_rows")

H100_SMS = 132            # streaming multiprocessors of an H100 SXM (launch geometry defaults)

LAUNCHES = {name: 0 for name in KERNELS}
DEVICE_LAUNCHES = {name: 0 for name in KERNELS}
# K14's phases that a K7 / K8 finish ran (kernels/solver.py:ALM_EPILOGUES), by
# phase: they launch nothing of their own
IN_FINISH = {}

# when a dict: the first call of each (kernel, shape signature) records its
# inputs here, so that a run can replay the main path's calls against the
# plain versions (see chip_smoke.py)
_CAPTURE = None


def launched(name: str, device_launches: int = 1) -> None:
    LAUNCHES[name] += 1
    DEVICE_LAUNCHES[name] += device_launches


def ran_in_finish(phase: str) -> None:
    IN_FINISH[phase] = IN_FINISH.get(phase, 0) + 1


def reset_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
        DEVICE_LAUNCHES[name] = 0
    IN_FINISH.clear()


def counts() -> dict:
    return dict(LAUNCHES)


def device_counts() -> dict:
    return dict(DEVICE_LAUNCHES)


@contextlib.contextmanager
def capture():
    """Record the inputs of the first launch of every (kernel, shapes)
    signature made inside the block: yields {key: (name, inputs)}."""
    global _CAPTURE
    rec = {}
    _CAPTURE = rec
    try:
        yield rec
    finally:
        _CAPTURE = None


def record(name: str, key, inputs) -> None:
    if _CAPTURE is not None and (name, key) not in _CAPTURE:
        _CAPTURE[(name, key)] = inputs

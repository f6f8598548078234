"""Build and load the CUDA kernels.

Each csrc/*.cu source is compiled by its own nvcc process into a shared
library with a plain C interface (one launch function per kernel) and loaded
with ctypes.  build_all() starts every missing compile at once and waits for
all of them.  Libraries go to armour_tpu_torch/_build/ (git-ignored), named
by a hash of the source, the shared header and the flags, so a changed
source is rebuilt and an unchanged one is reused.  No fast math: IEEE
float32 division, square root and no contraction into fused multiply-adds.
on_device() is the guard every launcher calls the C side in.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "_build"

SOURCES = {
    "pz_matmul_linear": "pz_matmul_linear.cu",
    "pz_cross": "pz_cross.cu",
    "build_hyperplanes": "build_hyperplanes.cu",
    "collision_rows": "collision_rows.cu",
    "rollout": "rollout.cu",
    "oracle_check": "oracle_check.cu",
    "alm_newton": "alm_newton.cu",
    "alm_values": "alm_values.cu",
    "fk_chain": "fk_chain.cu",
    "rnea_chain": "rnea_chain.cu",
    "jrs_armtd": "jrs_armtd.cu",
    "jrs_bernstein": "jrs_bernstein.cu",
    "screen_collision": "screen_collision.cu",
    "alm_loop": "alm_loop.cu",
    "reach_assembly": "reach_assembly.cu",
    "grasp_rows": "grasp_rows.cu",
}

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]

_LIBS = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                           "with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / SOURCES[name]).read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Compile every missing library in parallel; returns {name: nvcc /
    ptxas report} for every library asked for (kept beside the library, so
    a library built by an earlier call reports too)."""
    names = list(SOURCES) if names is None else list(names)
    BUILD.mkdir(parents=True, exist_ok=True)
    procs, reports = {}, {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            reports[name] = log.read_text() if log.exists() else ""
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        cmd = [nvcc(), *FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use."""
    if name not in _LIBS:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]


def launcher(name: str, symbol: str, argtypes):
    """The C launch function `symbol` of kernel `name` (returns the CUDA
    error code of the launch)."""
    fn = getattr(library(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


@contextlib.contextmanager
def on_device(t):
    """Enter the device of the CUDA tensor t for a call through ctypes, and
    yield that device's current stream as a ctypes pointer.  The C side
    launches, sets kernel attributes and writes __constant__ memory on the
    runtime's current device, so every launch and every table upload runs
    inside this guard: a kernel given tensors on cuda:i runs on card i,
    on that card's current stream, whatever the current device is."""
    dev = t.device
    with torch.cuda.device(dev):
        yield ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

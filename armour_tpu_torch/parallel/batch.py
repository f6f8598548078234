"""Scale-out: shard batched planning over several devices (counterpart of
armour_tpu/parallel/batch.py).

The planner's only scale axis is data parallelism over independent planning
problems (worlds x initial states x waypoints).  A mesh here is an ordered
tuple of torch devices on one 'worlds' axis; a device may appear more than
once (two shards on one card, or ["cpu"] * 4).  The sharded step splits the
[W, ...] inputs into len(mesh) contiguous shards, queues make_batch_planner's
step for each shard on that shard's device from one host thread (its ops
and kernels run on their tensors' device and its current stream, whatever
the current device is), and only then copies every output field to the
mesh's first device, in world order.  The step makes no host
synchronisation, so the cards run their shards while the host queues the
next; there is no collective in the forward path.  The summary's three sums
are reduced across processes by one all_reduce where torch.distributed is
initialised (gloo; each process holds its own mesh and its own worlds), the
counterpart of the JAX package's psum.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..collision import ObstacleSet, stack_obstacles
from ..config import ArmourConfig
from ..nlp import SolveResult
from ..planner import make_batch_planner
from ..robot import RobotModel

# stack_obstacles is collision.stack_obstacles, under the JAX module's name too
__all__ = ["Mesh", "make_mesh", "make_sharded_planner", "make_sharded_summary",
           "stack_obstacles"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of a 1-D mesh, in shard order, and its axis name."""

    devices: tuple
    axis_names: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    def __len__(self) -> int:
        return len(self.devices)


def _mesh_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"{dev}: no CUDA device is available; pass devices=['cpu'] * n "
                           "to shard over the CPU")
    n = torch.cuda.device_count()
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if not 0 <= index < n:
        raise ValueError(f"{dev}: this host has {n} CUDA device(s), cuda:0 to cuda:{n - 1}")
    return torch.device("cuda", index)


def make_mesh(devices=None, axis: str = "worlds") -> Mesh:
    """A mesh over `devices` (torch devices or their names, in shard order,
    repeats allowed), by default every card of the host; raises where a
    card is asked for and none is present, and for a card index at or past
    torch.cuda.device_count()."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices=['cpu'] * n to "
                               "shard over the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = tuple(_mesh_device(d) for d in np.asarray(devices, dtype=object).reshape(-1))
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices=devs, axis_names=(axis,))


def _check_axis(mesh: Mesh, axis: str) -> None:
    if axis not in mesh.axis_names:
        raise ValueError(f"the mesh has axes {mesh.axis_names}, not {axis!r}")


def _shard_size(W: int, mesh: Mesh) -> int:
    if W % len(mesh):
        raise ValueError(f"{W} worlds do not split into the mesh's {len(mesh)} shards")
    return W // len(mesh)


def _to(x, lo: int, hi: int, dtype, device) -> torch.Tensor:
    """Worlds lo:hi of x (a tensor or an array) on `device`, queued without
    a stream synchronisation."""
    t = x[lo:hi] if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x)[lo:hi])
    return t.to(device=device, dtype=dtype, non_blocking=True)


def make_sharded_planner(robot: RobotModel, cfg: ArmourConfig, mesh: Mesh,
                         axis: str = "worlds"):
    """Planner over [W, ...] world-sharded inputs.

    Returns step(q0, qd0, qdd0, q_des, obs) -> SolveResult with every field
    gathered on the mesh's first device, in world order.  W must be
    divisible by the mesh size."""
    _check_axis(mesh, axis)
    steps = {}
    for d in mesh.devices:
        if d not in steps:
            steps[d] = make_batch_planner(robot, cfg, device=d)

    def step(q0, qd0, qdd0, q_des, obs: ObstacleSet) -> SolveResult:
        m = _shard_size(q0.shape[0], mesh)
        shards = []
        for i, d in enumerate(mesh.devices):
            lo, hi = i * m, (i + 1) * m
            shards.append((*(_to(x, lo, hi, cfg.dtype, d) for x in (q0, qd0, qdd0, q_des)),
                           ObstacleSet(centers=_to(obs.centers, lo, hi, cfg.dtype, d),
                                       generators=_to(obs.generators, lo, hi, cfg.dtype, d),
                                       mask=_to(obs.mask, lo, hi, torch.bool, d))))
        results = [steps[d](*a) for d, a in zip(mesh.devices, shards)]
        first = mesh.devices[0]
        return SolveResult(**{
            f.name: torch.cat([getattr(r, f.name).to(first, non_blocking=True)
                               for r in results])
            for f in dataclasses.fields(SolveResult)})

    return step


def make_sharded_summary(mesh: Mesh, axis: str = "worlds"):
    """Fleet summary of a sharded SolveResult: summary(feasible, cost) ->
    {"n_feasible", "n_total", "mean_feasible_cost"}.  Each shard's sums are
    added in float64, then the shards'; where torch.distributed is
    initialised, the three sums of this process' worlds go through one
    all_reduce of a float64 CPU tensor (gloo) to the global ones."""
    _check_axis(mesh, axis)

    def summary(feasible, cost) -> dict:
        m = _shard_size(feasible.shape[0], mesh)
        feas = feasible.to(torch.bool)
        cost_f = torch.where(feas, cost, torch.zeros_like(cost)).to(torch.float64)
        local = torch.stack([feas.reshape(-1, m).sum(1).sum().to(torch.float64),
                             torch.tensor(float(feas.shape[0]), dtype=torch.float64,
                                          device=feas.device),
                             cost_f.reshape(-1, m).sum(1).sum()]).cpu()
        if dist.is_available() and dist.is_initialized():
            dist.all_reduce(local)
        n_feas, n_total, cost_sum = local.tolist()
        return {"n_feasible": int(n_feas), "n_total": int(n_total),
                "mean_feasible_cost": cost_sum / max(n_feas, 1.0)}

    return summary

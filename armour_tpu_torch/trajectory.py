"""Reference-trajectory evaluation with the braking fallback (counterpart of
armour_tpu/trajectory.py).

Given the plan anchor state (q0, qd0, qdd0) and the chosen trajectory
parameter k (NaN if the last plan was infeasible), the desired state at time
t since the plan anchor is

  * the degree-5 Bezier toward q0 + k * k_range if k is finite (the
    constant-acceleration trajectory at k * g_k for cfg.traj_family "armtd");
  * else the PREVIOUS plan's trajectory shifted forward by t_plan (its second
    half ends at rest: the braking manoeuvre the reachable sets certified);
  * if already stopped, hold position.

PlanRef fields are tensors [..., F] with any leading (worlds) dims.
"""

from __future__ import annotations

import dataclasses

import torch

from . import bezier
from .armtd import g_k_adaptive
from .config import ArmourConfig
from .utils import div


@dataclasses.dataclass
class PlanRef:
    """Anchor state + parameter of the active plan and its predecessor."""

    q0: torch.Tensor        # [..., F] anchor position of the active plan
    qd0: torch.Tensor
    qdd0: torch.Tensor
    k_act: torch.Tensor     # [..., F] scaled trajectory parameter; NaN = brake
    prev_q0: torch.Tensor   # previous plan's anchor (for the braking replay)
    prev_qd0: torch.Tensor
    prev_qdd0: torch.Tensor
    prev_k_act: torch.Tensor


def initial_plan(q0, dtype=torch.float32, *, device="cpu") -> PlanRef:
    q0 = torch.as_tensor(q0, dtype=dtype).to(device)
    z = torch.zeros_like(q0)
    return PlanRef(q0=q0, qd0=z, qdd0=z, k_act=z,
                   prev_q0=q0, prev_qd0=z, prev_qdd0=z, prev_k_act=z)


def advance_plan(ref: PlanRef, k_new, q0, qd0, qdd0, cfg: ArmourConfig) -> PlanRef:
    """Accept a new plan anchored at (q0, qd0, qdd0) with parameter k_new in
    [-1, 1]^F (NaN if infeasible -> braking)."""
    like = ref.q0

    def t(x):
        return torch.as_tensor(x, dtype=like.dtype).to(like.device)

    if cfg.traj_family == "armtd":
        # the velocity-adaptive range of build_jrs_armtd at the same anchor
        scale = g_k_adaptive(t(qd0))
    else:
        scale = t(cfg.k_range)
    return PlanRef(q0=t(q0), qd0=t(qd0), qdd0=t(qdd0), k_act=t(k_new) * scale,
                   prev_q0=ref.q0, prev_qd0=ref.qd0, prev_qdd0=ref.qdd0,
                   prev_k_act=ref.k_act)


def _bezier_state(q0, qd0, qdd0, k_act, t, cfg: ArmourConfig):
    dur = cfg.duration
    s = torch.clamp(div(t, dur), 0.0, 1.0)
    Tqd0 = qd0 * dur
    TTqdd0 = qdd0 * dur * dur
    q = bezier.q_des(q0, Tqd0, TTqdd0, k_act, s)
    qd = div(bezier.qd_des(q0, Tqd0, TTqdd0, k_act, s), dur)
    qdd = div(bezier.qdd_des(q0, Tqd0, TTqdd0, k_act, s), dur * dur)
    return q, qd, qdd


def _armtd_state(q0, qd0, qdd0, k_act, t, cfg: ArmourConfig):
    """Constant-acceleration reference: accelerate at k for t <= t_plan,
    then brake linearly to rest at duration; past it the state holds at rest.
    qdd0 is unused (the family's acceleration is k)."""
    del qdd0
    tp, ts = cfg.t_plan, cfg.duration
    t = torch.clamp(t, 0.0, ts)
    qd_pk = qd0 + k_act * tp
    brk = div(-qd_pk, ts - tp)
    q1 = q0 + qd0 * t + 0.5 * k_act * t * t
    qd1 = qd0 + k_act * t
    tau = t - tp
    q_pk = q0 + qd0 * tp + 0.5 * k_act * tp * tp
    q2 = q_pk + qd_pk * tau + 0.5 * brk * tau * tau
    qd2 = qd_pk + brk * tau
    ph2 = t > tp
    return (torch.where(ph2, q2, q1), torch.where(ph2, qd2, qd1),
            torch.where(ph2, brk, k_act))


def desired_state(ref: PlanRef, t, cfg: ArmourConfig):
    """(q_des, qd_des, qdd_des) at time t since the active plan's anchor.

    t is a number or a 0-d tensor ([..., F] out), or a 1-d tensor of n times
    ([..., n, F] out: a whole move's reference in one call)."""
    state = _armtd_state if cfg.traj_family == "armtd" else _bezier_state
    like = ref.q0
    t = torch.as_tensor(t, dtype=like.dtype).to(like.device)
    fields = dataclasses.astuple(ref)
    if t.dim() == 1:
        t = t[:, None]
        fields = tuple(x.unsqueeze(-2) for x in fields)
    q0, qd0, qdd0, k_act, prev_q0, prev_qd0, prev_qdd0, prev_k_act = fields

    ok = torch.isfinite(k_act).all(-1, keepdim=True)
    k = torch.where(ok, k_act, torch.zeros_like(k_act))
    q_n, qd_n, qdd_n = state(q0, qd0, qdd0, k, t, cfg)

    # braking: replay the previous plan shifted by t_plan
    prev_ok = torch.isfinite(prev_k_act).all(-1, keepdim=True)
    pk = torch.where(prev_ok, prev_k_act, torch.zeros_like(prev_k_act))
    q_b, qd_b, qdd_b = state(prev_q0, prev_qd0, prev_qdd0, pk, t + cfg.t_plan, cfg)
    moving = torch.linalg.vector_norm(qd0, dim=-1, keepdim=True) > 1e-8
    brake_active = moving & (t <= cfg.t_plan) & prev_ok
    z = torch.zeros_like(q_n)
    q_f = torch.where(brake_active, q_b, q0.expand_as(q_n))
    qd_f = torch.where(brake_active, qd_b, z)
    qdd_f = torch.where(brake_active, qdd_b, z)

    return (torch.where(ok, q_n, q_f), torch.where(ok, qd_n, qd_f),
            torch.where(ok, qdd_n, qdd_f))

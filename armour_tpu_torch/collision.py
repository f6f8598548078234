"""Obstacle buffering, zonotope -> H-polytope hyperplanes, collision
constraints (counterpart of armour_tpu/collision.py).

For every (time, link, obstacle) cell the obstacle box is buffered with the
link's 6 k-independent generators, the buffered zonotope's H-representation
comes from the 36 cross products of generator pairs, and the constraint is
the signed distance of the k-sliced link centre outside that polytope:

    g = -max_c ( +-(A_c . p(k) - d_c) - delta_c )  <= 0   (safe)

Every tensor carries the world axis W in front and, where the solver
evaluates several k at once (seeds, line-search alphas), a query axis Q after
it.  Three functions have hand-written CUDA kernels:

  build_hyperplanes    kernel K3 (kernels/collision.py), plain version
                       build_hyperplanes_plain;
  screen_collision     kernel K13: the rows' upper bound, the top K in
                       jax.lax.top_k's order and the chosen rows, each
                       formed again with K3's device code; plain version
                       screen_collision_plain;
  screened_rows,       kernel K4: per-row max over the 2C signed distances,
  collision_constraints  first argmax, and dg/dk (the screened rows also in
                       the smooth mode, a log-sum-exp over them); plain
                       versions screened_rows_plain /
                       collision_constraints_plain.

Each wrapper takes the plain version for CPU tensors and launches the kernel
for CUDA tensors.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from .kinematics import LinkFRS
from .utils import div

BIG = 1e8
# 9 buffered generators -> C(9,2) = 36 combinations
N_BUF_GEN = 9
_COMBS = np.array(list(itertools.combinations(range(N_BUF_GEN), 2)), dtype=np.int64)
N_COMB = len(_COMBS)


@dataclasses.dataclass
class ObstacleSet:
    """Padded box-obstacle zonotopes.  centers [(W,) O, 3], generators
    [(W,) O, 3, 3] (columns = generators), mask [(W,) O] (True = real)."""

    centers: torch.Tensor
    generators: torch.Tensor
    mask: torch.Tensor


def pad_obstacles(centers, generators, max_obstacles: int, dtype=torch.float32,
                  *, device="cpu") -> ObstacleSet:
    """One world's obstacles padded to max_obstacles: [O, ...]."""
    centers = np.asarray(centers, dtype=np.float64).reshape(-1, 3)
    generators = np.asarray(generators, dtype=np.float64).reshape(-1, 3, 3)
    n = centers.shape[0]
    if n > max_obstacles:
        raise ValueError(f"{n} obstacles exceed max_obstacles={max_obstacles}")
    c = np.zeros((max_obstacles, 3))
    g = np.zeros((max_obstacles, 3, 3))
    m = np.zeros(max_obstacles, dtype=bool)
    c[:n] = centers
    g[:n] = generators
    m[:n] = True
    return ObstacleSet(centers=torch.as_tensor(c, dtype=dtype).to(device),
                       generators=torch.as_tensor(g, dtype=dtype).to(device),
                       mask=torch.as_tensor(m).to(device))


def stack_obstacles(sets) -> ObstacleSet:
    """Stack per-world obstacle sets into a batch [W, O, ...]."""
    return ObstacleSet(centers=torch.stack([s.centers for s in sets]),
                       generators=torch.stack([s.generators for s in sets]),
                       mask=torch.stack([s.mask for s in sets]))


@dataclasses.dataclass
class Hyperplanes:
    """Polytope data; N = T*J*O flattened (obstacle fastest), C = 36."""

    A: torch.Tensor      # [W, 3, C, N] unit normals (0 for degenerate pairs)
    d: torch.Tensor      # [W, C, N]
    delta: torch.Tensor  # [W, C, N]
    dims: tuple          # (T, J, O)


def _dot3(a, b, dim):
    """Unrolled 3-coordinate dot product over axis `dim` of size 3."""
    return (a.select(dim, 0) * b.select(dim, 0) + a.select(dim, 1) * b.select(dim, 1)
            + a.select(dim, 2) * b.select(dim, 2))


def _buffered_generators(frs: LinkFRS, obs: ObstacleSet) -> torch.Tensor:
    """Per cell the 9 generators (obstacle 3 | link shape 3 | diag(radius)
    3) as [W, 3, 9, N]."""
    Wn, T, J = frs.radius.shape[:3]
    O = obs.centers.shape[-2]
    N = T * J * O
    eye = torch.eye(3, dtype=frs.radius.dtype, device=frs.radius.device)
    obs_g = obs.generators[:, None, None].expand(Wn, T, J, O, 3, 3)
    shape_g = frs.shape_gens[:, :, :, None].expand(Wn, T, J, O, 3, 3)
    rad_g = (frs.radius[:, :, :, None, :, None] * eye).expand(Wn, T, J, O, 3, 3)
    G = torch.cat([obs_g, shape_g, rad_g], dim=-1)          # [W, T, J, O, 3, 9]
    return G.reshape(Wn, N, 3, N_BUF_GEN).permute(0, 2, 3, 1)


def _cell_centers(obs: ObstacleSet, T: int, J: int) -> torch.Tensor:
    """Obstacle centre of every cell: [W, 3, N]."""
    Wn, O = obs.centers.shape[:2]
    return (obs.centers.transpose(1, 2)[:, :, None, None, :]
            .expand(Wn, 3, T, J, O).reshape(Wn, 3, T * J * O))


def build_hyperplanes_plain(frs: LinkFRS, obs: ObstacleSet) -> Hyperplanes:
    """Plain version of kernel K3 (armour_tpu/collision.py:99-130)."""
    T, J = frs.radius.shape[1:3]
    O = obs.centers.shape[-2]
    G = _buffered_generators(frs, obs)                      # [W, 3, 9, N]
    combs = torch.as_tensor(_COMBS).to(G.device)
    ga = G[:, :, combs[:, 0], :]                            # [W, 3, C, N]
    gb = G[:, :, combs[:, 1], :]
    cr = torch.stack([
        ga[:, 1] * gb[:, 2] - ga[:, 2] * gb[:, 1],
        ga[:, 2] * gb[:, 0] - ga[:, 0] * gb[:, 2],
        ga[:, 0] * gb[:, 1] - ga[:, 1] * gb[:, 0],
    ], dim=1)                                               # [W, 3, C, N]
    n2 = _dot3(cr, cr, 1)
    pos = n2 > 0
    inv = torch.where(pos, torch.rsqrt(torch.where(pos, n2, torch.ones_like(n2))),
                      torch.zeros_like(n2))
    A = cr * inv[:, None]
    # delta[c, n] = sum_g |sum_a A[a,c,n] G[a,g,n]|
    AG = (A[:, 0, :, None] * G[:, 0, None] + A[:, 1, :, None] * G[:, 1, None]
          + A[:, 2, :, None] * G[:, 2, None])               # [W, C, 9, N]
    delta = torch.sum(torch.abs(AG), dim=2)
    d = _dot3(A, _cell_centers(obs, T, J)[:, :, None, :], 1)
    return Hyperplanes(A=A, d=d, delta=delta, dims=(T, J, O))


def build_hyperplanes(frs: LinkFRS, obs: ObstacleSet) -> Hyperplanes:
    """Buffer + polytope construction, once per plan.  Kernel K3 on CUDA
    tensors, build_hyperplanes_plain on CPU tensors."""
    if not frs.radius.is_cuda:
        return build_hyperplanes_plain(frs, obs)
    from .kernels import collision as kcol

    T, J = frs.radius.shape[1:3]
    A, d, delta = kcol.build_hyperplanes(frs.shape_gens, frs.radius, obs.centers,
                                         obs.generators)
    return Hyperplanes(A=A, d=d, delta=delta, dims=(T, J, obs.centers.shape[-2]))


def eval_link_polys(frs: LinkFRS, phi: torch.Tensor) -> torch.Tensor:
    """Sliced link centres of every (time, link) cell: phi [W, Q, B] ->
    p_all [W, Q, 3, T*J] (an fp32 product, TF32 off)."""
    Wn, T, J = frs.center_coef.shape[:3]
    B = frs.center_coef.shape[-1]
    Q = phi.shape[1]
    cc = frs.center_coef.reshape(Wn, T * J * 3, B)
    p = torch.matmul(phi.to(cc.dtype), cc.transpose(1, 2))  # [W, Q, TJ*3]
    return p.reshape(Wn, Q, T * J, 3).transpose(-1, -2).contiguous()


def eval_link_poly_grads(frs: LinkFRS, dphi: torch.Tensor) -> torch.Tensor:
    """d(link centres)/dk: dphi [W, Q, B, F] -> [W, Q, 3, F, T*J]."""
    Wn, T, J = frs.center_coef.shape[:3]
    B = frs.center_coef.shape[-1]
    Q, F = dphi.shape[1], dphi.shape[-1]
    cc = frs.center_coef.reshape(Wn, 1, T * J * 3, B)
    dp = torch.matmul(cc, dphi)                             # [W, Q, TJ*3, F]
    return dp.reshape(Wn, Q, T * J, 3, F).permute(0, 1, 3, 4, 2).contiguous()


def _cell_mask(obs: ObstacleSet, T: int, J: int) -> torch.Tensor:
    """Real-obstacle mask of every cell: [W, N]."""
    Wn, O = obs.mask.shape
    return obs.mask[:, None, None, :].expand(Wn, T, J, O).reshape(Wn, T * J * O)


def collision_constraints_plain(hyp: Hyperplanes, obs: ObstacleSet,
                                p_all: torch.Tensor) -> torch.Tensor:
    """Plain version of the full-set check (armour_tpu/collision.py:152-169):
    g [W, Q, T, J, O] (<= 0 safe) from p_all [W, Q, 3, T*J]."""
    T, J, O = hyp.dims
    Wn, Q = p_all.shape[:2]
    N = T * J * O
    A = hyp.A[:, None]                                      # [W, 1, 3, C, N]
    pb = (p_all.reshape(Wn, Q, 3, T, J, 1).expand(Wn, Q, 3, T, J, O)
          .reshape(Wn, Q, 3, 1, N))
    Ap = _dot3(A, pb, 2)                                    # [W, Q, C, N]
    ok = torch.abs(A[:, :, 0]) + torch.abs(A[:, :, 1]) + torch.abs(A[:, :, 2]) > 0
    big = torch.full_like(Ap, -BIG)
    d, delta = hyp.d[:, None], hyp.delta[:, None]
    pos = torch.where(ok, Ap - (d + delta), big)
    neg = torch.where(ok, -Ap - (-d + delta), big)
    m = torch.maximum(torch.amax(pos, dim=-2), torch.amax(neg, dim=-2))   # [W, Q, N]
    mask = _cell_mask(obs, T, J)[:, None]
    g = torch.where(mask, -m, torch.full_like(m, -BIG))
    return g.reshape(Wn, Q, T, J, O)


def collision_constraints(hyp: Hyperplanes, obs: ObstacleSet,
                          p_all: torch.Tensor) -> torch.Tensor:
    """Full-set constraint values g [W, Q, T, J, O] (used by the final
    feasibility check).  On CUDA this is kernel K4 over all N rows with
    row = n // O and mask = obs.mask[n % O]."""
    if not p_all.is_cuda:
        return collision_constraints_plain(hyp, obs, p_all)
    from .kernels import collision as kcol

    T, J, O = hyp.dims
    Wn, Q = p_all.shape[:2]
    N = T * J * O
    n = torch.arange(N, device=p_all.device)
    row = (n // O).to(torch.int32)
    mask = _cell_mask(obs, T, J).contiguous()
    g, _ = kcol.collision_rows(hyp.A, hyp.d, hyp.delta, row, mask, p_all, None)
    return g.reshape(Wn, Q, T, J, O)


@dataclasses.dataclass
class ScreenedCollision:
    """Top-K candidate collision rows for the solver loop.  Soundness does
    not rest on K: the final feasibility check evaluates every row."""

    A: torch.Tensor        # [W, 3, C, K]
    d: torch.Tensor        # [W, C, K]
    delta: torch.Tensor    # [W, C, K]
    row: torch.Tensor      # [W, K] int32 index into the T*J link cells
    mask: torch.Tensor     # [W, K] real-obstacle mask


def _screen_bound(hyp: Hyperplanes, obs: ObstacleSet, frs: LinkFRS):
    """Upper bound of g over the k-box for every row: (g_up [W, N], the
    real-obstacle mask [W, N])."""
    T, J, O = hyp.dims
    Wn = hyp.A.shape[0]
    N = T * J * O
    A = hyp.A

    def per_cell(x):          # [W, T, J, 3] -> [W, 3, 1, N]
        return (x.permute(0, 3, 1, 2)[..., None].expand(Wn, 3, T, J, O)
                .reshape(Wn, 3, 1, N))

    Apc = _dot3(A, per_cell(frs.center_coef[..., 0]), 1)   # [W, C, N]
    # coordinate-box bound of sup_k |A . (p(k) - p0)|: a valid over-bound
    env = per_cell(screen_envelope(frs.center_coef))
    r = (torch.abs(A[:, 0]) * env[:, 0] + torch.abs(A[:, 1]) * env[:, 1]
         + torch.abs(A[:, 2]) * env[:, 2])
    ok = torch.abs(A[:, 0]) + torch.abs(A[:, 1]) + torch.abs(A[:, 2]) > 0
    big = torch.full_like(Apc, -BIG)
    pos_lb = torch.where(ok, Apc - r - (hyp.d + hyp.delta), big)
    neg_lb = torch.where(ok, -Apc - r - (-hyp.d + hyp.delta), big)
    m_lb = torch.maximum(torch.amax(pos_lb, dim=1), torch.amax(neg_lb, dim=1))   # [W, N]
    mask = _cell_mask(obs, T, J)
    return torch.where(mask, -m_lb, torch.full_like(m_lb, -BIG)), mask


def screen_envelope(center_coef: torch.Tensor) -> torch.Tensor:
    """Per-cell monomial envelope sum_b>0 |coef_b| of the link centres
    [W, T, J, 3, B] -> [W, T, J, 3] (the same torch reduction on every
    route, so the screen's bound rests on the same bits)."""
    return torch.sum(torch.abs(center_coef[..., 1:]), dim=-1)


def _top_sorted(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, by value
    descending and the lower index first among equal values (the order of
    jax.lax.top_k; torch.topk leaves ties in no defined order).  -0.0 is
    taken as +0.0."""
    return torch.sort(x + 0.0, dim=-1, descending=True, stable=True).indices[..., :k]


def screen_rows(g_up: torch.Tensor, O: int, K: int, obstacle_quota: int = 0) -> torch.Tensor:
    """The screen's selection: indices [W, min(K, N)] of the worst rows of
    g_up [W, N] (N = T*J*O, obstacle fastest) in _top_sorted's order;
    obstacle_quota > 0 first takes that many best rows of every obstacle,
    obstacle-major, then fills the rest globally from the other rows."""
    Wn, N = g_up.shape
    Kk = min(K, N)
    if obstacle_quota > 0 and obstacle_quota * O < Kk:
        q = obstacle_quota
        gu_o = g_up.reshape(Wn, N // O, O).transpose(1, 2)  # [W, O, T*J]
        idx_o = _top_sorted(gu_o, q)                        # [W, O, q]
        obs_idx = torch.arange(O, device=g_up.device)[:, None]
        quota_idx = (idx_o * O + obs_idx).reshape(Wn, O * q)
        g_fill = g_up.scatter(-1, quota_idx, float("-inf"))
        return torch.cat([quota_idx, _top_sorted(g_fill, Kk - q * O)], dim=-1)
    return _top_sorted(g_up, Kk)                            # [W, K]


def screen_collision_plain(hyp: Hyperplanes, obs: ObstacleSet, frs: LinkFRS,
                           K: int, obstacle_quota: int = 0) -> ScreenedCollision:
    """Plain version of kernel K13 (armour_tpu/collision.py:193-252): rank
    all rows by an upper bound of g over the k-box and keep the K worst,
    in jax.lax.top_k's order.  obstacle_quota > 0 first reserves that many
    best rows for every obstacle."""
    O = hyp.dims[2]
    g_up, mask = _screen_bound(hyp, obs, frs)
    idx = screen_rows(g_up, O, K, obstacle_quota)
    Wn, _, C = hyp.A.shape[:3]
    Kk = idx.shape[-1]
    return ScreenedCollision(
        A=torch.gather(hyp.A, -1, idx[:, None, None, :].expand(Wn, 3, C, Kk)),
        d=torch.gather(hyp.d, -1, idx[:, None, :].expand(Wn, C, Kk)),
        delta=torch.gather(hyp.delta, -1, idx[:, None, :].expand(Wn, C, Kk)),
        row=(idx // O).to(torch.int32),
        mask=torch.gather(mask, -1, idx),
    )


def screen_collision(hyp: Hyperplanes, obs: ObstacleSet, frs: LinkFRS,
                     K: int, obstacle_quota: int = 0) -> ScreenedCollision:
    """The K worst rows for the solver loop (see screen_collision_plain):
    kernel K13 on CUDA tensors, screen_collision_plain on CPU tensors.  K13
    forms each row's hyperplanes again from frs and obs with K3's device
    code, so on the card it reads nothing of hyp and gives the rows
    screen_collision_plain takes from K3's hyp, bit for bit."""
    if not hyp.A.is_cuda:
        return screen_collision_plain(hyp, obs, frs, K, obstacle_quota)
    from .kernels import collision as kcol

    A, d, delta, row, mask = kcol.screen_collision(
        frs.shape_gens, frs.radius, obs.centers, obs.generators, frs.center_coef,
        screen_envelope(frs.center_coef), obs.mask, K, obstacle_quota)
    return ScreenedCollision(A=A, d=d, delta=delta, row=row, mask=mask)


def _rows_at(x: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """Gather the last (T*J cell) axis of x [W, Q, ..., TJ] at row [W, K]."""
    idx = row.to(torch.int64).reshape(row.shape[0], *([1] * (x.dim() - 2)), row.shape[1])
    return torch.gather(x, -1, idx.expand(*x.shape[:-1], row.shape[1]))


def smooth_shift(tau: float, C: int, dtype) -> torch.Tensor:
    """tau log(2C) as a 0-d CPU tensor of dtype, rounded as the JAX
    expression tau * jnp.log(2.0 * C) rounds it in that dtype (the log in
    dtype, then the product); kernels K4 / K7 / K8 take its value, and the
    plain version subtracts it as a CPU scalar on any device."""
    return tau * torch.log(torch.tensor(2.0 * C, dtype=dtype))


def screened_constraints(sc: ScreenedCollision, p_all: torch.Tensor, smooth_tau: float = 0.0):
    """g [W, Q, K] (<= 0 safe) and dg/dp [W, Q, 3, K] of the screened rows
    (armour_tpu/collision.py:255-302).

    smooth_tau > 0 is the smooth mode: the max over the 2C signed distances
    x becomes m = mx + tau log sum exp((x - mx) / tau) - tau log(2C) >=
    max(x) - tau log(2C), so g = -m lies at most tau log(2C) above the hard
    g and never below it, and dg/dp is minus the softmax blend of the signed
    normals."""
    p = _rows_at(p_all, sc.row)                             # [W, Q, 3, K]
    A = sc.A[:, None]                                       # [W, 1, 3, C, K]
    Ap = _dot3(A, p[:, :, :, None, :], 2)                   # [W, Q, C, K]
    ok = torch.abs(A[:, :, 0]) + torch.abs(A[:, :, 1]) + torch.abs(A[:, :, 2]) > 0
    big = torch.full_like(Ap, -BIG)
    d, delta = sc.d[:, None], sc.delta[:, None]
    pos = torch.where(ok, Ap - (d + delta), big)
    neg = torch.where(ok, -Ap - (-d + delta), big)
    both = torch.cat([pos, neg], dim=-2)                    # [W, Q, 2C, K]
    C = sc.A.shape[2]
    mask = sc.mask[:, None]

    if smooth_tau > 0:
        tau = smooth_tau
        mx = torch.amax(both, dim=-2)
        w = torch.exp(div(both - mx[:, :, None], tau))      # softmax weights
        Z = torch.sum(w, dim=-2)
        m = mx + tau * torch.log(Z) - smooth_shift(tau, C, both.dtype)
        g = torch.where(mask, -m, torch.full_like(m, -BIG))
        wn = w / Z[:, :, None]                              # [W, Q, 2C, K]
        w_pos, w_neg = wn[:, :, None, :C], wn[:, :, None, C:]
        A_blend = (A * w_pos).sum(dim=3) - (A * w_neg).sum(dim=3)   # [W, Q, 3, K]
        grad_p = torch.where(mask[:, :, None], -A_blend, torch.zeros_like(A_blend))
        return g, grad_p

    m = torch.amax(both, dim=-2)
    g = torch.where(mask, -m, torch.full_like(m, -BIG))
    idx = torch.argmax(both, dim=-2)                        # first maximal index
    sign = torch.where(idx < C, -1.0, 1.0).to(p.dtype)
    comb = torch.where(idx < C, idx, idx - C)
    A_sel = torch.gather(A.expand(-1, comb.shape[1], -1, -1, -1), 3,
                         comb[:, :, None, None, :].expand(-1, -1, 3, 1, -1))[:, :, :, 0]
    grad_p = torch.where(mask[:, :, None], sign[:, :, None] * A_sel,
                         torch.zeros_like(A_sel))
    return g, grad_p


def screened_constraint_grads(sc: ScreenedCollision, grad_p: torch.Tensor,
                              dp_all: torch.Tensor) -> torch.Tensor:
    """dg/dk [W, Q, K, F]: grad_p [W, Q, 3, K] chained with dp/dk
    [W, Q, 3, F, T*J]."""
    dp = _rows_at(dp_all, sc.row)                           # [W, Q, 3, F, K]
    dg = (grad_p[:, :, 0, None] * dp[:, :, 0] + grad_p[:, :, 1, None] * dp[:, :, 1]
          + grad_p[:, :, 2, None] * dp[:, :, 2])            # [W, Q, F, K]
    return dg.transpose(-1, -2)


def screened_rows_plain(sc: ScreenedCollision, p_all: torch.Tensor,
                        dp_all: torch.Tensor | None = None, *, smooth_tau: float = 0.0):
    """Plain version of kernel K4 on the screened rows: (g [W, Q, K],
    dg/dk [W, Q, K, F] or None), the smooth mode when smooth_tau > 0."""
    g, grad_p = screened_constraints(sc, p_all, smooth_tau)
    if dp_all is None:
        return g, None
    return g, screened_constraint_grads(sc, grad_p, dp_all)


def screened_rows(sc: ScreenedCollision, p_all: torch.Tensor,
                  dp_all: torch.Tensor | None = None, *, smooth_tau: float = 0.0):
    """Screened collision rows and, when dp_all is given, their k-gradients,
    in the smooth mode when smooth_tau > 0.  Kernel K4 on CUDA tensors,
    screened_rows_plain on CPU tensors."""
    if not p_all.is_cuda:
        return screened_rows_plain(sc, p_all, dp_all, smooth_tau=smooth_tau)
    from .kernels import collision as kcol

    return kcol.collision_rows(sc.A, sc.d, sc.delta, sc.row, sc.mask, p_all, dp_all,
                               smooth_tau=smooth_tau)

"""High-level planners (waypoint generators) for the receding-horizon loop
(copy of armour_tpu/hlp.py:41-605; numpy only, bit-identical waypoints for
the same seed).

HLPs are cheap geometric guidance on the host, called once per 0.5 s re-plan:

  * StraightLineHLP       -- step toward the goal along the wrapped
    configuration-space difference.
  * EndEffectorRRTStarHLP -- RRT* on end-effector positions in the 3-D
    workspace with edge checks against buffered obstacle boxes; walk the
    best path a lookahead distance and convert the 3-D waypoint to a
    configuration by damped least-squares IK.
  * ConfigRRTStarHLP      -- RRT* directly in the configuration space; nodes
    and edges are checked by sweeping the whole arm (link segments,
    capsule-buffered) against the obstacle boxes.

LazyPRMHLP of the JAX package is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .robot import RobotModel
from .worlds import World, straight_line_waypoint


class StraightLineHLP:
    def __init__(self, world: World, robot: RobotModel, lookahead: float = 0.4):
        self.world = world
        self.lookahead = lookahead
        self._cont = robot.continuous_joints

    def get_waypoint(self, q: np.ndarray) -> np.ndarray:
        return straight_line_waypoint(q, self.world.goal, self.lookahead,
                                      continuous=self._cont)


# ---------------------------------------------------------------------------
# forward kinematics helpers (numpy; mirrors rnea_numeric.forward_kinematics)
# ---------------------------------------------------------------------------


def _fk_frames(robot: RobotModel, q: np.ndarray):
    """World rotation and position of every joint frame plus the tool point."""
    fk_r = np.eye(3)
    fk_t = np.zeros(3)
    ps = []
    for i in range(robot.num_joints):
        fk_t = fk_t + fk_r @ robot.trans[i]
        R = np.eye(3)
        axis = int(robot.axes[i])
        if axis != 0 and i < robot.num_factors:
            th = q[i] * (1.0 if axis > 0 else -1.0)
            c, s = np.cos(th), np.sin(th)
            a = abs(axis) - 1
            if a == 0:
                R = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
            elif a == 1:
                R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            else:
                R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        fk_r = fk_r @ robot.rot_mats[i] @ R
        ps.append(fk_t.copy())
    ee = fk_t + fk_r @ robot.trans[robot.num_joints]
    ps.append(ee)
    return np.asarray(ps)


def ee_position(robot: RobotModel, q: np.ndarray) -> np.ndarray:
    """End-effector (tool frame origin) world position."""
    return _fk_frames(robot, q)[-1]


def _fk_points_batch(robot: RobotModel, Q: np.ndarray) -> np.ndarray:
    """Joint-frame origins + tool point for a batch of configs:
    [B, F] -> [B, J+1, 3] (vectorised _fk_frames; the config-RRT* collision
    model calls this thousands of times per grow)."""
    Q = np.atleast_2d(np.asarray(Q, float))
    B = Q.shape[0]
    fk_r = np.broadcast_to(np.eye(3), (B, 3, 3)).copy()
    fk_t = np.zeros((B, 3))
    ps = np.zeros((B, robot.num_joints + 1, 3))
    for i in range(robot.num_joints):
        fk_t = fk_t + np.einsum("bxy,y->bx", fk_r, robot.trans[i])
        axis = int(robot.axes[i])
        if axis != 0 and i < robot.num_factors:
            th = Q[:, i] * (1.0 if axis > 0 else -1.0)
            c, s = np.cos(th), np.sin(th)
            o, z = np.ones(B), np.zeros(B)
            a = abs(axis) - 1
            if a == 0:
                R = np.stack([o, z, z, z, c, -s, z, s, c], axis=-1)
            elif a == 1:
                R = np.stack([c, z, s, z, o, z, -s, z, c], axis=-1)
            else:
                R = np.stack([c, -s, z, s, c, z, z, z, o], axis=-1)
            R = R.reshape(B, 3, 3)
            fk_r = np.einsum("bxy,yz,bzw->bxw", fk_r, robot.rot_mats[i], R)
        else:
            fk_r = np.einsum("bxy,yz->bxz", fk_r, robot.rot_mats[i])
        ps[:, i] = fk_t
    ps[:, robot.num_joints] = fk_t + np.einsum(
        "bxy,y->bx", fk_r, robot.trans[robot.num_joints])
    return ps


def ik_damped_ls(robot: RobotModel, target: np.ndarray, q0: np.ndarray,
                 iters: int = 100, tol: float = 1e-4, damping: float = 1e-2,
                 accept_tol: float = 1e-2):
    """Position-only damped least-squares IK (the HLP's counterpart of
    agent_info.inverse_kinematics, robot_arm_agent.m:946-1037 which uses
    lsqnonlin).  Levenberg-style adaptive damping: shrink on progress, grow
    on a rejected step.  Returns (q, converged) — converged means the final
    EE error is under `accept_tol` (waypoints are guidance, not certified
    geometry, so cm-level acceptance is the right bar)."""
    q = np.asarray(q0, float).copy()
    F = robot.num_factors
    lb = np.where(robot.position_limits_lb < -100, -2 * np.pi, robot.position_limits_lb)
    ub = np.where(robot.position_limits_ub > 100, 2 * np.pi, robot.position_limits_ub)
    lam = damping
    p = ee_position(robot, q)
    err = target - p
    en = np.linalg.norm(err)
    for _ in range(iters):
        if en < tol:
            return q, True
        # numeric Jacobian (3 x F); F is tiny so finite differences are cheap
        J = np.zeros((3, F))
        h = 1e-6
        for j in range(F):
            dq = q.copy()
            dq[j] += h
            J[:, j] = (ee_position(robot, dq) - p) / h
        JT = J.T
        step = JT @ np.linalg.solve(J @ JT + lam * np.eye(3), err)
        q_new = np.clip(q + step, lb, ub)
        p_new = ee_position(robot, q_new)
        en_new = np.linalg.norm(target - p_new)
        if en_new < en:
            q, p, err, en = q_new, p_new, target - p_new, en_new
            lam = max(lam * 0.5, 1e-6)
        else:
            lam = min(lam * 4.0, 1e3)
            if lam >= 1e3:
                break
    return q, bool(en < accept_tol)


# ---------------------------------------------------------------------------
# workspace RRT* on end-effector positions
# ---------------------------------------------------------------------------


def _segment_hits_boxes(a: np.ndarray, b: np.ndarray, centers: np.ndarray,
                        half: np.ndarray, step: float = 0.01) -> bool:
    """Discretized segment-vs-AABB check (edge_feasibility_check_
    discretization = 0.01 in the reference)."""
    if centers.size == 0:
        return False
    n = max(2, int(np.ceil(np.linalg.norm(b - a) / step)) + 1)
    ts = np.linspace(0.0, 1.0, n)
    pts = a[None, :] + ts[:, None] * (b - a)[None, :]
    d = np.abs(pts[:, None, :] - centers[None, :, :]) - half[None, :, :]
    return bool(np.any(np.all(d < 0.0, axis=2)))


@dataclasses.dataclass
class _Tree:
    nodes: list
    parents: list
    costs: list


def _walk_path(path: np.ndarray, p_now: np.ndarray, lookahead: float):
    """Project p_now onto the polyline (closest point on SEGMENTS — the
    round-3 walk used closest node, which can sit behind the current
    position and freeze the waypoint at the current state), then walk
    `lookahead` arclength forward.  Returns (z, walked_off)."""
    if len(path) < 2:
        return path[-1], True
    a = path[:-1]
    seg = path[1:] - a                     # [S, D]
    L2 = np.einsum("sd,sd->s", seg, seg)
    t = np.clip(np.einsum("sd,sd->s", p_now[None, :] - a, seg)
                / np.maximum(L2, 1e-18), 0.0, 1.0)
    proj = a + t[:, None] * seg
    d = np.linalg.norm(proj - p_now[None, :], axis=1)
    s = int(np.argmin(d))
    remaining = lookahead
    # finish the projected segment first
    Ls = np.sqrt(L2[s])
    frac_left = (1.0 - t[s]) * Ls
    if frac_left >= remaining and Ls > 1e-12:
        return proj[s] + seg[s] * (remaining / Ls), False
    remaining -= frac_left
    i = s + 1
    z = path[s + 1]
    while i + 1 < len(path) and remaining > 0:
        segi = path[i + 1] - path[i]
        Li = np.linalg.norm(segi)
        if Li >= remaining and Li > 1e-12:
            return path[i] + segi * (remaining / Li), False
        z = path[i + 1]
        remaining -= Li
        i += 1
    return z, remaining > 0


class EndEffectorRRTStarHLP:
    """RRT* in the 3-D workspace on end-effector positions
    (arm_end_effector_RRT_star_HLP.m semantics)."""

    def __init__(self, world: World, robot: RobotModel, lookahead: float = 0.2,
                 buffer: float = 0.05, bounds_radius: float = 1.1,
                 max_nodes: int = 400, steer: float = 0.15,
                 goal_bias: float = 0.2, rewire_radius: float = 0.25,
                 seed: int = 0, grow_mode: str = "keep"):
        """grow_mode: 'keep' grows the tree once from the start and walks the
        stored path on every call; 'new' re-grows from the CURRENT end-
        effector position at every replan (HLP_grow_tree_mode='new' in
        kinova_run_100_worlds.m:54) — costlier but recovers when the arm has
        drifted off the stored path."""
        assert grow_mode in ("keep", "new"), grow_mode
        self.world = world
        self.robot = robot
        self.grow_mode = grow_mode
        self.lookahead = lookahead
        self.rng = np.random.default_rng(seed)
        self.max_nodes = max_nodes
        self.steer = steer
        self.goal_bias = goal_bias
        self.rewire_radius = rewire_radius
        self.bounds_radius = bounds_radius

        self.start_p = ee_position(robot, world.start)
        self.goal_p = ee_position(robot, world.goal)
        self.obs_c = np.asarray(world.obstacle_centers).reshape(-1, 3)
        gens = np.asarray(world.obstacle_generators).reshape(-1, 3, 3)
        self.obs_half = (np.abs(gens).sum(axis=2) + buffer) if len(gens) else gens.reshape(0, 3)
        self._tree: Optional[_Tree] = None
        self._path: Optional[np.ndarray] = None
        self._reaches_goal = False
        self._regrows_left = 2
        # hand over to the goal configuration once the EE is this close to
        # the goal EE position (config-space endgame; see get_waypoint)
        self.goal_handover = max(2.0 * lookahead, 0.15)

    def _grow(self, root: np.ndarray):
        t = _Tree(nodes=[root], parents=[-1], costs=[0.0])
        best_goal, best_cost = None, np.inf
        for _ in range(self.max_nodes):
            if self.rng.uniform() < self.goal_bias:
                sample = self.goal_p
            else:
                sample = self.rng.uniform(-self.bounds_radius, self.bounds_radius, 3)
                sample[2] = self.rng.uniform(0.0, self.bounds_radius)
            nodes = np.asarray(t.nodes)
            d = np.linalg.norm(nodes - sample[None, :], axis=1)
            ni = int(np.argmin(d))
            direction = sample - nodes[ni]
            dist = np.linalg.norm(direction)
            if dist < 1e-9:
                continue
            new = nodes[ni] + direction * min(1.0, self.steer / dist)
            if _segment_hits_boxes(nodes[ni], new, self.obs_c, self.obs_half):
                continue
            # RRT* choose-parent + rewire within radius
            near = np.where(np.linalg.norm(nodes - new[None, :], axis=1) < self.rewire_radius)[0]
            parent, cost = ni, t.costs[ni] + dist * min(1.0, self.steer / dist)
            for j in near:
                cj = t.costs[j] + np.linalg.norm(t.nodes[j] - new)
                if cj < cost and not _segment_hits_boxes(t.nodes[j], new, self.obs_c, self.obs_half):
                    parent, cost = int(j), cj
            t.nodes.append(new)
            t.parents.append(parent)
            t.costs.append(cost)
            new_i = len(t.nodes) - 1
            for j in near:
                cj = cost + np.linalg.norm(t.nodes[j] - new)
                if cj < t.costs[j] and not _segment_hits_boxes(new, t.nodes[j], self.obs_c, self.obs_half):
                    t.parents[j] = new_i
                    t.costs[j] = cj
            gd = np.linalg.norm(new - self.goal_p)
            if gd < self.steer and not _segment_hits_boxes(new, self.goal_p, self.obs_c, self.obs_half):
                if cost + gd < best_cost:
                    best_cost = cost + gd
                    best_goal = new_i
        self._tree = t
        # extract path root -> best node (falls back to closest-to-goal node)
        self._reaches_goal = best_goal is not None
        if best_goal is None:
            nodes = np.asarray(t.nodes)
            best_goal = int(np.argmin(np.linalg.norm(nodes - self.goal_p[None, :], axis=1)))
            path = []
        else:
            path = [self.goal_p]
        i = best_goal
        while i >= 0:
            path.append(t.nodes[i])
            i = t.parents[i]
        self._path = np.asarray(path[::-1])

    def get_waypoint(self, q: np.ndarray) -> np.ndarray:
        """Configuration waypoint: walk the EE path a lookahead distance from
        the current EE position, then IK (reference get_waypoint)."""
        p_now = ee_position(self.robot, q)
        if self._path is None or self.grow_mode == "new":
            self._grow(p_now)
        # the stored path never reached the goal EE: regrow denser (up to 2x
        # twice) from the CURRENT position — a truncated path parks the arm
        # at its dead end otherwise
        while not self._reaches_goal and self._regrows_left > 0:
            self.max_nodes *= 2
            self._regrows_left -= 1
            self._grow(p_now)
        z, walked_off = _walk_path(self._path, p_now, self.lookahead)
        if walked_off or np.linalg.norm(p_now - self.goal_p) < self.goal_handover:
            # at/near the EE goal: IK there has many wrong-branch solutions
            # (the arm can hold the goal EE position in a non-goal
            # configuration forever); hand over to the goal CONFIGURATION so
            # the planner closes the config-space distance the goal check
            # actually measures.
            return np.asarray(self.world.goal, float)
        # the waypoint EE is only ~lookahead from the current EE, so the
        # current configuration is the natural IK seed; fall back to the
        # start/goal midpoint seed, then to the goal configuration
        # (reference exitflag<0 branch)
        q_wp, ok = ik_damped_ls(self.robot, z, np.asarray(q, float))
        if not ok:
            q_seed = 0.5 * (np.asarray(q) + self.world.goal)
            q_wp, ok = ik_damped_ls(self.robot, z, q_seed)
        if not ok:
            return np.asarray(self.world.goal, float)
        return q_wp


# ---------------------------------------------------------------------------
# configuration-space RRT* (robot_arm_RRT_star_HLP.m)
# ---------------------------------------------------------------------------


class ConfigRRTStarHLP:
    """RRT* directly in configuration space.

    Arm collision model: every consecutive pair of joint-frame origins (plus
    the tool point) is a segment swept against obstacle AABBs buffered by
    `buffer` (a capsule over-approximation of the link volume — conservative
    guidance is fine for an HLP; the certified safety comes from the PZ
    planner underneath).  Edges are checked at `edge_step` rad resolution in
    the max-norm (the reference discretizes edges the same way,
    robot_arm_RRT_star_HLP.m edge feasibility).
    """

    def __init__(self, world: World, robot: RobotModel, lookahead: float = 0.4,
                 buffer: float = 0.08, max_nodes: int = 800, steer: float = 0.6,
                 goal_bias: float = 0.15, rewire_radius: float = 1.2,
                 edge_step: float = 0.1, seed: int = 0):
        self.world = world
        self.robot = robot
        self.lookahead = lookahead
        self.max_nodes = max_nodes
        self.steer = steer
        self.goal_bias = goal_bias
        self.rewire_radius = rewire_radius
        self.edge_step = edge_step
        self.rng = np.random.default_rng(seed)
        self.buffer = buffer

        self.obs_c = np.asarray(world.obstacle_centers).reshape(-1, 3)
        gens = np.asarray(world.obstacle_generators).reshape(-1, 3, 3)
        self.obs_half = (np.abs(gens).sum(axis=2) + buffer) if len(gens) \
            else gens.reshape(0, 3)
        self.lb = np.where(robot.position_limits_lb < -100, -np.pi,
                           np.maximum(robot.position_limits_lb, -np.pi))
        self.ub = np.where(robot.position_limits_ub > 100, np.pi,
                           np.minimum(robot.position_limits_ub, np.pi))
        self.goal = np.asarray(world.goal, float)
        self._path: Optional[np.ndarray] = None
        self._reaches_goal = False
        self._root = np.asarray(world.start, float)
        self._relax_halves: Optional[np.ndarray] = None
        self._relax_radius = 1.0

    # -- collision model (batched numpy: thousands of configs per grow) -----

    def _hits(self, Q: np.ndarray, halves: np.ndarray) -> np.ndarray:
        pts = _fk_points_batch(self.robot, Q)          # [B, J+1, 3]
        a, b = pts[:, :-1], pts[:, 1:]                 # [B, S, 3]
        ts = np.linspace(0.0, 1.0, 10)
        samp = a[:, :, None, :] + ts[None, None, :, None] * (b - a)[:, :, None, :]
        # [B, S, n, O, 3]
        d = (np.abs(samp[:, :, :, None, :] - self.obs_c[None, None, None, :, :])
             - halves[None, None, None, :, :])
        return np.any(np.all(d < 0.0, axis=-1), axis=(1, 2, 3))

    def _configs_free(self, Q: np.ndarray) -> np.ndarray:
        """[B, F] -> [B] bool: swept-arm capsule check for a batch of
        configurations (every consecutive joint-origin pair sampled at 10
        points vs the buffered obstacle AABBs).

        Root-pocket relaxation: when the tree root itself violates the
        buffered model (the planner parks arms against walls), configs
        within `_relax_radius` rad of the root are tested with the shrunk
        buffer instead — the tree can ESCAPE the pocket but the rest of the
        roadmap keeps full clearance (a global shrink made every path hug
        the walls and the certified planner could not track them)."""
        Q = np.atleast_2d(Q)
        if self.obs_c.size == 0:
            return np.ones(Q.shape[0], dtype=bool)
        hit = self._hits(Q, self.obs_half)
        if self._relax_halves is not None:
            near = np.linalg.norm(Q - self._root[None, :], axis=1) \
                < self._relax_radius
            if np.any(near & hit):
                hit_rel = self._hits(Q[near & hit], self._relax_halves)
                out = hit.copy()
                out[near & hit] = hit_rel
                hit = out
        return ~hit

    def _config_free(self, q: np.ndarray) -> bool:
        return bool(self._configs_free(np.asarray(q, float)[None])[0])

    def _edge_free(self, qa: np.ndarray, qb: np.ndarray) -> bool:
        n = max(2, int(np.ceil(np.max(np.abs(qb - qa)) / self.edge_step)) + 1)
        ts = np.linspace(0.0, 1.0, n)[:, None]
        Q = qa[None, :] + ts * (qb - qa)[None, :]
        return bool(np.all(self._configs_free(Q)))

    # -- tree growth: bidirectional greedy connect --------------------------
    #
    # The round-3 single-tree RRT* covered 7-DOF config space too slowly to
    # reach goals behind clutter within the node budget (observed: closest
    # node 2.6 rad from the goal after 2000 samples on suite scenes).  The
    # rewrite grows TWO trees (root + goal) with RRT-Connect-style greedy
    # multi-step extension and checks tree-tree connection every iteration;
    # the recovered path is shortcut-smoothed.  Asymptotic optimality is
    # deliberately traded for coverage — this is guidance, not the
    # certificate (the reference ships plain RRT variants alongside RRT*,
    # simulator/planners/high_level_planners/).

    def _extend(self, t: _Tree, target: np.ndarray):
        """Greedy multi-step extension toward target.  Returns (last_index,
        reached) where reached means the tree now contains target."""
        nodes = np.asarray(t.nodes)
        ni = int(np.argmin(np.linalg.norm(nodes - target[None, :], axis=1)))
        q = t.nodes[ni]
        parent = ni
        last = None
        for _ in range(16):
            d = target - q
            dist = np.linalg.norm(d)
            if dist < 1e-9:
                return last, True
            step = q + d * min(1.0, self.steer / dist)
            if not self._edge_free(q, step):
                return last, False
            t.nodes.append(step)
            t.parents.append(parent)
            t.costs.append(t.costs[parent] + min(self.steer, dist))
            parent = len(t.nodes) - 1
            last = parent
            q = step
            if dist <= self.steer:
                return last, True
        return last, False

    def _chain(self, t: _Tree, i: int):
        path = []
        while i >= 0:
            path.append(t.nodes[i])
            i = t.parents[i]
        return path[::-1]

    def _shortcut(self, path):
        """Greedy shortcut smoothing: skip intermediate nodes whose direct
        edge is free."""
        if len(path) <= 2:
            return path
        out = [path[0]]
        i = 0
        while i < len(path) - 1:
            j = len(path) - 1
            while j > i + 1 and not self._edge_free(path[i], path[j]):
                j -= 1
            out.append(path[j])
            i = j
        return out

    def _densify(self, path, step):
        out = [path[0]]
        for a, b in zip(path[:-1], path[1:]):
            n = max(1, int(np.ceil(np.linalg.norm(b - a) / step)))
            for t in np.linspace(0.0, 1.0, n + 1)[1:]:
                out.append(a + t * (b - a))
        return out

    def _smooth(self, path):
        """Greedy + random-pair shortcutting over a densified path: connect
        trees yield feasible-but-wiggly paths; smoothing makes them taut so
        lookahead waypoints track toward the goal instead of along detours."""
        path = self._shortcut(list(path))
        if len(path) <= 2:
            return path
        path = self._densify(path, 0.5 * self.steer)
        for _ in range(120):
            if len(path) <= 2:
                break
            i, j = sorted(int(x) for x in self.rng.integers(0, len(path), 2))
            if j - i >= 2 and self._edge_free(path[i], path[j]):
                path = path[: i + 1] + path[j:]
        return self._shortcut(path)

    def _grow_once(self, root: np.ndarray):
        """One bidirectional connect attempt at the CURRENT buffer settings.
        Returns (path_nodes | None, fallback_tree)."""
        ta = _Tree(nodes=[root], parents=[-1], costs=[0.0])
        tb = _Tree(nodes=[np.asarray(self.goal, float)], parents=[-1],
                   costs=[0.0])
        goal_free = self._config_free(self.goal)
        fwd = True
        for _ in range(self.max_nodes):
            sample = (np.asarray(self.goal, float)
                      if self.rng.uniform() < self.goal_bias
                      else self.rng.uniform(self.lb, self.ub))
            src, dst = (ta, tb) if fwd else (tb, ta)
            last, _ = self._extend(src, sample)
            if last is not None and goal_free:
                # try to connect the OTHER tree to the new node
                bridge, reached = self._extend(dst, np.asarray(src.nodes[last]))
                if reached and bridge is not None:
                    meet = (last, bridge) if fwd else (bridge, last)
                    return (self._chain(ta, meet[0])
                            + self._chain(tb, meet[1])[::-1]), ta
            fwd = not fwd
            if len(ta.nodes) + len(tb.nodes) >= self.max_nodes:
                break
        return None, ta

    def _grow(self, root: np.ndarray):
        root = np.asarray(root, float)
        # The planner parks arms AGAINST obstacle walls (boundary optima), so
        # the root configuration routinely violates the buffered capsule
        # model even though the true arm is safe.  Shrink a LOCAL buffer
        # until the root tests free (certified safety lives in the PZ
        # planner, not here); _configs_free applies it only near the root.
        self._root = root
        self._relax_halves = None
        for frac in (0.5, 0.0):
            if self._config_free(root):
                break
            self._relax_halves = np.maximum(
                self.obs_half - (1.0 - frac) * self.buffer, 0.0)
        # connect at full buffer; on failure retry with a GLOBALLY thinner
        # buffer — suite scenes have corridors the 8 cm capsule cannot pass
        # but the certified planner (whose own padding is ~1-3 cm) can.
        base_half = self.obs_half
        try:
            for scale in (1.0, 0.5, 0.25, 0.0):
                self.obs_half = np.maximum(
                    base_half - (1.0 - scale) * self.buffer, 0.0)
                path, ta = self._grow_once(root)
                self._tree = ta
                if path is not None:
                    self._path = np.asarray(self._smooth(path))
                    self._reaches_goal = True
                    return
            # no connection at any buffer: walk toward the closest-to-goal
            # node of the last attempt's root tree
            nodes = np.asarray(ta.nodes)
            best = int(np.argmin(
                np.linalg.norm(nodes - self.goal[None, :], axis=1)))
            self._path = np.asarray(self._smooth(self._chain(ta, best)))
            self._reaches_goal = False
        finally:
            self.obs_half = base_half

    def get_waypoint(self, q: np.ndarray) -> np.ndarray:
        """Walk the configuration path `lookahead` rad (arclength) forward of
        the projection of q onto the path."""
        q = np.asarray(q, float)
        if self._path is None:
            self._grow(q)
        path = self._path
        if len(path) < 2:
            return straight_line_waypoint(q, self.goal, self.lookahead,
                                          continuous=self.robot.continuous_joints)
        z, walked_off = _walk_path(path, q, self.lookahead)
        if walked_off:
            return np.asarray(self.goal, float)
        return np.asarray(z, float)

"""The receding-horizon planner: one planning step (counterpart of
armour_tpu/planner.py).

plan_step runs JRS -> PZ FK -> PZ RNEA torque bound (and, with
cfg.grasp_constraints, the contact rows from the RNEA's wrench) -> screen
of the obstacle hyperplanes -> ALM solve for a batch of worlds.  make_batch_planner,
make_planner, make_rescue_planner and make_realtime_planner return step
functions that run on the card by default; pass device="cpu" to run the
plain versions of every kernel on the CPU.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .collision import (ObstacleSet, build_hyperplanes, build_hyperplanes_plain, pad_obstacles,
                        screen_collision, screen_collision_plain)
from .armtd import build_jrs_armtd, build_jrs_armtd_plain
from .config import ArmourConfig
from .dynamics import reach_assembly, reach_assembly_plain, rnea_pz_sets, rnea_pz_sets_plain
from .grasp import contact_joint_of, grasp_params, grasp_rows, grasp_rows_plain
from .jrs import build_jrs, build_jrs_plain
from .kinematics import forward_occupancy, forward_occupancy_plain
from .nlp import PlanProblem, SolveResult, robot_limits, solve
from .pz.basis import KBasis, make_basis
from .robot import RobotModel
from .utils.timing import sync


def plan_problem(q0, qd0, qdd0, q_des, obs: ObstacleSet, robot: RobotModel,
                 cfg: ArmourConfig, basis: KBasis, plain: bool = False) -> PlanProblem:
    """Reachable sets, hyperplanes and screened rows of one planning step.
    q0/qd0/qdd0/q_des [W, F] tensors, obs [W, O, ...] on one device.
    The Bernstein JRS is kernel K12 on the card; cfg.traj_family "armtd"
    builds the constant-acceleration JRS (kernel K11) and ignores qdd0.  On
    the card the FK chain is kernel K9, the RNEA kernel K10, the assembly
    after them kernel K15 and the screen kernel K13, which forms the rows it
    needs from the cells; the hyperplanes are formed only where they are
    read (PlanProblem.hyp: the full-set check reads none on the card, where
    K4 forms its rows from the cells too).  plain=True takes their plain
    versions on any device, the hyperplanes formed at once."""
    if cfg.traj_family == "armtd":
        jrs = (build_jrs_armtd_plain if plain else build_jrs_armtd)(q0, qd0, robot, cfg, basis)
    elif cfg.traj_family == "bernstein":
        jrs = (build_jrs_plain if plain else build_jrs)(q0, qd0, qdd0, robot, cfg, basis)
    else:
        raise NotImplementedError(f"unknown trajectory family {cfg.traj_family!r}")
    return problem_from_jrs(jrs, q_des, obs, robot, cfg, basis, plain=plain)


def problem_from_jrs(jrs, q_des, obs: ObstacleSet, robot: RobotModel, cfg: ArmourConfig,
                     basis: KBasis, *, plain: bool = False) -> PlanProblem:
    """The stages after the JRS, shared by both trajectory families: FK
    (K9), RNEA (K10), the torque radius and the link split in one launch
    (K15), with cfg.grasp_constraints the contact rows from the wrench of
    the same K10 launch (K16), the hyperplanes of the cells (formed on
    first read) and the screen (K13)."""
    fk = forward_occupancy_plain if plain else forward_occupancy
    rnea = rnea_pz_sets_plain if plain else rnea_pz_sets
    links = fk(jrs, robot, cfg, basis)
    grasp = None
    if cfg.grasp_constraints:
        u_both, f_c, n_c = rnea(jrs, robot, cfg, basis, wrench_at=contact_joint_of(robot, None))
    else:
        u_both = rnea(jrs, robot, cfg, basis)
    frs, torque = (reach_assembly_plain if plain else reach_assembly)(
        links, u_both, robot, cfg, basis)
    if cfg.grasp_constraints:
        grasp = (grasp_rows_plain if plain else grasp_rows)(f_c, n_c, grasp_params(cfg), cfg,
                                                             basis)
    hyp = (build_hyperplanes_plain if plain else build_hyperplanes)(frs, obs)
    screened = (screen_collision_plain if plain else screen_collision)(
        hyp, obs, frs, cfg.screen_k, cfg.screen_obstacle_quota)
    return PlanProblem(traj=jrs.traj, q_des=q_des, torque=torque, frs=frs, hyp=hyp,
                       obs=obs, screened=screened,
                       limits=robot_limits(robot, q_des.dtype, q_des.device), grasp=grasp)


def plan_step(q0, qd0, qdd0, q_des, obs: ObstacleSet, robot: RobotModel,
              cfg: ArmourConfig, basis: KBasis, k0=None) -> SolveResult:
    """One full planning iteration for a batch of worlds (either trajectory
    family, as plan_problem builds it)."""
    prob = plan_problem(q0, qd0, qdd0, q_des, obs, robot, cfg, basis)
    return solve(prob, cfg, basis, k0=k0)


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device; raises when the
    card is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return dev


def _obs_to(obs: ObstacleSet, dtype, device) -> ObstacleSet:
    return ObstacleSet(centers=obs.centers.to(device=device, dtype=dtype),
                       generators=obs.generators.to(device=device, dtype=dtype),
                       mask=obs.mask.to(device=device, dtype=torch.bool))


def make_batch_planner(robot: RobotModel, cfg: ArmourConfig, *, device=None):
    """Planner over a leading worlds axis: (q0, qd0, qdd0, q_des [W, F],
    obs [W, O, ...]) -> SolveResult [W, ...]."""
    dev = resolve_device(device)
    basis = make_basis(robot.num_factors, cfg.max_poly_degree)

    def step(q0, qd0, qdd0, q_des, obs: ObstacleSet) -> SolveResult:
        args = [torch.as_tensor(x, dtype=cfg.dtype).to(dev) for x in (q0, qd0, qdd0, q_des)]
        return plan_step(*args, _obs_to(obs, cfg.dtype, dev), robot, cfg, basis)

    return step


def make_planner(robot: RobotModel, cfg: ArmourConfig, *, device=None):
    """Single-world planner: (q0, qd0, qdd0, q_des [F], obs [O, ...]) ->
    SolveResult for that world."""
    batch = make_batch_planner(robot, cfg, device=device)

    def step(q0, qd0, qdd0, q_des, obs: ObstacleSet) -> SolveResult:
        one = ObstacleSet(centers=obs.centers[None], generators=obs.generators[None],
                          mask=obs.mask[None])
        res = batch(*(torch.as_tensor(x)[None] for x in (q0, qd0, qdd0, q_des)), one)
        return SolveResult(k=res.k[0], feasible=res.feasible[0], cost=res.cost[0],
                           viol=res.viol[0])

    return step


def strong_config(cfg: ArmourConfig) -> ArmourConfig:
    """The rescue/acceptance solver profile: full iteration budget and deep
    screening."""
    return dataclasses.replace(
        cfg, solver_outer_iters=max(cfg.solver_outer_iters, 8),
        solver_inner_iters=max(cfg.solver_inner_iters, 6),
        solver_cull_after=2, solver_keep_seeds=2,
        solver_alphas=(1.0, 0.25, 0.0625, 0.015625),
        screen_k=max(cfg.screen_k, 4096))


def make_rescue_planner(robot: RobotModel, cfg: ArmourConfig, *, device=None):
    """Single-world planner at the strong profile, for infeasible-plan
    retries (armour_tpu/planner.py:110-113)."""
    return make_planner(robot, strong_config(cfg), device=device)


def make_realtime_planner(robot: RobotModel, cfg: ArmourConfig, example_args=None,
                          time_buffer: float = 0.05, min_outer: int = 2,
                          verbose: bool = False, *, device=None):
    """Budget-respecting single-world planner (armour_tpu/planner.py:116-191,
    the semantics of armour_main.cu:227-229).

    The reference gives the solver 0.5 * duration - t_reachsets - 0.05 s of
    wall time per solve and lets Ipopt stop on the clock.  Here the budget
    is met by calibration: time the reach-set prefix of the step
    (plan_problem, up to the screen), derive the solver budget, then lower
    solver_outer_iters one at a time until the measured step fits
    t_reachsets + budget or min_outer is reached.  Each timing is a warm-up
    call, then 5 calls ending in a device synchronisation, averaged.

    example_args: (q0, qd0, qdd0, q_des [F], obs [O, ...]) used for timing;
    defaults to a synthetic two-obstacle scene.  Returns (step,
    calibration) with calibration {"t_reachsets_s", "budget_s",
    "outer_iters", "step_s", "fits_budget"}, or None when min_outer exceeds
    cfg.solver_outer_iters.
    """
    dev = resolve_device(device)
    if example_args is None:
        rng = np.random.default_rng(0)
        q0 = torch.as_tensor(rng.uniform(-0.5, 0.5, robot.num_factors), dtype=cfg.dtype)
        c = np.array([[0.6, 0.6, 0.6], [-0.6, -0.5, 0.8]])
        g = np.stack([np.diag([0.05] * 3)] * 2)
        example_args = (q0, torch.zeros_like(q0), torch.zeros_like(q0), q0 + 0.04,
                        pad_obstacles(c, g, cfg.max_obstacles, cfg.dtype))
    basis = make_basis(robot.num_factors, cfg.max_poly_degree)

    def timed(fn, iters=5):
        fn(*example_args)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*example_args)
        sync(dev)
        return (time.perf_counter() - t0) / iters

    def reachsets_only(q0, qd0, qdd0, q_des, obs):
        args = [torch.as_tensor(x, dtype=cfg.dtype).to(dev)[None] for x in (q0, qd0, qdd0, q_des)]
        one = ObstacleSet(centers=obs.centers[None], generators=obs.generators[None],
                          mask=obs.mask[None])
        return plan_problem(*args, _obs_to(one, cfg.dtype, dev), robot, cfg, basis)

    t_rs = timed(reachsets_only)
    budget = 0.5 * cfg.duration - t_rs - time_buffer
    deadline = t_rs + budget

    outer = cfg.solver_outer_iters
    chosen = None
    while outer >= min_outer:
        cfg_i = dataclasses.replace(cfg, solver_outer_iters=outer,
                                    solver_cull_after=min(cfg.solver_cull_after,
                                                          max(outer - 1, 0)))
        step_i = make_planner(robot, cfg_i, device=dev)
        dt = timed(step_i)
        if verbose:
            print(f"realtime calibration: outer={outer} step={dt * 1e3:.1f} ms "
                  f"(deadline {deadline * 1e3:.1f} ms)")
        chosen = (step_i, {"t_reachsets_s": t_rs, "budget_s": budget,
                           "outer_iters": outer, "step_s": dt,
                           "fits_budget": dt <= deadline})
        if dt <= deadline:
            break
        outer -= 1
    return chosen

"""tests/test_armtd.py's closed-loop trial of the ARMTD family on the PyTorch
port's plain path (float64 on the CPU, num_time_steps = 16): cfg.traj_family
drives the planner, the reference and the braking.  The plain rollout is a
Python loop of small tensor ops, so it runs on one intra-op thread."""

import numpy as np
import torch

from armour_tpu_torch.collision import pad_obstacles
from armour_tpu_torch.config import ArmourConfig
from armour_tpu_torch.models.kinova import kinova_gen3
from armour_tpu_torch.planner import make_planner
from armour_tpu_torch.simulator import run_trial, sample_true_params
from armour_tpu_torch.worlds import World


def test_closed_loop_reaches_goal():
    robot = kinova_gen3()
    cfg = ArmourConfig(num_time_steps=16, dtype=torch.float64, max_obstacles=4, screen_k=256,
                       traj_family="armtd")
    start = np.zeros(7)
    w = World(start=start, goal=start + 0.35, obstacle_centers=np.array([[2.5, 2.5, 2.5]]),
              obstacle_generators=np.diag([0.05] * 3)[None])
    obs = pad_obstacles(w.obstacle_centers, w.obstacle_generators, cfg.max_obstacles, cfg.dtype)
    tp = sample_true_params(robot, np.random.default_rng(0), scale=1.0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        s = run_trial(w, robot, cfg, make_planner(robot, cfg, device="cpu"), obs, tp,
                      max_iterations=40, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert s.goal_reached and not s.collision and not s.torque_exceeded
    assert not s.ultimate_bound_exceeded and not s.joint_limit_exceeded

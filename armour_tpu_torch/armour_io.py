"""Reference-format file I/O: armour.in / armour.out and the four FRS dumps
(counterpart of armour_tpu/armour_io.py).

The reference planner is driven through text files (armour_main.cu:40-80
parses armour.in; 305-372 writes armour.out,
armour_joint_position_center.out, armour_joint_position_radius.out,
armour_control_input_radius.out, armour_constraints.out).  The same formats
let any reference dump be diffed against this planner and let it stand in
for the reference binary under the reference's MATLAB harness.

Obstacle layout in armour.in: per obstacle 12 numbers, the centre xyz then
3 generators as consecutive 3-vectors (rows); ObstacleSet stores the
generators as columns.

plan_from_armour_in runs the planner on the card by default (device=None);
the reach sets it slices for the dumps go through kernels K9 / K10 and the
full-set check through K4, which forms its rows from the cells there.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class ArmourIn:
    q0: np.ndarray          # [F]
    qd0: np.ndarray         # [F]
    qdd0: np.ndarray        # [F]
    q_des: np.ndarray       # [F]
    centers: np.ndarray     # [n, 3]
    generators: np.ndarray  # [n, 3, 3] columns = generators


def _read_tokens(path: str):
    with open(path) as f:
        return [float(t) for t in f.read().split()]


def read_armour_in(path: str, num_factors: int = 7) -> ArmourIn:
    vals = np.asarray(_read_tokens(path), dtype=np.float64)
    F = num_factors
    q0, qd0, qdd0, q_des = (vals[i * F:(i + 1) * F] for i in range(4))
    n = int(round(vals[4 * F]))
    body = vals[4 * F + 1: 4 * F + 1 + n * 12].reshape(n, 12)
    # rows of the file are generator vectors -> columns
    generators = body[:, 3:].reshape(n, 3, 3).transpose(0, 2, 1)
    return ArmourIn(q0=q0, qd0=qd0, qdd0=qdd0, q_des=q_des, centers=body[:, :3],
                    generators=generators)


def write_armour_in(path: str, data: ArmourIn) -> None:
    with open(path, "w") as f:
        for arr in (data.q0, data.qd0, data.qdd0, data.q_des):
            f.write(" ".join(f"{x:.10g}" for x in arr) + "\n")
        n = data.centers.shape[0]
        f.write(f"{n}\n")
        for i in range(n):
            row = list(data.centers[i]) + list(data.generators[i].T.ravel())
            f.write(" ".join(f"{x:.10g}" for x in row) + "\n")


def write_armour_out(path: str, k_opt: Optional[np.ndarray], millis: float) -> None:
    """k_opt lines then total ms; -1 if infeasible (armour_main.cu:314-325)."""
    with open(path, "w") as f:
        if k_opt is not None and np.all(np.isfinite(k_opt)):
            for x in np.asarray(k_opt).ravel():
                f.write(f"{x:.10g}\n")
        else:
            f.write("-1\n")
        f.write(f"{millis:.10g}")


def read_armour_out(path: str, num_factors: int = 7) -> Tuple[Optional[np.ndarray], float]:
    vals = _read_tokens(path)
    if len(vals) == 2 and vals[0] == -1:
        return None, vals[1]
    return np.asarray(vals[:num_factors]), vals[num_factors]


def frs_values(data: ArmourIn, k_slice: np.ndarray, robot, cfg, device,
               plain: bool = False) -> dict:
    """The reachable sets of data's initial state sliced at k_slice, and
    every constraint value there (armour_tpu/armour_io.py:128-192), as numpy:
    link centres [T, J, 3], shape generators [T, J, 3, 3], radii [T, J, 3],
    the torque radius [T, F], and the torque [T, F], collision [T, J, O]
    and 4F state rows.  plain=True takes the plain versions of the kernels
    (K3, K4, K9, K10, K12, K15) on `device`; on the card K4 forms its rows
    from the cells and K3 does not run."""
    from .collision import (build_hyperplanes, build_hyperplanes_plain, collision_constraints,
                            collision_constraints_plain, eval_link_polys, pad_obstacles)
    from .dynamics import (reach_assembly, reach_assembly_plain, rnea_pz_sets,
                           rnea_pz_sets_plain)
    from .jrs import build_jrs, build_jrs_plain
    from .kinematics import forward_occupancy, forward_occupancy_plain
    from .nlp import joint_position_extrema, joint_velocity_extrema
    from .planner import _obs_to
    from .pz.basis import make_basis

    dt = cfg.dtype
    basis = make_basis(robot.num_factors, cfg.max_poly_degree)
    obs = _obs_to(_batch1(pad_obstacles(data.centers, data.generators, cfg.max_obstacles, dt)),
                  dt, device)
    q0, qd0, qdd0 = (torch.as_tensor(x, dtype=dt).to(device)[None]
                     for x in (data.q0, data.qd0, data.qdd0))
    jrs = (build_jrs_plain if plain else build_jrs)(q0, qd0, qdd0, robot, cfg, basis)
    fk = forward_occupancy_plain if plain else forward_occupancy
    rnea = rnea_pz_sets_plain if plain else rnea_pz_sets
    frs, torque = (reach_assembly_plain if plain else reach_assembly)(
        fk(jrs, robot, cfg, basis), rnea(jrs, robot, cfg, basis), robot, cfg, basis)
    hyp = (build_hyperplanes_plain if plain else build_hyperplanes)(frs, obs)
    kk = torch.as_tensor(k_slice, dtype=dt).to(device)[None, None]        # [1, 1, F]
    phi = basis.phi(kk)                                                    # [1, 1, B]
    centers = torch.einsum("tjab,b->tja", frs.center_coef[0], phi[0, 0])
    T, F = torque.u_coef.shape[1:3]
    u = (torque.u_coef[0].reshape(T * F, -1) @ phi[0, 0]).reshape(T, F)
    col = collision_constraints_plain if plain else collision_constraints
    g_col = col(hyp, obs, eval_link_polys(frs, phi))[0, 0]                 # [T, J, O]
    q_min, q_max, _, _ = joint_position_extrema(kk, jrs.traj, cfg)
    qd_min, qd_max, _, _ = joint_velocity_extrema(kk, jrs.traj, cfg)
    state = torch.cat([q_min[0, 0], q_max[0, 0], qd_min[0, 0], qd_max[0, 0]])
    return {name: t.detach().cpu().numpy() for name, t in (
        ("link_centers", centers), ("link_generators", frs.shape_gens[0]),
        ("link_radius", frs.radius[0]), ("torque_radius", torque.torque_radius[0]),
        ("constraint_torque", u), ("constraint_collision", g_col),
        ("constraint_state", state))}


def _batch1(obs):
    from .collision import ObstacleSet

    return ObstacleSet(centers=obs.centers[None], generators=obs.generators[None],
                       mask=obs.mask[None])


def plan_from_armour_in(in_path: str, out_dir: str, robot, cfg, planner_step=None,
                        *, device=None) -> dict:
    """Run one planning iteration from an armour.in file and write every
    reference output file into out_dir (armour_tpu/armour_io.py:81-201).
    Returns the parsed result dict with the JAX function's keys; millis is
    the planner's wall time, ending in a device synchronisation."""
    from .collision import pad_obstacles
    from .planner import make_planner, resolve_device
    from .utils.timing import sync

    dev = resolve_device(device)
    data = read_armour_in(in_path, robot.num_factors)
    obs = pad_obstacles(data.centers, data.generators, cfg.max_obstacles, cfg.dtype)
    step = planner_step if planner_step is not None else make_planner(robot, cfg, device=dev)

    sync(dev)
    t0 = time.perf_counter()
    res = step(*(torch.as_tensor(x, dtype=cfg.dtype) for x in
                 (data.q0, data.qd0, data.qdd0, data.q_des)), obs)
    sync(dev)
    millis = 1e3 * (time.perf_counter() - t0)
    k = res.k.detach().cpu().numpy()
    feasible = bool(np.all(np.isfinite(k)))

    # the reference dumps whatever finalize_solution held: the sets sliced
    # at k, or at 0 when infeasible
    vals = frs_values(data, np.where(np.isfinite(k), k, 0.0), robot, cfg, dev)
    centers, shape_gens, radius = (vals[n] for n in ("link_centers", "link_generators",
                                                     "link_radius"))
    T, J = centers.shape[:2]

    os.makedirs(out_dir, exist_ok=True)
    write_armour_out(os.path.join(out_dir, "armour.out"), k if feasible else None, millis)
    with open(os.path.join(out_dir, "armour_joint_position_center.out"), "w") as f:
        for i in range(T):
            for j in range(J):
                f.write(" ".join(f"{x:.10g}" for x in centers[i, j]) + " \n")
    with open(os.path.join(out_dir, "armour_joint_position_radius.out"), "w") as f:
        for i in range(T):
            for j in range(J):
                gen6 = np.concatenate([shape_gens[i, j], np.diag(radius[i, j])], axis=1)
                for r in range(3):
                    f.write(" ".join(f"{x:.10g}" for x in gen6[r]) + " \n")
    if not cfg.turn_off_input_constraints:
        with open(os.path.join(out_dir, "armour_control_input_radius.out"), "w") as f:
            for row in vals["torque_radius"]:
                f.write(" ".join(f"{x:.10g}" for x in row) + " \n")

    # armour_constraints.out (armour_main.cu:366-371): the torque rows
    # time-major (t*F + j, NLPclass.cu:308), the collision rows LINK-major
    # ((link*T + t)*O + o, CollisionChecking.cu:128), then the 4F state rows
    n_obs = len(data.centers)
    gc = vals["constraint_collision"][:, :, :n_obs]
    with open(os.path.join(out_dir, "armour_constraints.out"), "w") as f:
        for x in vals["constraint_torque"].reshape(-1):
            f.write(f"{x:.6g}\n")
        for x in np.transpose(gc, (1, 0, 2)).reshape(-1):
            f.write(f"{x:.6g}\n")
        for x in vals["constraint_state"]:
            f.write(f"{x:.6g}\n")

    return {"k": k, "feasible": feasible, "millis": millis,
            "link_centers": centers, "link_generators": shape_gens, "link_radius": radius,
            "constraint_torque": vals["constraint_torque"],
            "constraint_collision": gc,
            "constraint_state": vals["constraint_state"]}

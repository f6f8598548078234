"""PZ forward kinematics and link forward-occupancy sets (counterpart of
armour_tpu/kinematics.py).

The serial chain

    FK_T <- FK_T + FK_R @ P_i ;  FK_R <- FK_R @ R_i ;
    links_i = FK_R @ link_box_i + FK_T

runs on [W, T]-batched BPZ tensors.  forward_occupancy_plain is a Python
loop over the joints of the plain PyTorch ops; on CUDA tensors the whole
chain is kernel K9 (kernels/reach.py, csrc/fk_chain.cu), and the split of
its links (reduce_links) part of kernel K15 (csrc/reach_assembly.cu).
"""

from __future__ import annotations

import dataclasses

import torch

from .config import ArmourConfig
from .jrs import JRS
from .pz import bpz
from .pz.basis import KBasis, error_layout
from .pz.bpz import BPZ
from .robot import RobotModel
from .utils import abs_sum_in_order, to_device


@dataclasses.dataclass
class LinkFRS:
    """Reduced link forward reachable sets.  center_coef: k-polynomial of
    each link centre; shape_gens: 3 rotated box generators (columns);
    radius: per-axis independent radii."""

    center_coef: torch.Tensor  # [W, T, J, 3, B]
    shape_gens: torch.Tensor   # [W, T, J, 3, 3]
    radius: torch.Tensor       # [W, T, J, 3]


def link_box_pz(robot: RobotModel, basis: KBasis, dtype, *, device) -> BPZ:
    """Link bounding boxes as BPZ [J, 3] with shape-slot generators."""
    lay = error_layout(basis.nf)
    J = robot.num_joints
    coef = torch.zeros((J, 3, basis.size), dtype=dtype, device=device)
    coef[..., 0] = to_device(robot.link_center, dtype, device)
    egen = torch.zeros((J, 3, lay["size"]), dtype=dtype, device=device)
    gens = to_device(robot.link_generators, dtype, device)
    for j in range(3):
        egen[:, j, lay["shape"].start + j] = gens[:, j]
    return BPZ(coef=coef, egen=egen, rad=torch.zeros((J, 3), dtype=dtype, device=device))


def forward_occupancy_plain(jrs: JRS, robot: RobotModel, cfg: ArmourConfig,
                            basis: KBasis) -> BPZ:
    """Plain version of kernel K9: the forward-kinematics chain as a loop
    over the joints of the plain PyTorch ops (armour_tpu/kinematics.py:97-107),
    on any device: link PZs [W, T, J, 3]."""
    R = jrs.R
    dt, dev = R.coef.dtype, R.coef.device
    Wn, T = R.coef.shape[:2]
    J = robot.num_joints
    boxes = link_box_pz(robot, basis, dt, device=dev)
    trans = to_device(robot.trans, dt, dev)

    fk_r = bpz.zeros((Wn, T, 3, 3), basis, dt, device=dev)
    fk_r.coef[..., 0] = torch.eye(3, dtype=dt, device=dev)
    fk_t = bpz.zeros((Wn, T, 3), basis, dt, device=dev)
    links = []
    for i in range(J):
        r_i = BPZ(coef=R.coef[:, :, i], egen=R.egen[:, :, i], rad=R.rad[:, :, i])
        box_i = BPZ(coef=boxes.coef[i], egen=boxes.egen[i], rad=boxes.rad[i])
        fk_t = bpz.add(fk_t, bpz.matvec_cvec(fk_r, trans[i]))
        # R_i is a degree<=1 rotation PZ; the box has constant-only k-coefs
        fk_r = bpz.matmul_linear_right_plain(fk_r, r_i, basis, cfg.float_slop)
        links.append(bpz.add(bpz.matvec_const_coef(fk_r, box_i, cfg.float_slop), fk_t))
    return bpz.stack(links, dim=-2)


def forward_occupancy(jrs: JRS, robot: RobotModel, cfg: ArmourConfig,
                      basis: KBasis) -> BPZ:
    """Forward kinematics: link PZs [W, T, J, 3].  Kernel K9 on CUDA
    tensors, forward_occupancy_plain on CPU tensors."""
    if not jrs.R.coef.is_cuda:
        return forward_occupancy_plain(jrs, robot, cfg, basis)
    from .kernels import reach

    return reach.fk_chain(jrs, robot, cfg, basis)


def reduce_links_plain(links: BPZ, basis: KBasis) -> LinkFRS:
    """The link part of kernel K15's plain version: the link PZs split into
    the sliceable k-polynomial (a view), the shape generators and the
    radii, rad + sum |other egen| summed left to right
    (armour_tpu/kinematics.py:115-125)."""
    sh = error_layout(basis.nf)["shape"]
    shape_gens = links.egen[..., sh]                         # [W, T, J, 3, 3gen]
    radius = links.rad + abs_sum_in_order(links.egen[..., : sh.start],
                                          links.egen[..., sh.stop:])
    return LinkFRS(center_coef=links.coef, shape_gens=shape_gens.contiguous(),
                   radius=radius)


def reduce_links(links: BPZ, basis: KBasis) -> LinkFRS:
    """Split link PZs into sliceable k-poly + shape generators + radii:
    reduce_links_plain on CPU tensors.  On the card the split is part of
    kernel K15, which takes the RNEA's torque too: call
    dynamics.reach_assembly."""
    if links.rad.is_cuda:
        raise ValueError("reduce_links: on CUDA tensors the link split runs in kernel K15 "
                         "with the torque; call dynamics.reach_assembly")
    return reduce_links_plain(links, basis)

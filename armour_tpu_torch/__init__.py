"""armour_tpu_torch: the ARMOUR receding-horizon safe planner in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package `armour_tpu` is the reference this package is held against;
nothing here imports it.  Entry points (planner.make_planner,
planner.make_batch_planner) run on the card unless the caller passes
device="cpu", in which case every kernel wrapper takes its plain PyTorch
version.
"""

__version__ = "0.1.0"

import torch as _torch

# Safety-critical set arithmetic: TF32 keeps ~10 mantissa bits, which loses
# ~1e-3..1e-2 relative on reachable-set radii and on the hyperplane buffer
# delta (the hazard the JAX package pins away with "highest" precision).
# Every float32 product in the port runs in full IEEE float32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

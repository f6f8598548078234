"""Small helpers shared by the port's modules."""

import numpy as np
import torch


def to_device(x, dtype, device) -> torch.Tensor:
    """Host array -> tensor on `device` without a stream synchronisation
    (a pageable host-to-device copy is staged before the call returns)."""
    return torch.as_tensor(np.asarray(x), dtype=dtype).to(device, non_blocking=True)

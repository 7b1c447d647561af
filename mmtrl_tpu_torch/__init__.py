"""PyTorch/CUDA port of mmtrl_tpu for NVIDIA Hopper (H100).

Module layout mirrors ``mmtrl_tpu`` so each port sits at the same path as
its JAX counterpart.  Entry points run on the card: ``device=None`` means
``torch.device("cuda")`` and raises when CUDA is missing; pass
``device="cpu"`` to run the plain PyTorch versions on the host.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> CUDA; raises rather than quietly running on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the host"
        )
    return device

"""The device rule of the port's entry points.

Entry points run on the CUDA card unless the caller passes device="cpu".
Without a device and without CUDA they raise; there is no silent fallback.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """torch.device with an explicit index for CUDA."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch versions on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device %s requested but CUDA is not available"
                               % dev)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError("unsupported device %s (cuda or cpu)" % dev)
    return dev

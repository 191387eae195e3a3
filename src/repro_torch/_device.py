"""Device resolution shared by the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``.  A CUDA device
on a host without one raises here; nothing moves to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    return dev

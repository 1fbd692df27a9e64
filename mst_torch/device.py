"""The device an entry point runs on, and the card's fp32 settings.

Entry points of the port run on the GPU unless the caller asks for the CPU:
``resolve_device(None)`` is ``cuda`` and raises without a card.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; without one that is an error, never a quiet
    fall back to the CPU. Pass ``"cpu"`` to run on the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: mst_torch runs on the GPU "
                               "unless device='cpu' is passed")
        return torch.device("cuda")
    return torch.device(device)


def strict_fp32() -> None:
    """Full fp32 on the card: no TF32 in matmuls or cuDNN convolutions (the
    default would run the encoders' ``beats_conv`` in TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

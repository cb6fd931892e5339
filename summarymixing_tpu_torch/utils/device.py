"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means the card: return `cuda`, or raise when there is none.
    The port never falls back to the CPU on its own; callers that want the
    CPU (the tests) say so with `device="cpu"`."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    return torch.device("cuda")

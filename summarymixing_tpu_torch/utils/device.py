"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means the card: return `cuda`, or raise when there is none.
    The port never falls back to the CPU on its own; callers that want the
    CPU (the tests) say so with `device="cpu"`. A card without an index
    becomes the current card by index (`cuda:k`): the current card is set
    per thread, and the runners' batch prefetcher runs in a thread of its
    own, which would otherwise put its tensors on card 0 (a process of a
    multi-process run drives card k)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device

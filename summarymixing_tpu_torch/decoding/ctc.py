"""Greedy CTC decoding — the port of `summarymixing_tpu/decoding/ctc.py`."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def ctc_greedy_decode(log_probs: torch.Tensor, lengths: torch.Tensor,
                      blank_id: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Argmax per frame and the frames that survive collapse (not blank, not
    a repeat, inside the length). Returns `(ids [B, T], keep [B, T])`."""
    ids = log_probs.argmax(dim=-1)
    prev = torch.nn.functional.pad(ids[:, :-1], (1, 0), value=-1)
    valid = torch.arange(ids.shape[1], device=ids.device)[None, :] < lengths[:, None]
    keep = (ids != blank_id) & (ids != prev) & valid
    return ids, keep


def collapse_ctc(ids, keep) -> List[List[int]]:
    """Host side: `(ids, keep)` -> ragged token lists."""
    if isinstance(ids, torch.Tensor):
        ids, keep = ids.cpu().numpy(), keep.cpu().numpy()
    return [[int(i) for i in row_ids[row_keep.astype(bool)]]
            for row_ids, row_keep in zip(np.asarray(ids), np.asarray(keep))]

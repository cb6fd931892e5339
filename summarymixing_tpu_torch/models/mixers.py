"""Token-mixer selection — the SummaryMixing route of `make_mixer` /
`apply_mixer` from `summarymixing_tpu/models/mixers.py`, for the encoders
and the Summary Decoder. The attention mixers (regularMHA, RelPosMHAXL,
hypermixing) are still to port as mixers (the decoders' MHA is
`ops.attention.MultiheadAttention`)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from summarymixing_tpu_torch.ops.masks import combine_padding
from summarymixing_tpu_torch.ops.summary_mixing import SummaryMixing


def make_mixer(attention_type: str, d_model: int, nhead: int, *,
               local_proj_hid_dim: Sequence[int] = (512,), local_proj_out_dim: int = 512,
               summary_hid_dim: Sequence[int] = (1024,), summary_out_dim: int = 1024,
               mode: str = "SummaryMixing", activation: str = "gelu_exact",
               dropout_rate: float = 0.0) -> SummaryMixing:
    if attention_type != "SummaryMixing":
        raise NotImplementedError(
            f"mixer {attention_type!r} is not ported; see ROADMAP.md, 'Modules still to port'")
    return SummaryMixing(
        enc_dim=d_model, nhead=nhead, local_proj_hid_dim=tuple(local_proj_hid_dim),
        local_proj_out_dim=local_proj_out_dim, summary_hid_dim=tuple(summary_hid_dim),
        summary_out_dim=summary_out_dim, activation=activation, mode=mode,
        dropout_rate=dropout_rate)


def apply_mixer(mixer: SummaryMixing, attention_type: str, x: torch.Tensor, *,
                attn_mask: Optional[torch.Tensor] = None,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the mixer; attn_mask (`[T, T]`, 1 = include) doubles as the
    SummaryMixing sum_mask, with the `[B, T]` pad_mask's padded columns
    embedded (`combine_padding`: `[B, T, T]`, or the `[T, T]` mask as it is
    without a pad_mask) so summaries count only valid frames; the cell's
    `summary_matmul` takes either shape."""
    if attention_type != "SummaryMixing":
        raise NotImplementedError(f"mixer {attention_type!r} is not ported")
    return mixer(x, sum_mask=combine_padding(attn_mask, pad_mask), pad_mask=pad_mask)

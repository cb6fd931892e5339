"""Token-mixer selection — the port of `make_mixer` and `apply_mixer` from
`summarymixing_tpu/models/mixers.py`, shared by the Branchformer, Conformer
and Transformer encoder layers and the Summary Decoder.

`make_mixer` builds the mixer an `attention_type` names: regularMHA (and
its alias vanillaMHA), RelPosMHAXL, hypermixing or SummaryMixing.
`cnnonly` names no mixer: the Branchformer layer keeps its cgMLP branch
alone and never calls the factory, so the factory refuses it.
`apply_mixer` runs any of them with one signature: the attention mixers
get (x, x, x) with the attention mask, the padding mask and, for
RelPosMHAXL, the relative position table.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from summarymixing_tpu_torch.ops.attention import HyperMixing, MultiheadAttention, RelPosMHAXL
from summarymixing_tpu_torch.ops.masks import combine_padding
from summarymixing_tpu_torch.ops.summary_mixing import SummaryMixing

ATTENTION_TYPES = (
    "regularMHA",
    "RelPosMHAXL",
    "hypermixing",
    "SummaryMixing",
    "vanillaMHA",
    "cnnonly",
)


def make_mixer(attention_type: str, d_model: int, nhead: int, *,
               local_proj_hid_dim: Sequence[int] = (512,), local_proj_out_dim: int = 512,
               summary_hid_dim: Sequence[int] = (1024,), summary_out_dim: int = 1024,
               mode: str = "SummaryMixing", activation: str = "gelu_exact",
               hypernet_size: Optional[int] = None, mask_pos_future: bool = False,
               dropout_rate: float = 0.0) -> nn.Module:
    """The mixer `attention_type` names. `activation` is the SummaryMixing
    cell's; `hypernet_size` HyperMixing's width (`local_proj_hid_dim[0]`
    unless given); `mask_pos_future` makes RelPosMHAXL causal."""
    if attention_type not in ATTENTION_TYPES:
        raise ValueError(
            f"attention_type must be one of {ATTENTION_TYPES}, got {attention_type!r}")
    if attention_type in ("regularMHA", "vanillaMHA"):
        return MultiheadAttention(d_model, nhead, dropout_rate)
    if attention_type == "RelPosMHAXL":
        return RelPosMHAXL(d_model, nhead, dropout_rate, mask_pos_future=mask_pos_future)
    if attention_type == "hypermixing":
        return HyperMixing(d_model, hypernet_size or local_proj_hid_dim[0], nhead)
    if attention_type == "SummaryMixing":
        return SummaryMixing(
            enc_dim=d_model, nhead=nhead, local_proj_hid_dim=tuple(local_proj_hid_dim),
            local_proj_out_dim=local_proj_out_dim, summary_hid_dim=tuple(summary_hid_dim),
            summary_out_dim=summary_out_dim, activation=activation, mode=mode,
            dropout_rate=dropout_rate)
    raise ValueError(
        "attention_type 'cnnonly' is only supported by the Branchformer encoder (reference "
        "Branchformer.py:201-204); conformer/transformer layers need a token mixer")


def apply_mixer(mixer: nn.Module, attention_type: str, x: torch.Tensor, *,
                attn_mask: Optional[torch.Tensor] = None,
                pad_mask: Optional[torch.Tensor] = None,
                pos_embs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the mixer. For SummaryMixing, attn_mask (`[T, T]`, 1 = include)
    doubles as the sum_mask, with the `[B, T]` pad_mask's padded columns
    embedded (`combine_padding`: `[B, T, T]`, or the `[T, T]` mask as it is
    without a pad_mask) so summaries count only valid frames; the cell's
    `summary_matmul` takes either shape. `pos_embs` reaches RelPosMHAXL
    only."""
    if attention_type == "SummaryMixing":
        return mixer(x, sum_mask=combine_padding(attn_mask, pad_mask), pad_mask=pad_mask)
    if attention_type == "RelPosMHAXL":
        return mixer(x, x, x, attn_mask=attn_mask, pad_mask=pad_mask, pos_embs=pos_embs)
    return mixer(x, x, x, attn_mask=attn_mask, pad_mask=pad_mask)

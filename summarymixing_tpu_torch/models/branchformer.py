"""Branchformer encoder — the port of `summarymixing_tpu/models/branchformer.py`
(unrolled `layer_{i}` layout), with every token mixer of `models.mixers`.

Each layer runs LayerNorm -> mixer beside LayerNorm -> cgMLP, merges the
two over `cat([x1, x2])`, and adds the residual. With SummaryMixing the
merge is `SummaryNet(summary_hid_dim + (d_model,))` over `summary_out_dim +
d_model` features; with an attention mixer (regularMHA, RelPosMHAXL,
hypermixing) it is one Dense(2·d_model -> d_model); with `cnnonly` the
layer has no mixer, no `norm_mhsa` and no merge, and adds the cgMLP
branch alone. Dropout follows each branch and the merge, as in the flax
layer. The stack ends in a LayerNorm with eps 1e-6; the layers' norms use
1e-5. RelPosMHAXL takes the `[1, 2T-1, D]` position table as `pos_embs`.
With `remat` each layer's activations are recomputed in the backward pass
(`ops.layers.remat_call`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from summarymixing_tpu_torch.models.mixers import apply_mixer, make_mixer
from summarymixing_tpu_torch.ops.convolution import ConvolutionBranch
from summarymixing_tpu_torch.ops.layers import Dense, Dropout, LayerNorm, remat_call
from summarymixing_tpu_torch.ops.linear import SummaryNet


class BranchformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, kernel_size: int = 31,
                 attention_type: str = "SummaryMixing", csgu_linear_units: int = 3072,
                 gate_activation: Optional[str] = None, use_linear_after_conv: bool = False,
                 local_proj_hid_dim: Sequence[int] = (512,), local_proj_out_dim: int = 512,
                 summary_hid_dim: Sequence[int] = (1024,), summary_out_dim: int = 1024,
                 mode: str = "SummaryMixing", activation: str = "gelu_exact",
                 dropout_rate: float = 0.0, act_int8: bool = False):
        super().__init__()
        self.attention_type = attention_type
        if attention_type != "cnnonly":
            self.mixer = make_mixer(
                attention_type, d_model, nhead, local_proj_hid_dim=local_proj_hid_dim,
                local_proj_out_dim=local_proj_out_dim, summary_hid_dim=summary_hid_dim,
                summary_out_dim=summary_out_dim, mode=mode, activation=activation,
                dropout_rate=dropout_rate)
            if attention_type == "SummaryMixing":
                self.merge_proj = SummaryNet(summary_out_dim + d_model,
                                             tuple(summary_hid_dim) + (d_model,),
                                             activation=activation)
            else:
                self.merge_proj = Dense(2 * d_model, d_model)
            self.norm_mhsa = LayerNorm(d_model, eps=1e-5)
        self.convolution_branch = ConvolutionBranch(
            d_model, csgu_linear_units, kernel_size, activation, gate_activation,
            use_linear_after_conv, dropout_rate, act_int8)
        self.norm_conv = LayerNorm(d_model, eps=1e-5)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, src_mask: Optional[torch.Tensor] = None,
                pad_mask: Optional[torch.Tensor] = None,
                pos_embs: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.attention_type == "cnnonly":
            return x + self.dropout(self.convolution_branch(self.norm_conv(x), pad_mask=pad_mask))
        x1 = self.dropout(apply_mixer(self.mixer, self.attention_type, self.norm_mhsa(x),
                                      attn_mask=src_mask, pad_mask=pad_mask, pos_embs=pos_embs))
        x2 = self.dropout(self.convolution_branch(self.norm_conv(x), pad_mask=pad_mask))
        return x + self.dropout(self.merge_proj(torch.cat([x1, x2], dim=-1)))


class BranchformerEncoder(nn.Module):
    """Stack of `BranchformerEncoderLayer`s (`layer_0` ...) + final `norm`.
    `scan_layers` is taken and changes nothing here: the JAX encoder runs
    its layers under `nn.scan` with stacked `layers: {...: [L, ...]}`
    parameters, which compute what the unrolled layers compute
    (`utils.convert.load_jax_params` reads that layout into `layer_{i}`,
    and `parallel.pipeline.stacked_params` builds it)."""

    def __init__(self, num_layers: int, d_model: int, nhead: int, remat: bool = False,
                 scan_layers: bool = False, **layer_kwargs):
        super().__init__()
        self.num_layers = num_layers
        self.remat = remat
        self.scan_layers = scan_layers
        self.layer_kwargs = dict(layer_kwargs, d_model=d_model, nhead=nhead)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", BranchformerEncoderLayer(d_model, nhead, **layer_kwargs))
        self.norm = LayerNorm(d_model, eps=1e-6)

    def forward(self, x: torch.Tensor, src_mask: Optional[torch.Tensor] = None,
                pad_mask: Optional[torch.Tensor] = None,
                pos_embs: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            x = (remat_call(layer, x, src_mask, pad_mask, pos_embs) if self.remat
                 else layer(x, src_mask, pad_mask, pos_embs))
        return self.norm(x)

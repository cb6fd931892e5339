"""Conformer encoder with any token mixer of `models.mixers`, Dynamic Chunk
Training masks, a causal form and chunked streaming, and the Conformer
decoder — the port of `ConformerEncoderLayer`, `ConformerEncoder`, their
streaming state, `ConformerDecoderLayer` and `ConformerDecoder` from
`summarymixing_tpu/models/conformer.py`.

A layer is: x += ½·ffn1(norm_ffn1(x)); x = mixer(norm1(x)) + x;
x += convolution_module(x); x = norm2(x + ½·ffn2(norm_ffn2(x))). The
SummaryMixing mixer's output width is d_model; HyperMixing's hypernetwork
is d_ffn wide. With `causal` the RelPosMHAXL mixer masks future keys
(`mask_pos_future`) and the depthwise conv is causal; RelPosMHAXL takes the
`[1, 2T-1, D]` position table as `pos_embs`. The stack ends in a
LayerNorm with eps 1e-6; the layers' norms use 1e-5. With `remat` each
layer's activations are recomputed in the backward pass
(`ops.layers.remat_call`); streaming is untouched.

A decoder layer (no recipe builds one; the reference's surface,
Conformer.py:859-1151) is: x = tgt + ½·ffn1(norm_ffn1(tgt)); x = x +
cross-attention(norm1(x), memory) (`MultiheadAttention`, or
`RelPosMHAXL` with `mask_pos_future` when causal, which takes the memory's
`[1, 2S-1, D]` table as `pos_embs_src` and square attention only); x +=
the causal convolution module (kernel 3); x = norm2(x + ½·ffn2(norm_ffn2(x))).
Its activation is swish (flax's `silu`); the stack ends in a LayerNorm
with eps 1e-6.

Streaming carries, per layer, the last `left_context_frames` mixer inputs
(post-ffn1), the last kernel//2 conv-module inputs and a per-row count of
frames seen, so rows of one batch may be independent streams at other
positions. A chunk's mixer sees [left buffer | chunk] with the buffer's
unfilled positions masked out (RelPosMHAXL with the table of left + chunk
positions); its depthwise conv sees the last kernel//2
real frames and zeros past the chunk, which is what the Dynamic Chunk
Convolution computes offline.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from summarymixing_tpu_torch.models.mixers import apply_mixer, make_mixer
from summarymixing_tpu_torch.ops.attention import (
    MultiheadAttention,
    PositionalwiseFeedForward,
    RelPosMHAXL,
)
from summarymixing_tpu_torch.ops.convolution import ConvolutionModule
from summarymixing_tpu_torch.ops.layers import Dropout, LayerNorm, remat_call


@dataclass
class ConformerLayerStreamingState:
    mha_left: torch.Tensor     # [B, left_frames, D] post-ffn1 inputs to the mixer
    conv_left: torch.Tensor    # [B, kernel//2, D] inputs to the conv module
    frames_seen: torch.Tensor  # [B] int: frames processed so far, per row


@dataclass
class ConformerStreamingState:
    layers: Tuple[ConformerLayerStreamingState, ...]


def _buffer_valid(seen: torch.Tensor, size: int, chunk: int) -> torch.Tensor:
    """`[B, size + chunk]` float: a left buffer of `size` positions holds
    `min(seen, size)` real frames at its end; the chunk's frames are real."""
    pos = torch.arange(size, device=seen.device)[None, :]
    buf = pos >= size - torch.clamp(seen[:, None], max=size)
    return torch.cat([buf, torch.ones(seen.shape[0], chunk, dtype=torch.bool,
                                      device=seen.device)], dim=1)


class ConformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, d_ffn: int, nhead: int, kernel_size: int = 31,
                 dropout_rate: float = 0.0, causal: bool = False,
                 attention_type: str = "SummaryMixing",
                 local_proj_hid_dim: Sequence[int] = (512,), local_proj_out_dim: int = 512,
                 summary_hid_dim: Sequence[int] = (1024,), mode: str = "SummaryMixing",
                 activation: str = "swish"):
        super().__init__()
        self.d_model = d_model
        self.kernel_size = kernel_size
        self.attention_type = attention_type
        self.mixer = make_mixer(
            attention_type, d_model, nhead, local_proj_hid_dim=local_proj_hid_dim,
            local_proj_out_dim=local_proj_out_dim, summary_hid_dim=summary_hid_dim,
            summary_out_dim=d_model, mode=mode, activation=activation, hypernet_size=d_ffn,
            mask_pos_future=causal, dropout_rate=dropout_rate)
        self.convolution_module = ConvolutionModule(d_model, kernel_size, activation,
                                                    dropout_rate, causal)
        self.ffn1 = PositionalwiseFeedForward(d_ffn, d_model, dropout_rate, activation)
        self.ffn2 = PositionalwiseFeedForward(d_ffn, d_model, dropout_rate, activation)
        for name in ("norm_ffn1", "norm_ffn2", "norm1", "norm2"):
            self.add_module(name, LayerNorm(d_model, eps=1e-5))
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, src_mask: Optional[torch.Tensor] = None,
                pad_mask: Optional[torch.Tensor] = None,
                pos_embs: Optional[torch.Tensor] = None, chunk_size=None) -> torch.Tensor:
        x = x + 0.5 * self.dropout(self.ffn1(self.norm_ffn1(x)))
        x = apply_mixer(self.mixer, self.attention_type, self.norm1(x), attn_mask=src_mask,
                        pad_mask=pad_mask, pos_embs=pos_embs) + x
        x = x + self.convolution_module(x, pad_mask=pad_mask, chunk_size=chunk_size)
        return self.norm2(x + 0.5 * self.dropout(self.ffn2(self.norm_ffn2(x))))

    def init_streaming_state(self, batch: int, left_context_frames: int,
                             dtype: torch.dtype = torch.float32,
                             device=None) -> ConformerLayerStreamingState:
        pad = (self.kernel_size - 1) // 2
        return ConformerLayerStreamingState(
            mha_left=torch.zeros(batch, left_context_frames, self.d_model, dtype=dtype,
                                 device=device),
            conv_left=torch.zeros(batch, pad, self.d_model, dtype=dtype, device=device),
            frames_seen=torch.zeros(batch, dtype=torch.int32, device=device))

    def streaming_step(self, x: torch.Tensor, state: ConformerLayerStreamingState,
                       pos_embs: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, ConformerLayerStreamingState]:
        """One chunk `[B, C, D]` through the layer with the carried left
        context (`pos_embs`: RelPosMHAXL's table over left + C positions);
        returns the chunk's output and the next state."""
        orig = x.shape[1]
        l_buf = state.mha_left.shape[1]
        pad = state.conv_left.shape[1]
        seen = state.frames_seen

        x = x + 0.5 * self.ffn1(self.norm_ffn1(x))
        xcat = torch.cat([state.mha_left, x], dim=1)
        valid = _buffer_valid(seen, l_buf, orig).to(xcat.dtype)
        mixed = apply_mixer(self.mixer, self.attention_type, self.norm1(xcat), pad_mask=valid,
                            pos_embs=pos_embs)
        x = (mixed + xcat)[:, -orig:]

        conv_in = torch.cat([state.conv_left, x], dim=1)
        conv_valid = _buffer_valid(seen, pad, orig).to(conv_in.dtype)
        x = x + self.convolution_module(conv_in, pad_mask=conv_valid)[:, -orig:]

        x = self.norm2(x + 0.5 * self.ffn2(self.norm_ffn2(x)))
        return x, ConformerLayerStreamingState(
            mha_left=xcat[:, xcat.shape[1] - l_buf:],
            conv_left=conv_in[:, conv_in.shape[1] - pad:],
            frames_seen=seen + orig)


class ConformerEncoder(nn.Module):
    """Stack of `ConformerEncoderLayer`s (`layer_0` ...) + final `norm`."""

    def __init__(self, num_layers: int, d_model: int, d_ffn: int, nhead: int,
                 remat: bool = False, **layer_kwargs):
        super().__init__()
        self.num_layers = num_layers
        self.remat = remat
        for i in range(num_layers):
            self.add_module(f"layer_{i}",
                            ConformerEncoderLayer(d_model, d_ffn, nhead, **layer_kwargs))
        self.norm = LayerNorm(d_model, eps=1e-6)

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def forward(self, x: torch.Tensor, src_mask: Optional[torch.Tensor] = None,
                pad_mask: Optional[torch.Tensor] = None,
                pos_embs: Optional[torch.Tensor] = None, chunk_size=None) -> torch.Tensor:
        for layer in self.layers():
            x = (remat_call(layer, x, src_mask, pad_mask, pos_embs, chunk_size) if self.remat
                 else layer(x, src_mask, pad_mask, pos_embs, chunk_size))
        return self.norm(x)

    def init_streaming_state(self, batch: int, left_context_frames: int,
                             dtype: torch.dtype = torch.float32,
                             device=None) -> ConformerStreamingState:
        return ConformerStreamingState(layers=tuple(
            layer.init_streaming_state(batch, left_context_frames, dtype, device)
            for layer in self.layers()))

    def streaming_step(self, x: torch.Tensor, state: ConformerStreamingState,
                       pos_embs: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, ConformerStreamingState]:
        new_states = []
        for layer, lstate in zip(self.layers(), state.layers):
            x, new = layer.streaming_step(x, lstate, pos_embs)
            new_states.append(new)
        return self.norm(x), ConformerStreamingState(layers=tuple(new_states))


class ConformerDecoderLayer(nn.Module):
    """Cross-attention Conformer decoder layer: half-FFN, cross-attention
    over the encoder memory, causal convolution module, half-FFN + norm."""

    def __init__(self, d_model: int, d_ffn: int, nhead: int, kernel_size: int = 3,
                 dropout_rate: float = 0.0, causal: bool = True,
                 attention_type: str = "regularMHA", activation: str = "swish"):
        super().__init__()
        self.attention_type = attention_type
        if attention_type == "regularMHA":
            self.mha_layer = MultiheadAttention(d_model, nhead, dropout_rate)
        elif attention_type == "RelPosMHAXL":
            self.mha_layer = RelPosMHAXL(d_model, nhead, dropout_rate, mask_pos_future=causal)
        else:
            raise ValueError(f"ConformerDecoder supports regularMHA/RelPosMHAXL, got "
                             f"{attention_type!r}")
        self.convolution_module = ConvolutionModule(d_model, kernel_size, activation,
                                                    dropout_rate, causal)
        self.ffn1 = PositionalwiseFeedForward(d_ffn, d_model, dropout_rate, activation)
        self.ffn2 = PositionalwiseFeedForward(d_ffn, d_model, dropout_rate, activation)
        for name in ("norm_ffn1", "norm_ffn2", "norm1", "norm2"):
            self.add_module(name, LayerNorm(d_model, eps=1e-5))
        self.dropout = Dropout(dropout_rate)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                memory_mask: Optional[torch.Tensor] = None,
                memory_pad_mask: Optional[torch.Tensor] = None,
                pos_embs_src: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = tgt + 0.5 * self.dropout(self.ffn1(self.norm_ffn1(tgt)))
        extra = {"pos_embs": pos_embs_src} if self.attention_type == "RelPosMHAXL" else {}
        x = self.mha_layer(self.norm1(x), memory, memory, attn_mask=memory_mask,
                           pad_mask=memory_pad_mask, **extra) + x
        x = x + self.convolution_module(x)
        return self.norm2(x + 0.5 * self.dropout(self.ffn2(self.norm_ffn2(x))))


class ConformerDecoder(nn.Module):
    """Stack of `ConformerDecoderLayer`s (`layer_0` ...) + final `norm`."""

    def __init__(self, num_layers: int, d_model: int, d_ffn: int, nhead: int,
                 kernel_size: int = 3, dropout_rate: float = 0.0, causal: bool = True,
                 attention_type: str = "regularMHA", activation: str = "swish"):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", ConformerDecoderLayer(
                d_model, d_ffn, nhead, kernel_size, dropout_rate, causal, attention_type,
                activation))
        self.norm = LayerNorm(d_model, eps=1e-6)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                memory_mask: Optional[torch.Tensor] = None,
                memory_pad_mask: Optional[torch.Tensor] = None,
                pos_embs_src: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            tgt = getattr(self, f"layer_{i}")(tgt, memory, memory_mask, memory_pad_mask,
                                              pos_embs_src)
        return self.norm(tgt)

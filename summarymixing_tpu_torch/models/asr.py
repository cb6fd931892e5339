"""Encoder-only `TransformerASR` — the port of the parts of
`summarymixing_tpu/models/asr.py` that greedy CTC decoding runs:
`_src_masks` (non-causal, no Dynamic Chunk Training), `_encode_inner`,
`encode`, and `forward` with no decoder. The attention decoder, the
conformer/transformer encoders and streaming are still to port.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from summarymixing_tpu_torch.models.branchformer import BranchformerEncoder
from summarymixing_tpu_torch.ops.masks import rel_length_to_mask
from summarymixing_tpu_torch.ops.positional import positional_encoding

_TODO = "see ROADMAP.md, 'Modules still to port'"


class TransformerASR(nn.Module):
    def __init__(self, tgt_vocab: int, input_size: int, d_model: int = 512, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 0,
                 positional_encoding: Optional[str] = "fixed_abs_sine", kernel_size: int = 31,
                 encoder_module: str = "branchformer", attention_type: str = "SummaryMixing",
                 causal: bool = False, csgu_linear_units: int = 3072,
                 gate_activation: Optional[str] = None, use_linear_after_conv: bool = False,
                 local_proj_hid_dim: Sequence[int] = (512,), local_proj_out_dim: int = 512,
                 summary_hid_dim: Sequence[int] = (1024,), summary_out_dim: int = 1024,
                 mode: str = "SummaryMixing", branchformer_activation: str = "gelu_exact"):
        super().__init__()
        if num_decoder_layers:
            raise NotImplementedError(f"the attention decoder is not ported; {_TODO}")
        if encoder_module != "branchformer":
            raise NotImplementedError(f"encoder {encoder_module!r} is not ported; {_TODO}")
        if causal:
            raise NotImplementedError(f"the causal encoder is not ported; {_TODO}")
        self.tgt_vocab = tgt_vocab
        self.d_model = d_model
        self.num_decoder_layers = num_decoder_layers
        self.positional_encoding = positional_encoding
        self.attention_type = attention_type
        self.src_proj = nn.Linear(input_size, d_model)
        self.encoder = BranchformerEncoder(
            num_encoder_layers, d_model, nhead, kernel_size=kernel_size,
            attention_type=attention_type, csgu_linear_units=csgu_linear_units,
            gate_activation=gate_activation, use_linear_after_conv=use_linear_after_conv,
            local_proj_hid_dim=local_proj_hid_dim, local_proj_out_dim=local_proj_out_dim,
            summary_hid_dim=summary_hid_dim, summary_out_dim=summary_out_dim, mode=mode,
            activation=branchformer_activation)

    def _src_masks(self, t: int, wav_len: Optional[torch.Tensor]):
        pad_mask = None if wav_len is None else rel_length_to_mask(wav_len, t)
        return pad_mask, None

    def _encode_inner(self, src: torch.Tensor, pad_mask: Optional[torch.Tensor],
                      src_mask: Optional[torch.Tensor]) -> torch.Tensor:
        if src.dim() == 4:
            b, t, f, c = src.shape
            src = src.reshape(b, t, f * c)
        t = src.shape[1]
        src = self.src_proj(src)
        if self.positional_encoding == "fixed_abs_sine" and self.attention_type != "hypermixing":
            src = src + positional_encoding(t, self.d_model, src.dtype, src.device)
        return self.encoder(src, src_mask, pad_mask)

    def forward(self, src: torch.Tensor, tgt: Optional[torch.Tensor] = None,
                wav_len: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, None]:
        """src `[B, T, F]` (or `[B, T, F, C]`); wav_len `[B]` relative lengths.
        Returns `(enc_out, None)`: there is no decoder."""
        return self.encode(src, wav_len), None

    def encode(self, src: torch.Tensor, wav_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        pad_mask, src_mask = self._src_masks(src.shape[1], wav_len)
        return self._encode_inner(src, pad_mask, src_mask)

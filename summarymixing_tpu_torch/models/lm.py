"""Language models for shallow fusion — the port of `TransformerLM` and
`build_lm` from `summarymixing_tpu/models/lm.py`.

`TransformerLM`: NormalizedEmbedding -> + sine positions -> a causal
`TransformerEncoder` (post-LN by default, erf-GELU) -> the head, either
one Dense (`"linear"`) or SpeechBrain's Linear -> LayerNorm(eps 1e-6) ->
Linear (`"sb"`, the head of converted published LM checkpoints). It
computes in float32: the JAX recipes build it with no compute dtype.
`init_cache`/`step` score one token per row against a float32 KV cache.

`RNNLM` belongs to the transducer recipes (slice 4) and is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from summarymixing_tpu_torch.models.transformer import NormalizedEmbedding, TransformerEncoder
from summarymixing_tpu_torch.ops.layers import Dense, LayerNorm
from summarymixing_tpu_torch.ops.masks import lookahead_mask
from summarymixing_tpu_torch.ops.positional import positional_encoding, positional_row


class TransformerLM(nn.Module):
    def __init__(self, vocab: int, d_model: int = 768, nhead: int = 12, num_layers: int = 12,
                 d_ffn: int = 3072, dropout_rate: float = 0.0, activation: str = "gelu_exact",
                 normalize_before: bool = False, output_proj: str = "linear"):
        super().__init__()
        if output_proj not in ("linear", "sb"):
            raise ValueError(f"unknown output_proj {output_proj!r}")
        self.d_model = d_model
        self.output_proj = output_proj
        self.emb = NormalizedEmbedding(d_model, vocab)
        self.encoder = TransformerEncoder(num_layers, d_model, d_ffn, nhead, dropout_rate,
                                          activation, normalize_before, "regularMHA")
        if output_proj == "sb":
            self.out_proj = Dense(d_model, d_model)
            self.out_norm = LayerNorm(d_model, eps=1e-6)
        self.out = Dense(d_model, vocab)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        if self.output_proj == "sb":
            x = self.out_norm(self.out_proj(x))
        return self.out(x)

    def forward(self, tokens: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens `[B, U]` -> next-token logits `[B, U, vocab]`."""
        u = tokens.shape[1]
        x = self.emb(tokens)
        x = x + positional_encoding(u, self.d_model, x.dtype, x.device)
        x = self.encoder(x, src_mask=lookahead_mask(u, device=x.device), pad_mask=pad_mask)
        return self._head(x)

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32) -> list:
        return self.encoder.init_cache(batch, max_len, dtype, self.out.weight.device)

    def step(self, tok_t: torch.Tensor, pos: int, cache: list):
        """tok_t `[B]` at position `pos` -> (logits `[B, vocab]`, cache)."""
        x = self.emb(tok_t)
        x = x + positional_row(pos, self.d_model, x.dtype, x.device)
        h, cache = self.encoder.step(x, pos, cache)
        return self._head(h), cache


def build_lm(lm_cfg, vocab: int) -> TransformerLM:
    """`LMConfig` -> the LM module (parameters not drawn; see
    `config.build_lm` for a seeded model on a device)."""
    if lm_cfg.model_type == "transformer":
        return TransformerLM(vocab=vocab, d_model=lm_cfg.d_model, nhead=lm_cfg.nhead,
                             num_layers=lm_cfg.num_layers, d_ffn=lm_cfg.d_ffn,
                             dropout_rate=lm_cfg.dropout, output_proj=lm_cfg.output_proj)
    if lm_cfg.model_type == "rnn":
        raise NotImplementedError("RNNLM (the transducer recipes' LM) is not ported; "
                                  "see ROADMAP.md")
    raise ValueError(f"unknown lm model_type {lm_cfg.model_type!r}")

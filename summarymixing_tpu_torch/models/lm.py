"""Language models for shallow fusion — the port of `TransformerLM`, `RNNLM`
and `build_lm` from `summarymixing_tpu/models/lm.py`.

`TransformerLM`: NormalizedEmbedding -> + sine positions -> a causal
`TransformerEncoder` (post-LN by default, erf-GELU) -> the head, either
one Dense (`"linear"`) or SpeechBrain's Linear -> LayerNorm(eps 1e-6) ->
Linear (`"sb"`, the head of converted published LM checkpoints). It
computes in float32: the JAX recipes build it with no compute dtype.
`init_cache`/`step` score one token per row against a float32 KV cache.

`RNNLM` (the transducer recipes' LM): an embedding -> `rnn_layers` LSTM
cells (flax's `OptimizedLSTMCell`, `models.transducer.LSTMCell`), each
followed by dropout -> `dnn` with leaky-ReLU (slope 0.01) and dropout ->
`out`, in float32. Its cells carry the flax names `lstm_0`, `lstm_1`, ...,
so `utils.convert.load_jax_params` fills it from the flax tree. `step`
scores one token per row from an explicit carry, a list of per-layer
`(c, h)` pairs, for fusion in the transducer's beam search.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from summarymixing_tpu_torch.models.transformer import NormalizedEmbedding, TransformerEncoder
from summarymixing_tpu_torch.models.transducer import Carry, LSTMCell
from summarymixing_tpu_torch.ops.layers import Dense, Dropout, LayerNorm
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


class RNNLM(nn.Module):
    def __init__(self, vocab: int, embedding_dim: int = 128, rnn_layers: int = 2,
                 rnn_neurons: int = 2048, dnn_neurons: int = 512, dropout_rate: float = 0.0):
        super().__init__()
        self.rnn_layers = rnn_layers
        self.emb = nn.Embedding(vocab, embedding_dim)
        for i in range(rnn_layers):
            self.add_module(f"lstm_{i}", LSTMCell(embedding_dim if i == 0 else rnn_neurons,
                                                  rnn_neurons))
        self.dnn = Dense(rnn_neurons, dnn_neurons)
        self.out = Dense(dnn_neurons, vocab)
        self.drop = Dropout(dropout_rate)

    def cells(self) -> List[LSTMCell]:
        return [getattr(self, f"lstm_{i}") for i in range(self.rnn_layers)]

    def initial_state(self, batch: int) -> List[Carry]:
        """Zeros of width `rnn_neurons` for every layer."""
        return [cell.initial_state(batch) for cell in self.cells()]

    def step(self, carry: List[Carry], token: torch.Tensor) -> Tuple[List[Carry], torch.Tensor]:
        """token `[B]` -> (carry', logits `[B, vocab]`)."""
        x = self.emb(token.long())
        new_carry = []
        for cell, c in zip(self.cells(), carry):
            c, x = cell(c, x)
            x = self.drop(x)
            new_carry.append(c)
        x = self.drop(F.leaky_relu(self.dnn(x), 0.01))
        return new_carry, self.out(x)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens `[B, U]` -> next-token logits `[B, U, vocab]`, one step per
        position."""
        carry = self.initial_state(tokens.shape[0])
        logits = []
        for u in range(tokens.shape[1]):
            carry, y = self.step(carry, tokens[:, u])
            logits.append(y)
        return torch.stack(logits, dim=1)


def build_lm(lm_cfg, vocab: int) -> nn.Module:
    """`LMConfig` -> the LM module (parameters not drawn; see
    `config.build_lm` for a seeded model on a device)."""
    if lm_cfg.model_type == "transformer":
        return TransformerLM(vocab=vocab, d_model=lm_cfg.d_model, nhead=lm_cfg.nhead,
                             num_layers=lm_cfg.num_layers, d_ffn=lm_cfg.d_ffn,
                             dropout_rate=lm_cfg.dropout, output_proj=lm_cfg.output_proj)
    if lm_cfg.model_type == "rnn":
        return RNNLM(vocab=vocab, embedding_dim=lm_cfg.embedding_dim,
                     rnn_layers=lm_cfg.rnn_layers, rnn_neurons=lm_cfg.rnn_neurons,
                     dnn_neurons=lm_cfg.dnn_neurons, dropout_rate=lm_cfg.dropout)
    raise ValueError(f"unknown lm model_type {lm_cfg.model_type!r}")

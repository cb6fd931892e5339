"""Transducer (RNN-T) model — the port of `summarymixing_tpu/models/transducer.py`:
the one-hot prediction-network input with the blank column removed, the
1-layer LSTM predictor, the sum (or concat) joint, and the model graph
with its CTC and CE auxiliary heads and the pieces greedy search calls.

Like the flax modules (which have no `dtype`), it computes in float32: an
encoder output in bf16 is cast to float32 before `proj_enc`, where flax
promotes it. The LSTM keeps flax's carry order `(c, h)` and its gate order
i, f, g, o; the input-side products have no bias (`utils.convert` stacks
the flax cell's eight Dense leaves into `weight_ih`, `weight_hh`, `bias`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from summarymixing_tpu_torch.ops.layers import Dense, Dropout
from summarymixing_tpu_torch.ops.linear import get_activation
from summarymixing_tpu_torch.utils.init import lecun_normal_

Carry = Tuple[torch.Tensor, torch.Tensor]


def one_hot_no_blank(tokens: torch.Tensor, vocab: int, blank_id: int = 0) -> torch.Tensor:
    """`[..]` int tokens -> `[.., vocab - 1]` float32 one-hot without the
    blank column: the blank token's row is all zeros."""
    oh = F.one_hot(tokens.long(), vocab).to(torch.float32)
    return torch.cat([oh[..., :blank_id], oh[..., blank_id + 1:]], dim=-1)


class LSTMCell(nn.Module):
    """flax's `OptimizedLSTMCell`: gates = x·W_iᵀ + (h·W_hᵀ + b), split i, f,
    g, o; c' = σ(f)·c + σ(i)·tanh(g); h' = σ(o)·tanh(c'). Carry `(c, h)`.
    Drawn as flax draws it: the input kernels `lecun_normal`, each gate's
    H×H recurrent kernel orthogonal, the biases zero."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden_size, input_size))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden_size, hidden_size))
        self.bias = nn.Parameter(torch.empty(4 * hidden_size))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        h = self.hidden_size
        lecun_normal_(self.weight_ih, self.weight_ih.shape[1], generator)
        with torch.no_grad():
            for g in range(4):
                nn.init.orthogonal_(self.weight_hh[g * h:(g + 1) * h], generator=generator)
        nn.init.zeros_(self.bias)

    def initial_state(self, batch: int) -> Carry:
        z = torch.zeros(batch, self.hidden_size, dtype=self.bias.dtype, device=self.bias.device)
        return z, z.clone()

    def forward(self, carry: Carry, x: torch.Tensor) -> Tuple[Carry, torch.Tensor]:
        c, h = carry
        gates = F.linear(h, self.weight_hh, self.bias) + F.linear(x, self.weight_ih)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h


class TransducerPredictor(nn.Module):
    """Prediction network: one-hot embedding -> 1-layer LSTM -> `proj_dec`."""

    def __init__(self, vocab: int, dec_dim: int = 512, joint_dim: int = 640, blank_id: int = 0,
                 emb_dropout: float = 0.2, dropout: float = 0.1):
        super().__init__()
        self.vocab, self.blank_id = vocab, blank_id
        self.lstm = LSTMCell(vocab - 1, dec_dim)
        self.proj_dec = Dense(dec_dim, joint_dim, bias=False)
        self.emb_drop = Dropout(emb_dropout)
        self.out_drop = Dropout(dropout)

    def initial_state(self, batch: int) -> Carry:
        return self.lstm.initial_state(batch)

    def step(self, carry: Carry, token: torch.Tensor) -> Tuple[Carry, torch.Tensor]:
        """token `[B]` -> (carry', proj `[B, joint_dim]`)."""
        carry, h = self.lstm(carry, one_hot_no_blank(token, self.vocab, self.blank_id))
        return carry, self.proj_dec(h)

    def forward(self, tokens_bos: torch.Tensor) -> torch.Tensor:
        """tokens_bos `[B, U+1]` (blank-prefixed targets) -> `[B, U+1, joint_dim]`."""
        x = self.emb_drop(one_hot_no_blank(tokens_bos, self.vocab, self.blank_id))
        carry = self.initial_state(x.shape[0])
        hs = []
        for u in range(x.shape[1]):
            carry, h = self.lstm(carry, x[:, u])
            hs.append(h)
        return self.proj_dec(self.out_drop(torch.stack(hs, dim=1)))


class TransducerJoint(nn.Module):
    """joint "sum": act(enc + dec); "concat": act([enc, dec]); then
    `transducer_lin` to the vocabulary (no bias)."""

    def __init__(self, joint_dim: int, vocab: int, activation: str = "gelu_exact",
                 joint: str = "sum"):
        super().__init__()
        if joint not in ("sum", "concat"):
            raise ValueError(f"joint must be sum|concat, got {joint!r}")
        self.joint = joint
        self._act = get_activation(activation)
        width = joint_dim if joint == "sum" else 2 * joint_dim
        self.transducer_lin = Dense(width, vocab, bias=False)

    def _combine(self, enc: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
        if self.joint == "sum":
            return self._act(enc + dec)
        shape = torch.broadcast_shapes(enc.shape, dec.shape)
        return self._act(torch.cat([enc.expand(shape), dec.expand(shape)], dim=-1))

    def forward(self, enc_proj: torch.Tensor, dec_proj: torch.Tensor) -> torch.Tensor:
        """enc_proj `[B, T, J]`, dec_proj `[B, U+1, J]` -> logits `[B, T, U+1, V]`."""
        return self.transducer_lin(self._combine(enc_proj[:, :, None], dec_proj[:, None]))

    def step(self, enc_frame: torch.Tensor, dec_step: torch.Tensor) -> torch.Tensor:
        """enc_frame `[B, J]`, dec_step `[B, J]` -> logits `[B, V]`."""
        return self.transducer_lin(self._combine(enc_frame, dec_step))


class TransducerModel(nn.Module):
    """`proj_enc` + predictor + joint over encoder outputs, with the CTC
    head (`proj_ctc` over `proj_enc`) and the CE head (`dec_lin`)."""

    def __init__(self, vocab: int, enc_dim: int = 512, dec_dim: int = 512,
                 joint_dim: int = 640, joint_type: str = "sum", blank_id: int = 0,
                 activation: str = "gelu_exact", emb_dropout: float = 0.2,
                 dec_dropout: float = 0.1):
        super().__init__()
        self.blank_id = blank_id
        self.proj_enc = Dense(enc_dim, joint_dim, bias=False)
        self.predictor = TransducerPredictor(vocab, dec_dim, joint_dim, blank_id, emb_dropout,
                                             dec_dropout)
        self.joint = TransducerJoint(joint_dim, vocab, activation, joint_type)
        self.proj_ctc = Dense(joint_dim, vocab)
        self.dec_lin = Dense(joint_dim, vocab, bias=False)

    def encode_proj(self, enc_out: torch.Tensor) -> torch.Tensor:
        return self.proj_enc(enc_out.to(self.proj_enc.weight.dtype))

    def ce_from_dec(self, dec_proj: torch.Tensor) -> torch.Tensor:
        """Next-token log-probs `[B, U+1, V]` from a predictor output."""
        return F.log_softmax(self.dec_lin(dec_proj), dim=-1)

    def ctc_head(self, enc_out: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(self.proj_ctc(self.encode_proj(enc_out)), dim=-1)

    # pieces for search
    def predictor_init(self, batch: int) -> Carry:
        return self.predictor.initial_state(batch)

    def predictor_step(self, carry: Carry, token: torch.Tensor):
        return self.predictor.step(carry, token)

    def joint_step(self, enc_frame: torch.Tensor, dec_step: torch.Tensor) -> torch.Tensor:
        return self.joint.step(enc_frame, dec_step)

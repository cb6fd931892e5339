"""The recognizer graph without a decoder — the port of
`summarymixing_tpu/models/speech_recognizer.py`: CNN frontend ->
`TransformerASR` encoder -> CTC head."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from summarymixing_tpu_torch.models.asr import TransformerASR
from summarymixing_tpu_torch.ops.convolution import ConvolutionFrontEnd


class SpeechRecognizer(nn.Module):
    """features `[B, T, n_mels]` -> dict with `ctc_log_probs` `[B, T', V]`.

    The model computes in the dtype of its weights (`model.to(torch.bfloat16)`
    for the card); the CTC log-softmax is taken in float32."""

    def __init__(self, asr: TransformerASR, vocab_size: int,
                 frontend_channels: Sequence[int] = (64, 32),
                 frontend_strides: Sequence[int] = (2, 2)):
        super().__init__()
        self.frontend_strides = tuple(frontend_strides)
        self.cnn = ConvolutionFrontEnd(out_channels=tuple(frontend_channels),
                                       strides=self.frontend_strides)
        self.asr = asr
        self.ctc_lin = nn.Linear(asr.d_model, vocab_size)

    def subsampled_length(self, feat_lengths: torch.Tensor) -> torch.Tensor:
        return ConvolutionFrontEnd.subsampled_length(feat_lengths, self.frontend_strides)

    def forward(self, feats: torch.Tensor, feat_lengths: torch.Tensor) -> dict:
        """feats `[B, T, F]`; feat_lengths `[B]` absolute frame counts."""
        enc_out, out_len = self.encode(feats, feat_lengths)
        return {"enc_out": enc_out, "enc_lengths": out_len,
                "ctc_log_probs": self.ctc_head(enc_out),
                "dec_out": None, "seq_log_probs": None}

    def encode(self, feats: torch.Tensor,
               feat_lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.cnn(feats)
        out_len = self.subsampled_length(feat_lengths)
        wav_len_rel = out_len.to(torch.float32) / x.shape[1]
        return self.asr.encode(x, wav_len_rel), out_len

    def ctc_head(self, enc_out: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(self.ctc_lin(enc_out).to(torch.float32), dim=-1)

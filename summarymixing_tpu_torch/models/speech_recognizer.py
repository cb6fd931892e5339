"""The recognizer graph — the port of
`summarymixing_tpu/models/speech_recognizer.py`: CNN frontend ->
`TransformerASR` -> CTC head, and the attention decoder's head
(`seq_lin`) when the model has a decoder, with the decoder's search steps
(`decode_position`, `decode_cache_init`, `decode_step_cached`) and the
Conformer's chunked streaming (`frontend`, `streaming_init`,
`encode_streaming_chunk`)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from summarymixing_tpu_torch.models.asr import (
    ASRStreamingState,
    DynChunkTrainConfig,
    TransformerASR,
)
from summarymixing_tpu_torch.ops.convolution import ConvolutionFrontEnd
from summarymixing_tpu_torch.ops.layers import Dense


class SpeechRecognizer(nn.Module):
    """features `[B, T, F]` -> dict with `ctc_log_probs` `[B, T', V]` and,
    given BOS-prefixed targets, `seq_log_probs` `[B, U, V]`.

    Parameters stay float32; the layers compute in their compute dtype
    (`ops.layers.set_compute_dtype`). Both log-softmaxes are taken in
    float32."""

    def __init__(self, asr: TransformerASR, vocab_size: int,
                 frontend_channels: Sequence[int] = (64, 32),
                 frontend_strides: Sequence[int] = (2, 2), frontend_dropout: float = 0.0):
        super().__init__()
        self.frontend_strides = tuple(frontend_strides)
        self.cnn = ConvolutionFrontEnd(out_channels=tuple(frontend_channels),
                                       strides=self.frontend_strides,
                                       dropout_rate=frontend_dropout)
        self.asr = asr
        self.ctc_lin = Dense(asr.d_model, vocab_size)
        if asr.num_decoder_layers > 0:
            self.seq_lin = Dense(asr.d_model, vocab_size)

    def subsampled_length(self, feat_lengths: torch.Tensor) -> torch.Tensor:
        return ConvolutionFrontEnd.subsampled_length(feat_lengths, self.frontend_strides)

    def forward(self, feats: torch.Tensor, feat_lengths: torch.Tensor,
                tokens_bos: Optional[torch.Tensor] = None, pad_idx: int = 0) -> dict:
        """feats `[B, T, F]`; feat_lengths `[B]` absolute frame counts;
        tokens_bos `[B, U]` targets with BOS first, or None."""
        x = self.cnn(feats)
        out_len = self.subsampled_length(feat_lengths)
        wav_len_rel = out_len.to(torch.float32) / x.shape[1]
        enc_out, dec_out = self.asr(x, tokens_bos, wav_len_rel, pad_idx)
        seq_log_probs = None
        if dec_out is not None:
            seq_log_probs = F.log_softmax(self.seq_lin(dec_out).to(torch.float32), dim=-1)
        return {"enc_out": enc_out, "enc_lengths": out_len,
                "ctc_log_probs": self.ctc_head(enc_out),
                "dec_out": dec_out, "seq_log_probs": seq_log_probs}

    def encode(self, feats: torch.Tensor, feat_lengths: torch.Tensor,
               dynchunktrain: Optional[DynChunkTrainConfig] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.cnn(feats)
        out_len = self.subsampled_length(feat_lengths)
        wav_len_rel = out_len.to(torch.float32) / x.shape[1]
        return self.asr.encode(x, wav_len_rel, dynchunktrain), out_len

    # -- chunked streaming ---------------------------------------------------
    def frontend(self, feats: torch.Tensor, input_frame_offset=None,
                 input_frame_count=None) -> torch.Tensor:
        """The CNN alone: `[B, T, F]` -> `[B, T/4, F']` encoder input;
        `input_frame_offset` makes a chunk's stream-start zero padding exact,
        and `input_frame_count` a window's zero padding at the stream's end
        (`ops.convolution.ConvolutionFrontEnd`)."""
        return self.cnn(feats, input_frame_offset, input_frame_count)

    def streaming_init(self, batch: int, dynchunk: DynChunkTrainConfig,
                       dtype: torch.dtype = torch.float32) -> ASRStreamingState:
        return self.asr.init_streaming_state(batch, dynchunk, dtype)

    def encode_streaming_chunk(self, src_chunk: torch.Tensor, state: ASRStreamingState):
        """One chunk of CNN output frames -> (encoder chunk, next state)."""
        return self.asr.encode_streaming(src_chunk, state)

    def ctc_head(self, enc_out: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(self.ctc_lin(enc_out).to(torch.float32), dim=-1)

    def decode_position(self, tgt: torch.Tensor, enc_out: torch.Tensor, enc_len: torch.Tensor,
                        pos: int) -> torch.Tensor:
        """Next-token log-probs `[B, V]` at position `pos` of a (padded)
        BOS-first prefix, from the whole prefix: the uncached oracle of
        `decode_step_cached` (causality makes positions past `pos`
        irrelevant)."""
        dec = self.asr.decode_prefix(tgt, enc_out, enc_len)
        return F.log_softmax(self.seq_lin(dec[:, pos]).to(torch.float32), dim=-1)

    def decode_cache_init(self, enc_out: torch.Tensor, max_len: int,
                          rows: Optional[int] = None) -> list:
        return self.asr.decode_cache_init(enc_out, max_len, rows)

    def decode_step_cached(self, tok_t: torch.Tensor, pos: int, cache: list,
                           enc_pad_mask: Optional[torch.Tensor] = None):
        """KV-cached step: tok_t `[N]` -> (log-probs `[N, V]`, cache)."""
        h, cache = self.asr.decode_step_cached(tok_t, pos, cache, enc_pad_mask)
        return F.log_softmax(self.seq_lin(h).to(torch.float32), dim=-1), cache

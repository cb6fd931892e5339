"""`TransformerASR` with the Transformer, Conformer or Branchformer encoder —
the port of `summarymixing_tpu/models/asr.py`: `_src_masks` (the lookahead
mask of a causal encoder, or the Dynamic Chunk Training mask for the
Conformer), `_encode_inner` with the source dropout and the positions (the
absolute sine, none for hypermixing, RelPosMHAXL's relative table), `encode`,
the target embedding and the attention
decoder (`_decode_inner`; regularMHA, or the paper's Summary Decoder with
`decoder_attention_type="SummaryMixing"`), `forward` with or without targets,
the decoder's search surface (`decode_prefix`, the uncached oracle, and
the cached `decode_cache_init`/`decode_step_cached`: KV caches, or the
Summary Decoder's running-mean carry), and the
Conformer's chunked streaming (`DynChunkTrainConfig`, `ASRStreamingState`,
`init_streaming_state`, `encode_streaming`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from summarymixing_tpu_torch.models.branchformer import BranchformerEncoder
from summarymixing_tpu_torch.models.conformer import ConformerEncoder, ConformerStreamingState
from summarymixing_tpu_torch.models.transformer import (
    NormalizedEmbedding,
    TransformerDecoder,
    TransformerEncoder,
)
from summarymixing_tpu_torch.ops import time_shard
from summarymixing_tpu_torch.ops.layers import Dense, Dropout
from summarymixing_tpu_torch.ops.masks import (
    chunked_context_mask,
    key_padding_mask_from_tokens,
    length_to_mask,
    lookahead_mask,
    rel_length_to_mask,
)
from summarymixing_tpu_torch.ops.positional import (
    positional_encoding,
    positional_row,
    relpos_xl_table,
)


@dataclass(frozen=True)
class DynChunkTrainConfig:
    """Dynamic Chunk Training: chunks of `chunk_size` encoder frames, and a
    left context of `left_context_size` chunks (None = unlimited)."""

    chunk_size: int
    left_context_size: Optional[int] = None

    def left_context_size_frames(self) -> int:
        if self.left_context_size is None:
            raise ValueError("infinite left context has no frame count")
        return self.left_context_size * self.chunk_size


@dataclass
class ASRStreamingState:
    """The carried state of chunked encoding: the Conformer's per-layer
    buffers, each row's absolute position of its next frame, and the chunk
    size the state was built for."""

    encoder: ConformerStreamingState
    frame_offset: torch.Tensor   # [B] int
    chunk_size: int


class TransformerASR(nn.Module):
    def __init__(self, tgt_vocab: int, input_size: int, d_model: int = 512, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 0, d_ffn: int = 2048,
                 dropout_rate: float = 0.0, activation: str = "gelu",
                 positional_encoding: Optional[str] = "fixed_abs_sine", kernel_size: int = 31,
                 normalize_before: bool = True,
                 encoder_module: str = "branchformer", attention_type: str = "SummaryMixing",
                 decoder_attention_type: str = "regularMHA",
                 causal: bool = False, csgu_linear_units: int = 3072,
                 gate_activation: Optional[str] = None, use_linear_after_conv: bool = False,
                 local_proj_hid_dim: Sequence[int] = (512,), local_proj_out_dim: int = 512,
                 summary_hid_dim: Sequence[int] = (1024,), summary_out_dim: int = 1024,
                 mode: str = "SummaryMixing", branchformer_activation: str = "gelu_exact",
                 conformer_activation: str = "swish", max_length: int = 2500,
                 remat: bool = False, act_int8: bool = False):
        super().__init__()
        if decoder_attention_type not in ("regularMHA", "vanillaMHA", "SummaryMixing"):
            # RelPosMHAXL needs position tables the decode paths do not
            # build, and its rel-shift is square attention only
            raise ValueError(
                "decoder_attention_type must be regularMHA (the reference, "
                "Transformer.py:274) or SummaryMixing (the paper's Summary "
                f"Decoder); got {decoder_attention_type!r}")
        self.tgt_vocab = tgt_vocab
        self.d_model = d_model
        self.num_decoder_layers = num_decoder_layers
        self.positional_encoding = positional_encoding
        self.attention_type = attention_type
        self.encoder_module = encoder_module
        self.causal = causal
        self.max_length = max_length
        self.src_proj = Dense(input_size, d_model)
        self.src_dropout = Dropout(dropout_rate)
        if encoder_module == "transformer":
            self.encoder = TransformerEncoder(
                num_encoder_layers, d_model, d_ffn, nhead, dropout_rate, activation,
                normalize_before, attention_type, remat=remat, causal=causal,
                local_proj_hid_dim=local_proj_hid_dim, local_proj_out_dim=local_proj_out_dim,
                summary_hid_dim=summary_hid_dim, mode=mode)
        elif encoder_module == "conformer":
            self.encoder = ConformerEncoder(
                num_encoder_layers, d_model, d_ffn, nhead, kernel_size=kernel_size,
                dropout_rate=dropout_rate, causal=causal, attention_type=attention_type,
                local_proj_hid_dim=local_proj_hid_dim, local_proj_out_dim=local_proj_out_dim,
                summary_hid_dim=summary_hid_dim, mode=mode, activation=conformer_activation,
                remat=remat)
        elif encoder_module == "branchformer":
            self.encoder = BranchformerEncoder(
                num_encoder_layers, d_model, nhead, kernel_size=kernel_size,
                attention_type=attention_type, csgu_linear_units=csgu_linear_units,
                gate_activation=gate_activation, use_linear_after_conv=use_linear_after_conv,
                local_proj_hid_dim=local_proj_hid_dim, local_proj_out_dim=local_proj_out_dim,
                summary_hid_dim=summary_hid_dim, summary_out_dim=summary_out_dim, mode=mode,
                activation=branchformer_activation, dropout_rate=dropout_rate, remat=remat,
                act_int8=act_int8)
        else:
            raise ValueError(f"unknown encoder_module {encoder_module!r}")
        if num_decoder_layers > 0:
            self.tgt_emb = NormalizedEmbedding(d_model, tgt_vocab)
            # the Summary Decoder's cell: the encoder's hidden widths, its
            # outputs at d_model, and the full mode for lite (a causal
            # summary needs the sum_mask path lite does not have)
            self.decoder = TransformerDecoder(
                num_decoder_layers, d_model, d_ffn, nhead, dropout_rate, activation,
                normalize_before, decoder_attention_type,
                local_proj_hid_dim=local_proj_hid_dim, local_proj_out_dim=d_model,
                summary_hid_dim=summary_hid_dim,
                mode="SummaryMixing" if mode == "SummaryMixing-lite" else mode)

    def _src_masks(self, t: int, wav_len: Optional[torch.Tensor],
                   dynchunktrain: Optional[DynChunkTrainConfig], device):
        """(pad mask `[B, t]` or None, attention mask or None). In a
        time-sharded encode `t` is the shard's; the pad mask is this
        shard's frames of the whole T' one (`parallel/sequence.py`)."""
        shard = time_shard.current()
        if shard is not None:
            if dynchunktrain is not None or self.causal or wav_len is None:
                raise NotImplementedError("a time-sharded encode is offline, not causal, and "
                                          "takes relative lengths")
            return shard.set_pad(rel_length_to_mask(wav_len, shard.frames)), None
        pad_mask = None if wav_len is None else rel_length_to_mask(wav_len, t)
        src_mask = None
        if dynchunktrain is not None:
            if self.causal:
                raise ValueError("dynchunktrain is incompatible with causal")
            if self.encoder_module != "conformer":
                raise ValueError("Dynamic Chunk Training requires encoder_module='conformer', "
                                 f"got {self.encoder_module!r}")
            src_mask = chunked_context_mask(t, dynchunktrain.chunk_size,
                                            dynchunktrain.left_context_size, device=device)
        elif self.causal:
            src_mask = lookahead_mask(t, device=device)
        return pad_mask, src_mask

    def _encode_inner(self, src: torch.Tensor, pad_mask: Optional[torch.Tensor],
                      src_mask: Optional[torch.Tensor], chunk_size=None) -> torch.Tensor:
        if src.dim() == 4:
            b, t, f, c = src.shape
            src = src.reshape(b, t, f * c)
        t = src.shape[1]
        src = self.src_dropout(self.src_proj(src))
        pos_embs = None
        if self.attention_type == "RelPosMHAXL":
            pos_embs = relpos_xl_table(t, self.d_model, src.dtype, src.device)
        elif (self.positional_encoding == "fixed_abs_sine"
              and self.attention_type != "hypermixing"):
            shard = time_shard.current()
            if shard is None:
                src = src + positional_encoding(t, self.d_model, src.dtype, src.device)
            else:   # the rows of the whole table at this shard's frames
                pos = shard.start + torch.arange(t, device=src.device)
                src = src + positional_row(pos, self.d_model, src.dtype)[None]
        if self.encoder_module == "conformer":
            return self.encoder(src, src_mask, pad_mask, pos_embs, chunk_size)
        return self.encoder(src, src_mask, pad_mask, pos_embs)

    def _decode_inner(self, tgt: torch.Tensor, enc_out: torch.Tensor,
                      enc_pad_mask: Optional[torch.Tensor],
                      tgt_pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
        u = tgt.shape[1]
        x = self.tgt_emb(tgt)
        x = x + positional_encoding(u, self.d_model, x.dtype, x.device)
        return self.decoder(x, enc_out, tgt_mask=lookahead_mask(u, device=x.device),
                            tgt_pad_mask=tgt_pad_mask, memory_pad_mask=enc_pad_mask)

    def forward(self, src: torch.Tensor, tgt: Optional[torch.Tensor] = None,
                wav_len: Optional[torch.Tensor] = None,
                pad_idx: int = 0) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """src `[B, T, F]` (or `[B, T, F, C]`); tgt `[B, U]` int tokens (BOS
        first); wav_len `[B]` relative lengths. Returns `(enc_out, dec_out)`,
        `dec_out` None without targets or decoder."""
        pad_mask, src_mask = self._src_masks(src.shape[1], wav_len, None, src.device)
        enc_out = self._encode_inner(src, pad_mask, src_mask)
        if tgt is None or self.num_decoder_layers == 0:
            return enc_out, None
        tgt_pad_mask = key_padding_mask_from_tokens(tgt, pad_idx)
        return enc_out, self._decode_inner(tgt, enc_out, pad_mask, tgt_pad_mask)

    def encode(self, src: torch.Tensor, wav_len: Optional[torch.Tensor] = None,
               dynchunktrain: Optional[DynChunkTrainConfig] = None) -> torch.Tensor:
        pad_mask, src_mask = self._src_masks(src.shape[1], wav_len, dynchunktrain, src.device)
        chunk = None if dynchunktrain is None else dynchunktrain.chunk_size
        return self._encode_inner(src, pad_mask, src_mask, chunk)

    # -- decoder search surface -------------------------------------------
    def decode_prefix(self, tgt: torch.Tensor, enc_out: torch.Tensor,
                      enc_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Decoder states `[B, U, D]` of a whole BOS-first prefix;
        `enc_len` `[B]` absolute encoder lengths."""
        enc_pad_mask = None if enc_len is None else length_to_mask(enc_len, enc_out.shape[1])
        return self._decode_inner(tgt, enc_out, enc_pad_mask, None)

    def decode_cache_init(self, enc_out: torch.Tensor, max_len: int,
                          rows: Optional[int] = None) -> list:
        """Per-layer decode caches: cross-attention K/V from the UNtiled
        `enc_out` `[B, T, D]` once, self-attention K/V at `rows` rows (B·beam
        under beam search)."""
        return self.decoder.init_cache(enc_out, max_len, rows)

    def decode_step_cached(self, tok_t: torch.Tensor, pos: int, cache: list,
                           enc_pad_mask: Optional[torch.Tensor] = None):
        """One token per row: tok_t `[N]` at position `pos` -> (hidden
        `[N, D]`, cache); `enc_pad_mask` `[B, T]`, 1 = valid."""
        x = self.tgt_emb(tok_t)
        x = x + positional_row(pos, self.d_model, x.dtype, x.device)
        return self.decoder.step(x, pos, cache, enc_pad_mask)

    # -- chunked streaming (the Conformer encoder) ---------------------------
    def init_streaming_state(self, batch: int, dynchunk: DynChunkTrainConfig,
                             dtype: torch.dtype = torch.float32, device=None) -> ASRStreamingState:
        """A blank state for chunks of `dynchunk.chunk_size` frames with a
        left context of `dynchunk.left_context_size` chunks, on the model's
        device unless `device` says otherwise."""
        if self.encoder_module != "conformer":
            raise ValueError("streaming requires encoder_module='conformer'")
        device = self.src_proj.weight.device if device is None else device
        left = dynchunk.left_context_size_frames()
        return ASRStreamingState(
            encoder=self.encoder.init_streaming_state(batch, left, dtype, device),
            frame_offset=torch.zeros(batch, dtype=torch.int32, device=device),
            chunk_size=int(dynchunk.chunk_size))

    def encode_streaming(self, src: torch.Tensor, state: ASRStreamingState
                         ) -> Tuple[torch.Tensor, ASRStreamingState]:
        """Encode one chunk `[B, C, F]` -> (`[B, C, D]`, next state). Positions
        are absolute from each row's `frame_offset`, clamped to the last
        window `[max_length - C, max_length)` of the sine table. The chunk
        length must be the state's `chunk_size`: any other breaks the
        equivalence with the Dynamic Chunk Training encoder."""
        if src.dim() == 4:
            b, t, f, c = src.shape
            src = src.reshape(b, t, f * c)
        chunk = src.shape[1]
        if chunk != state.chunk_size:
            raise ValueError(f"chunk length {chunk} != streaming state's chunk_size "
                             f"{state.chunk_size}: mixer context windows and DCConv "
                             "boundaries would no longer match DCT training")
        src = self.src_proj(src)
        if (self.positional_encoding == "fixed_abs_sine"
                and self.attention_type not in ("hypermixing", "RelPosMHAXL")):
            start = torch.clamp(state.frame_offset, 0, self.max_length - chunk)
            pos = start[:, None] + torch.arange(chunk, device=src.device)[None, :]
            src = src + positional_row(pos, self.d_model, src.dtype)
        pos_embs = None
        if self.attention_type == "RelPosMHAXL":
            total = chunk + state.encoder.layers[0].mha_left.shape[1]
            pos_embs = relpos_xl_table(total, self.d_model, src.dtype, src.device)
        out, enc_state = self.encoder.streaming_step(src, state.encoder, pos_embs)
        return out, ASRStreamingState(encoder=enc_state, frame_offset=state.frame_offset + chunk,
                                      chunk_size=state.chunk_size)


class EncoderASR(nn.Module):
    """Encoder-only wrapper whose forward is `asr.encode` (the reference's
    EncoderWrapper, TransformerASR.py:687-741)."""

    def __init__(self, asr: TransformerASR):
        super().__init__()
        self.asr = asr

    def forward(self, src: torch.Tensor, wav_len: Optional[torch.Tensor] = None,
                dynchunktrain: Optional[DynChunkTrainConfig] = None) -> torch.Tensor:
        return self.asr.encode(src, wav_len, dynchunktrain)


# the reference class name (TransformerASR.py:687)
EncoderWrapper = EncoderASR

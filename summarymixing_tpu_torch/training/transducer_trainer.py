"""Transducer training — the port of
`summarymixing_tpu/training/transducer_trainer.py` on one device:

    wav -> speed perturbation -> Fbank -> InputNormalization -> SpecAugment
    (from micro step `augment_warmup_steps` on) -> the Conformer encoder
    under a sampled Dynamic Chunk Training (DCT) configuration -> proj_enc;
    blank-prefixed targets -> the LSTM predictor -> the joint -> RNN-T loss
    (+ ctc_weight · CTC on proj_ctc while the epoch is below
    number_of_ctc_epochs, + ce_weight · NLL on dec_lin) -> backward -> the
    optimizer (AdamW or the two-stage Adam -> SGD, or `MultiSteps`
    accumulating k micro-batches), skipped on a non-finite loss or
    gradient norm.

The parameters are those of `trainer.model`, a `ModuleDict` of the
recognizer (`encoder`) and the `TransducerModel` (`transducer`), the JAX
trainer's `{"encoder": ..., "transducer": ...}` tree. Speed perturbation,
SpecAugment, the DCT draw and every dropout draw from the trainer's one
`torch.Generator` (the checkpoint keeps its state). The DCT draw is read
to the host once per step: the chunk size shapes the attention mask.
Data parallelism is `ASRTrainer`'s (`training/trainer.py`), with
`MultiSteps` reducing its accumulator once per optimizer step; the DCT
draw comes from the stream every process shares (`shared_generator`),
so the chunk configuration is the same on every process.
Speed perturbation runs inside `train_step`, as `ASRTrainer` runs it
(the JAX recipes apply it before calling theirs). Before the warm-up step
no augmentation is drawn (the JAX trainer draws one and discards it).

    optimizer = make_optimizer(schedule, accum_steps=4)
    trainer = TransducerTrainer(model, transducer, optimizer, fbank)
    state = trainer.init_state(seed=3407)
    state, metrics = trainer.train_step(state, batch)   # wav, wav_lens, tokens, token_lens
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from summarymixing_tpu_torch.frontend.augment import (
    SpecAugmentConfig,
    spec_augment,
    speed_perturb_batch,
)
from summarymixing_tpu_torch.frontend.features import InputNormalization, NormStats
from summarymixing_tpu_torch.losses import (
    ctc_loss,
    nll_loss,
    transducer_loss,
    transducer_loss_chunked,
)
from summarymixing_tpu_torch.models.asr import DynChunkTrainConfig
from summarymixing_tpu_torch.ops.layers import set_dropout_generator
from summarymixing_tpu_torch.parallel import comm
from summarymixing_tpu_torch.training.optim import synced_update
from summarymixing_tpu_torch.training.trainer import split_streams
from summarymixing_tpu_torch.utils.init import xavier_normal_overwrite


@dataclass(frozen=True)
class DynChunkTrainSamplerConfig:
    """The recipes' DCT sampler: chunked with probability `chunkwise_prob`,
    chunks of U[chunk_size_min, chunk_size_max] encoder frames, and then a
    left context of U[left_context_chunks_min, left_context_chunks_max]
    chunks with probability `limited_left_context_prob`."""

    chunkwise_prob: float = 0.6
    chunk_size_min: int = 8
    chunk_size_max: int = 32
    limited_left_context_prob: float = 0.75
    left_context_chunks_min: int = 2
    left_context_chunks_max: int = 32


def sample_dynchunk(generator: Optional[torch.Generator], max_frames: int,
                    cfg: DynChunkTrainSamplerConfig, device=None) -> DynChunkTrainConfig:
    """One DCT configuration from four uniform draws of `generator` (one
    host read). "No chunking" is `chunk_size = max_frames` (full context),
    and an unlimited left context `left_context_size = max_frames` chunks,
    as the JAX sampler encodes them; the left context is limited only when
    chunking."""
    r = torch.rand(4, generator=generator, device=device).tolist()
    use_chunks = r[0] < cfg.chunkwise_prob
    chunk = cfg.chunk_size_min + int(r[1] * (cfg.chunk_size_max - cfg.chunk_size_min + 1))
    limited = r[2] < cfg.limited_left_context_prob
    left = cfg.left_context_chunks_min + int(
        r[3] * (cfg.left_context_chunks_max - cfg.left_context_chunks_min + 1))
    return DynChunkTrainConfig(chunk_size=chunk if use_chunks else max_frames,
                               left_context_size=left if (limited and use_chunks) else max_frames)


@dataclass(frozen=True)
class TransducerTrainerConfig:
    ctc_weight: float = 0.3
    ce_weight: float = 0.0
    # the CTC aux only while epoch < number_of_ctc_epochs; None = always
    number_of_ctc_epochs: Optional[int] = None
    blank_id: int = 0
    augment: Optional[SpecAugmentConfig] = SpecAugmentConfig()
    # no feature augmentation before this micro step (VoxPopuli)
    augment_warmup_steps: int = 0
    speed_perturb: bool = False
    speeds: Sequence[int] = (95, 100, 105)
    normalize_update_until_epoch: int = 4
    dct: Optional[DynChunkTrainSamplerConfig] = DynChunkTrainSamplerConfig()
    # the JAX trainer redraws every >1-D parameter of the encoder's `asr`
    # xavier-normal after init (the reference TransformerASR's _init_params)
    xavier_init_overwrite: bool = True
    # > 0: the joint in T-chunks of this many encoder frames, never the
    # whole [B, T, U+1, V] logits (`losses.transducer_loss_chunked`)
    joint_chunk: int = 0


class TransducerTrainer:
    """RNN-T training of a Conformer recognizer (`encoder_model`, whose
    `encode` takes a DCT configuration) with a `TransducerModel`."""

    def __init__(self, encoder_model, transducer_model, optimizer, fbank,
                 config: TransducerTrainerConfig = TransducerTrainerConfig()):
        self.model = nn.ModuleDict({"encoder": encoder_model, "transducer": transducer_model})
        self.encoder_model = encoder_model
        self.transducer_model = transducer_model
        self.optimizer = optimizer
        self.fbank = fbank
        self.config = config
        self.normalize = InputNormalization(config.normalize_update_until_epoch)
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.device = self.params[0].device
        # the data-parallel reduction, None in one process
        self.sync = comm.gradient_sync()

    # -- state ---------------------------------------------------------------
    def init_state(self, seed: int) -> Dict:
        """Optimizer state, fresh normalization statistics, counters, the
        step generator seeded with `seed` and the DCT's (`shared_generator`,
        the same generator in one process); with `xavier_init_overwrite`,
        first redraws the encoder's `asr` parameters from that generator."""
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        if self.config.xavier_init_overwrite:
            xavier_normal_overwrite(self.encoder_model.asr, generator)
        shared = split_streams(generator, seed, self.params, self.sync)
        set_dropout_generator(self.model, generator)
        return {"opt_state": self.optimizer.init(self.params) if self.optimizer else None,
                "norm_stats": NormStats.init(self.fbank.n_mels, self.device),
                "step": 0, "epoch": 0, "generator": generator, "shared_generator": shared}

    def _add_blank_bos(self, tokens: torch.Tensor) -> torch.Tensor:
        """The predictor's input: the targets after a blank (the recipes'
        bos is the blank)."""
        bos = torch.full((tokens.shape[0], 1), self.config.blank_id, dtype=tokens.dtype,
                         device=tokens.device)
        return torch.cat([bos, tokens], dim=1)

    def _max_frames(self, n_feats: int) -> int:
        """Encoder frames of `n_feats` Fbank frames through the frontend's
        strides."""
        frames = n_feats
        for stride in self.encoder_model.frontend_strides:
            frames = -(-frames // stride)
        return frames

    def _forward_loss(self, norm_stats: Dict, batch: Dict, train: bool, epoch: int,
                      generator: Optional[torch.Generator] = None, step: int = 0,
                      dct_generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, Tuple[Dict, Dict, Tuple]]:
        """Features, normalization, augmentation (from micro step
        `augment_warmup_steps` on), a DCT draw (training only, from
        `dct_generator`, else `generator`),
        the encoder, the predictor once, the joint and the losses. Returns
        `(loss, (losses, norm_stats, (enc_out, enc_lens)))`."""
        cfg = self.config
        with torch.no_grad():
            feats = self.fbank(batch["wav"])
            feat_len = self.fbank.frame_lengths(batch["wav_lens"])
            pad_mask = (torch.arange(feats.shape[1], device=feats.device)[None, :]
                        < feat_len[:, None]).to(feats.dtype)
            feats, norm_stats = self.normalize(feats, norm_stats, pad_mask, epoch=epoch,
                                               update=train,
                                               reduce=self.sync.sum_ if self.sync else None)
            if train and cfg.augment is not None and step >= cfg.augment_warmup_steps:
                feats = spec_augment(feats, pad_mask, cfg.augment, generator)
        dct = None
        if train and cfg.dct is not None:
            dct = sample_dynchunk(dct_generator or generator,
                                  self._max_frames(feats.shape[1]) + 1, cfg.dct, feats.device)
        self.model.train(train)
        enc_out, enc_lens = self.encoder_model.encode(feats, feat_len, dct)

        td = self.transducer_model
        tokens, token_lens = batch["tokens"], batch["token_lens"]
        enc_proj = td.encode_proj(enc_out)
        # one predictor pass feeds the joint and the CE aux
        dec_proj = td.predictor(self._add_blank_bos(tokens))
        # the transducer cost takes the default "mean"; only CTC is "batchmean"
        if cfg.joint_chunk > 0:
            l_t = transducer_loss_chunked(enc_proj, dec_proj, td.joint, tokens, enc_lens,
                                          token_lens, cfg.blank_id, "mean", cfg.joint_chunk)
        else:
            l_t = transducer_loss(td.joint(enc_proj, dec_proj), tokens, enc_lens, token_lens,
                                  cfg.blank_id, "mean")
        losses = {"transducer": l_t}
        loss = l_t
        if cfg.ctc_weight > 0.0:
            if cfg.number_of_ctc_epochs is None or epoch < cfg.number_of_ctc_epochs:
                losses["ctc"] = ctc_loss(td.ctc_head(enc_out), enc_lens, tokens, token_lens,
                                         blank_id=cfg.blank_id)
                loss = loss + cfg.ctc_weight * losses["ctc"]
            else:
                losses["ctc"] = torch.zeros((), dtype=torch.float32, device=loss.device)
        if cfg.ce_weight > 0.0:
            losses["ce"] = nll_loss(td.ce_from_dec(dec_proj)[:, :-1], tokens, token_lens)
            loss = loss + cfg.ce_weight * losses["ce"]
        losses["loss"] = loss
        return loss, (losses, norm_stats, (enc_out, enc_lens))

    def train_step(self, state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        """One micro step on `batch` (`wav` `[B, N]`, `wav_lens`, `tokens`
        `[B, U]`, `token_lens`, on the model's device): with `MultiSteps`,
        the parameters change on every k-th. `grad_norm` is the micro-batch
        gradient's norm."""
        cfg = self.config
        generator = state["generator"]
        if cfg.speed_perturb:
            with torch.no_grad():
                wav, wav_lens = speed_perturb_batch(batch["wav"], batch["wav_lens"], cfg.speeds,
                                                    generator=generator)
            batch = dict(batch, wav=wav, wav_lens=wav_lens)
        for p in self.params:
            p.grad = None
        loss, (losses, norm_stats, _) = self._forward_loss(
            state["norm_stats"], batch, True, state["epoch"], generator, state["step"],
            state.get("shared_generator"))
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        opt_state, grad_norm, finite, loss = synced_update(
            self.optimizer, self.params, grads, state["opt_state"], loss, self.sync)
        new_state = dict(state, opt_state=opt_state, step=state["step"] + 1,
                         norm_stats=norm_stats if finite else state["norm_stats"])
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = grad_norm
        metrics["nonfinite_skipped"] = int(not finite)
        return new_state, metrics

    @torch.no_grad()
    def eval_step(self, state: Dict, batch: Dict) -> Tuple[Dict, Tuple]:
        """Losses in eval mode (no augmentation, no DCT) and the encoder
        output `(enc_out, enc_lens)`."""
        _, (losses, _, enc) = self._forward_loss(state["norm_stats"], batch, False,
                                                 state["epoch"])
        return losses, enc

    def next_epoch(self, state: Dict) -> Dict:
        """Advance the epoch counter (it gates the normalization statistics'
        updates and `number_of_ctc_epochs`)."""
        return dict(state, epoch=state["epoch"] + 1)

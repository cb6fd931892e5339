"""The flagship's training step — the port of
`summarymixing_tpu/training/trainer.py::ASRTrainer` on one device:

    wav -> speed perturbation -> Fbank -> InputNormalization (statistics
    updated while epoch + 1 < normalize_update_until_epoch) -> SpecAugment
    (from step `augment_warmup_steps` on; with `concat_original` the batch
    becomes [original; augmented], lengths, pad mask and tokens doubled)
    -> SpeechRecognizer (CNN, encoder, attention decoder, dropout)
    -> ctc_weight · CTC + (1 - ctc_weight) · KL-div -> backward
    -> clip to the global norm -> AdamW with the Noam schedule, or the
    two-stage Adam -> SGD (through `MultiSteps` when the recipe accumulates
    gradients), skipped on a non-finite loss or gradient norm.

The model's parameters are the trainable state; `init_state` returns the
rest: optimizer state, normalization statistics, step and epoch counters,
and the one `torch.Generator` on the model's device from which speed
perturbation, SpecAugment and every dropout draw. Speed perturbation runs
inside `train_step` here; the JAX recipes apply it before calling theirs
(`recipes/train.py`). Checkpoints are `training/checkpoint.py`'s.

Data parallelism (a multi-process launch, `parallel/launch.py`): each
process trains on its own rows of every batch. After `backward` the
flattened gradients and the loss are all-reduced to their mean over the
processes (`parallel/comm.py::GradientSync`, one collective per step; the
loss is not routed through one `forward`, so DDP's hooks would miss the
methods the trainers call), so the non-finite skip and the update are
the same everywhere; the normalization statistics take the global batch's
sums and counts. `init_state` broadcasts process 0's parameters, and then
each process draws its dropout, SpecAugment and speed perturbation from a
stream of its own, seeded from (seed, process index): no two processes
draw one mask for different rows. Those bits differ from a
single-process run's.

Model sharding (`mesh`, `param_sharding_fn`: the JAX signature, with the
rules of `parallel/mesh.py`): the parameters and the optimizer moments
are kept as the rule places them, `state["params"]` and the moments as
`DTensor`s, this process's slices (`parallel/sharded.py`); the
normalization statistics, the step, the epoch and the generator are
replicated. Each step gathers the whole parameters into the model, runs
the forward and backward on them, averages the whole gradients over the
mesh's data axis, takes the global norm of that mean, and steps the
optimizer on this process's slices; then the whole parameters are freed.
Processes that differ only on the model axis hold the same rows and draw
the same random streams (seeded from the data coordinate), so they
compute the same gradient and each keeps its own slice of it. `AdamW`,
`TwoStageAdamSGD` and `MultiSteps` take part: the accumulator is kept as
slices of each micro-batch's averaged gradient, and the inner step clips
by the norm of the whole accumulator (as the JAX trainer places the whole
`opt_state` by the rule, the accumulator included). Between steps
`trainer.shards.whole()` makes the model's parameters whole (a
checkpoint, an evaluation by hand); `checkpoint_view(state)` gives the
whole optimizer state, so a sharded run saves what one process saves.

    trainer = ASRTrainer(model, AdamW(noam_schedule(5e-4, 30000), 0.01), fbank)
    state = trainer.init_state(seed=3407)
    state, metrics = trainer.train_step(state, batch)   # batch: wav, wav_lens, tokens, token_lens
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from summarymixing_tpu_torch.decoding.ctc import collapse_ctc, ctc_greedy_decode
from summarymixing_tpu_torch.frontend.augment import (
    SpecAugmentConfig,
    spec_augment,
    speed_perturb_batch,
)
from summarymixing_tpu_torch.frontend.features import InputNormalization, NormStats
from summarymixing_tpu_torch.losses import ctc_loss, kldiv_loss
from summarymixing_tpu_torch.ops.layers import set_dropout_generator
from summarymixing_tpu_torch.parallel import comm, launch
from summarymixing_tpu_torch.parallel.mesh import axis_group
from summarymixing_tpu_torch.training.optim import synced_update
from summarymixing_tpu_torch.training.profiling import span
from summarymixing_tpu_torch.utils.init import xavier_normal_overwrite


@dataclass(frozen=True)
class TrainerConfig:
    ctc_weight: float = 0.3
    label_smoothing: float = 0.1
    blank_id: int = 0
    pad_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    augment: Optional[SpecAugmentConfig] = SpecAugmentConfig()
    # the train batch becomes [original; augmented] (AISHELL-1's Augmenter)
    concat_original: bool = False
    # no feature augmentation before this step (VoxPopuli)
    augment_warmup_steps: int = 0
    speed_perturb: bool = False
    speeds: Sequence[int] = (95, 100, 105)
    normalize_update_until_epoch: int = 4
    # the JAX trainer redraws every >1-D parameter of `asr` xavier-normal
    # after init (the reference TransformerASR's _init_params)
    xavier_init_overwrite: bool = True


def process_seed(seed: int, index: int) -> int:
    """The seed of process `index`'s own stream of a data-parallel run."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0] >> 1)


def split_streams(generator: torch.Generator, seed: int, params, sync) -> torch.Generator:
    """Under data parallelism (`sync` not None): broadcast process 0's
    `params`, copy `generator` (drawn from `seed` on every process) into a
    stream all processes share, and reseed `generator` as this process's
    own (`process_seed`). Returns the shared stream; in one process,
    `generator` itself."""
    if sync is None:
        return generator
    comm.broadcast_parameters(params)
    shared = torch.Generator(device=generator.device)
    shared.set_state(generator.get_state())
    generator.manual_seed(process_seed(seed, launch.process_index()))
    return shared


class ASRTrainer:
    """Joint CTC/attention training (CTC only when the model has no decoder)."""

    def __init__(self, model, optimizer, fbank, config: TrainerConfig = TrainerConfig(),
                 mesh=None, param_sharding_fn=None):
        self.model = model
        self.optimizer = optimizer
        self.fbank = fbank
        self.config = config
        self.normalize = InputNormalization(config.normalize_update_until_epoch)
        self.named_params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.params = [p for _, p in self.named_params]
        self.device = self.params[0].device
        self.mesh = mesh
        self.param_sharding_fn = param_sharding_fn
        if param_sharding_fn is not None and mesh is None:
            raise ValueError("param_sharding_fn places parameters on a mesh: pass mesh too")
        # the mesh's data axis: its group and this process's index on it
        self.data_group, self.data_index, _ = (axis_group(mesh, "data") if mesh is not None
                                               else (None, 0, 1))
        # the data-parallel reduction (over the mesh's data axis), None in one process
        self.sync = (comm.gradient_sync() if mesh is None else
                     comm.gradient_sync(self.data_group) if self.data_group is not None else None)
        self.shards = None   # parallel.sharded.ShardedParameters, from init_state

    # -- state ---------------------------------------------------------------
    def init_state(self, seed: int) -> Dict:
        """Optimizer state, fresh normalization statistics, counters and the
        step generator seeded with `seed`; with `xavier_init_overwrite`,
        first redraws the `asr` parameters from that generator (then, under
        data parallelism, `split_streams`)."""
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        if self.config.xavier_init_overwrite:
            xavier_normal_overwrite(self.model.asr, generator)
        if self.mesh is None:
            split_streams(generator, seed, self.params, self.sync)
        else:
            # the mesh's first process's parameters, one axis at a time; a
            # stream per data index, shared along the model axis
            for axis in self.mesh.mesh_dim_names:
                group, _, size = axis_group(self.mesh, axis)
                if size > 1:
                    comm.broadcast_parameters(self.params, dist.get_global_rank(group, 0), group)
            if self.sync is not None:
                generator.manual_seed(process_seed(seed, self.data_index))
        set_dropout_generator(self.model, generator)
        state = {"norm_stats": NormStats.init(self.fbank.n_mels, self.device),
                 "step": 0, "epoch": 0, "generator": generator}
        if self.param_sharding_fn is None:
            return dict(state, opt_state=self.optimizer.init(self.params))
        from summarymixing_tpu_torch.parallel.sharded import ShardedParameters

        self.shards = ShardedParameters(self.named_params, self.mesh,
                                        self.param_sharding_fn(self.model))
        self.shards.release()
        return dict(state, params=self.shards.dtensors(),
                    opt_state=self._placed(self.optimizer.init(self.shards.local)))

    # -- sharded state ---------------------------------------------------------
    def _map_moments(self, tree, fn):
        """`tree` (an optimizer state) with every list of per-parameter
        tensors mapped by `fn(tensor, parameter index)`."""
        if isinstance(tree, dict):
            return {k: self._map_moments(v, fn) for k, v in tree.items()}
        if isinstance(tree, list) and len(tree) == len(self.params) and all(
                isinstance(t, torch.Tensor) for t in tree):
            return [fn(t, i) for i, t in enumerate(tree)]
        return tree

    def _placed(self, opt_state):
        """The moments of this process's slices as DTensors."""
        return self._map_moments(opt_state, self.shards.as_dtensor)

    def _local(self, opt_state):
        return self._map_moments(opt_state, lambda t, i: t.to_local())

    def checkpoint_view(self, state: Dict) -> Dict:
        """`state` with the whole optimizer state (a collective on every
        process when sharded) and without `params` (the model holds them:
        save `model.state_dict()` inside `trainer.shards.whole()`)."""
        if self.shards is None:
            return state
        whole = self._map_moments(state["opt_state"], lambda t, i: t.full_tensor())
        return {k: v for k, v in dict(state, opt_state=whole).items() if k != "params"}

    def _add_bos(self, tokens: torch.Tensor) -> torch.Tensor:
        bos = torch.full((tokens.shape[0], 1), self.config.bos_id, dtype=tokens.dtype,
                         device=tokens.device)
        return torch.cat([bos, tokens], dim=1)

    def _add_eos(self, tokens: torch.Tensor, token_lens: torch.Tensor) -> torch.Tensor:
        b, u = tokens.shape
        padded = torch.cat([tokens, torch.full((b, 1), self.config.pad_id, dtype=tokens.dtype,
                                               device=tokens.device)], dim=1)
        pos = torch.arange(u + 1, device=tokens.device)[None, :]
        eos = torch.full_like(padded, self.config.eos_id)
        return torch.where(pos == token_lens[:, None], eos, padded)

    def _has_decoder(self) -> bool:
        return self.model.asr.num_decoder_layers > 0

    # -- steps ---------------------------------------------------------------
    def _forward_loss(self, norm_stats: Dict, batch: Dict, train: bool, epoch: int,
                      generator: Optional[torch.Generator] = None, step: int = 0
                      ) -> Tuple[torch.Tensor, Tuple[Dict, Dict, Dict]]:
        """Speed perturbation (in train mode, when configured), features,
        normalization, augmentation (from step `augment_warmup_steps` on;
        with `concat_original`, the original batch followed by its
        augmented copy) and the model in train mode (or eval mode), and the
        joint loss. Returns `(loss, (losses, norm_stats, model_out))`. The
        profiler spans `train.input` (everything before the model) and
        `train.forward` (the model and the losses) cover it."""
        cfg = self.config
        tokens, token_lens = batch["tokens"], batch["token_lens"]
        wav, wav_lens = batch["wav"], batch["wav_lens"]
        with span("train.input"), torch.no_grad():
            if train and cfg.speed_perturb:
                wav, wav_lens = speed_perturb_batch(wav, wav_lens, cfg.speeds,
                                                    generator=generator)
            feats = self.fbank(wav)
            feat_len = self.fbank.frame_lengths(wav_lens)
            pad_mask = (torch.arange(feats.shape[1], device=feats.device)[None, :]
                        < feat_len[:, None]).to(feats.dtype)
            feats, norm_stats = self.normalize(feats, norm_stats, pad_mask, epoch=epoch,
                                               update=train,
                                               reduce=self.sync.sum_ if self.sync else None)
            if train and cfg.augment is not None:
                # before the warm-up step no augmentation is drawn (the JAX
                # trainer draws one and discards it)
                aug = (spec_augment(feats, pad_mask, cfg.augment, generator)
                       if step >= cfg.augment_warmup_steps else feats)
                if cfg.concat_original:
                    feats = torch.cat([feats, aug])
                    feat_len = torch.cat([feat_len, feat_len])
                    tokens = torch.cat([tokens, tokens])
                    token_lens = torch.cat([token_lens, token_lens])
                else:
                    feats = aug
        with span("train.forward"):
            tokens_bos = self._add_bos(tokens) if self._has_decoder() else None
            self.model.train(train)
            out = self.model(feats, feat_len, tokens_bos, pad_idx=cfg.pad_id)
            losses = {}
            loss = torch.zeros((), dtype=torch.float32, device=feats.device)
            if cfg.ctc_weight > 0.0:
                losses["ctc"] = ctc_loss(out["ctc_log_probs"], out["enc_lengths"], tokens,
                                         token_lens, blank_id=cfg.blank_id)
                loss = loss + cfg.ctc_weight * losses["ctc"]
            if self._has_decoder() and cfg.ctc_weight < 1.0:
                losses["att"] = kldiv_loss(out["seq_log_probs"],
                                           self._add_eos(tokens, token_lens), token_lens + 1,
                                           label_smoothing=cfg.label_smoothing)
                loss = loss + (1.0 - cfg.ctc_weight) * losses["att"]
            losses["loss"] = loss
        return loss, (losses, norm_stats, out)

    def train_step(self, state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        """One optimizer step on `batch` (`wav` `[B, N]`, `wav_lens`,
        `tokens` `[B, U]`, `token_lens`, all on the model's device). Its
        phases are the profiler spans `train.input` and `train.forward`
        (`_forward_loss`), `train.backward` and `train.update`."""
        if self.shards is not None:
            self.shards.gather()
        for p in self.params:
            p.grad = None
        loss, (losses, norm_stats, _) = self._forward_loss(
            state["norm_stats"], batch, True, state["epoch"], state["generator"], state["step"])
        with span("train.backward"):
            loss.backward()
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        with span("train.update"):
            if self.shards is None:
                opt_state, grad_norm, finite, loss = synced_update(
                    self.optimizer, self.params, grads, state["opt_state"], loss, self.sync)
            else:
                opt_state, grad_norm, finite, loss = synced_update(
                    self.optimizer, self.shards.local, grads, self._local(state["opt_state"]),
                    loss, self.sync, shards=self.shards)
                opt_state = self._placed(opt_state)
                self.shards.release()
        new_state = dict(state, opt_state=opt_state, step=state["step"] + 1,
                         norm_stats=norm_stats if finite else state["norm_stats"])
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = grad_norm
        metrics["nonfinite_skipped"] = int(not finite)
        return new_state, metrics

    @torch.no_grad()
    def eval_step(self, state: Dict, batch: Dict):
        """Losses in eval mode and the greedy CTC hypotheses (token ids)."""
        losses, ids, keep = self.eval_greedy(state, batch)
        return losses, collapse_ctc(ids, keep)

    @torch.no_grad()
    def eval_greedy(self, state: Dict, batch: Dict):
        """`eval_step` before the collapse: (losses, ids `[B, T']`, keep
        `[B, T']`), the greedy contract of `decoding.ctc`."""
        with self.shards.whole() if self.shards is not None else contextlib.nullcontext():
            _, (losses, _, out) = self._forward_loss(state["norm_stats"], batch, False,
                                                     state["epoch"])
        ids, keep = ctc_greedy_decode(out["ctc_log_probs"], out["enc_lengths"],
                                      self.config.blank_id)
        return losses, ids, keep

    def next_epoch(self, state: Dict) -> Dict:
        return dict(state, epoch=state["epoch"] + 1)

"""YAML recipe loader, `build_model`, `build_lm` and `build_trainer` — the
port of `summarymixing_tpu/config/loader.py` for the Branchformer-SummaryMixing
CTC/attention recipe and its fusion LM, the Conformer-SummaryMixing
transducer recipes, and of the trainer set-up of `recipes/train.py`.
`yaml` is imported inside `load_recipe`, so building a model from
a config made in Python needs no YAML package."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from summarymixing_tpu_torch.config.schema import (
    AugmentConfig,
    DecodingConfig,
    FeaturesConfig,
    LMConfig,
    ModelConfig,
    RecipeConfig,
    TrainingConfig,
    TransducerConfig,
)
from summarymixing_tpu_torch.utils.device import resolve_device

_SECTIONS = {
    "features": FeaturesConfig,
    "augment": AugmentConfig,
    "model": ModelConfig,
    "transducer": TransducerConfig,
    "lm": LMConfig,
    "training": TrainingConfig,
    "decoding": DecodingConfig,
}


def _build_section(cls, data: dict):
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in fields:
            raise ValueError(f"unknown {cls.__name__} field: {key!r}")
        kwargs[key] = tuple(value) if isinstance(value, list) else value
    return cls(**kwargs)


def load_recipe(path: str, overrides: Optional[dict] = None) -> RecipeConfig:
    """Read a YAML recipe; `overrides` maps dotted paths to values."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    for dotted, value in (overrides or {}).items():
        parts = dotted.split(".")
        node = data
        for p in parts[:-1]:
            if node.get(p) is None:
                node[p] = {}
            node = node[p]
        node[parts[-1]] = value
    kwargs = {}
    for key, value in data.items():
        if key in _SECTIONS:
            kwargs[key] = _build_section(_SECTIONS[key], value or {})
        else:
            kwargs[key] = tuple(value) if isinstance(value, list) else value
    return RecipeConfig(**kwargs)


def build_model(cfg: RecipeConfig, device=None) -> tuple:
    """RecipeConfig -> (SpeechRecognizer, Fbank), and with a `transducer`
    section (SpeechRecognizer, Fbank, TransducerModel), in eval mode on
    `device` (the card unless `device` says otherwise). Weights are drawn
    from `cfg.seed` with one `torch.Generator`, the recognizer's first; on
    the `meta` device nothing is drawn. Parameters stay float32, as the JAX
    package keeps them; `training.precision == "bf16"` makes the
    recognizer's layers compute in bfloat16 (`ops.layers.set_compute_dtype`),
    as the flax modules' `dtype` does. The Fbank and the transducer stay
    float32 (the flax transducer has no `dtype`). The recipe's `activation`
    serves every layer: the Conformer's, the SummaryMixing cell's, the
    feed-forward blocks' and the joint's."""
    from summarymixing_tpu_torch.frontend.features import Fbank
    from summarymixing_tpu_torch.models.asr import TransformerASR
    from summarymixing_tpu_torch.models.speech_recognizer import SpeechRecognizer
    from summarymixing_tpu_torch.models.transducer import TransducerModel
    from summarymixing_tpu_torch.ops.layers import set_compute_dtype
    from summarymixing_tpu_torch.utils.init import init_parameters

    device = resolve_device(device)
    m = cfg.model
    with torch.device(device):
        asr = TransformerASR(
            tgt_vocab=m.output_neurons, input_size=m.input_size, d_model=m.d_model,
            nhead=m.nhead, num_encoder_layers=m.num_encoder_layers,
            num_decoder_layers=m.num_decoder_layers, d_ffn=m.d_ffn,
            dropout_rate=m.transformer_dropout, activation=m.activation,
            normalize_before=m.normalize_before, kernel_size=m.csgu_kernel_size,
            encoder_module=m.encoder_module, attention_type=m.attention_type,
            decoder_attention_type=m.decoder_attention_type,
            causal=m.causal, csgu_linear_units=m.csgu_linear_units,
            local_proj_hid_dim=tuple(m.local_proj_hid_dim),
            local_proj_out_dim=m.local_proj_out_dim,
            summary_hid_dim=tuple(m.summary_hid_dim), summary_out_dim=m.summary_out_dim,
            mode=m.mode, branchformer_activation=m.activation,
            conformer_activation=m.activation, max_length=m.max_length)
        model = SpeechRecognizer(asr, m.output_neurons,
                                 frontend_channels=tuple(m.frontend_channels),
                                 frontend_strides=tuple(m.frontend_strides),
                                 frontend_dropout=m.transformer_dropout)
        f = cfg.features
        fbank = Fbank(sample_rate=f.sample_rate, n_fft=f.n_fft,
                      win_length_ms=float(f.win_length), hop_length_ms=float(f.hop_length),
                      n_mels=f.n_mels)
        transducer = None
        if cfg.transducer is not None:
            t = cfg.transducer
            transducer = TransducerModel(
                m.output_neurons, enc_dim=m.d_model, dec_dim=t.dec_dim, joint_dim=t.joint_dim,
                joint_type=t.joint, blank_id=m.blank_index, activation=m.activation,
                emb_dropout=t.dec_emb_dropout, dec_dropout=t.dec_dropout)
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(cfg.seed)
        init_parameters(model, gen)
        if transducer is not None:
            init_parameters(transducer, gen)
    if cfg.training.precision == "bf16":
        set_compute_dtype(model, torch.bfloat16)
    if transducer is None:
        return model.eval(), fbank.eval()
    return model.eval(), fbank.eval(), transducer.eval()


def build_lm(lm_cfg: LMConfig, vocab: int, device=None, seed: int = 0) -> "torch.nn.Module":
    """LMConfig -> the fusion LM (`models.lm.build_lm`) in eval mode on
    `device` (the card unless `device` says otherwise), its weights drawn
    from `seed` with a `torch.Generator` as `build_model` draws the
    recognizer's. The LM computes in float32, as the JAX recipes build it."""
    from summarymixing_tpu_torch.models.lm import build_lm as lm_module
    from summarymixing_tpu_torch.utils.init import init_parameters

    device = resolve_device(device)
    with torch.device(device):
        lm = lm_module(lm_cfg, vocab)
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        init_parameters(lm, gen)
    return lm.eval()


def build_trainer(cfg: RecipeConfig, model, fbank):
    """RecipeConfig -> `ASRTrainer` for `model`: the training section's
    loss weights and label smoothing, AdamW (betas, eps, weight decay) with
    the Noam schedule (peak `lr_adam`, `n_warmup_steps`) and gradient
    clipping, the augment section's speed perturbation and SpecAugment, the
    features section's normalization epochs and the model's token ids."""
    from summarymixing_tpu_torch.frontend.augment import SpecAugmentConfig
    from summarymixing_tpu_torch.training.optim import AdamW, noam_schedule
    from summarymixing_tpu_torch.training.trainer import ASRTrainer, TrainerConfig

    t, a, m = cfg.training, cfg.augment, cfg.model
    if t.scheduler != "noam" or t.stage_one_epochs or t.grad_accumulation_factor > 1:
        raise NotImplementedError("the port trains with AdamW + Noam and no gradient "
                                  "accumulation; see ROADMAP.md")
    augment = None
    if a.fea_augment:
        augment = SpecAugmentConfig(
            time_drop_length=(a.time_drop_length_low, a.time_drop_length_high),
            time_drop_count=a.time_drop_count,
            freq_drop_length=(a.freq_drop_length_low, a.freq_drop_length_high),
            freq_drop_count=a.freq_drop_count, warp_window=a.time_warp_window,
            replace=a.drop_replace, min_augmentations=a.min_augmentations,
            max_augmentations=a.max_augmentations,
            shuffle_augmentations=a.shuffle_augmentations)
    optimizer = AdamW(noam_schedule(t.lr_adam, t.n_warmup_steps), t.weight_decay,
                      tuple(t.adam_betas), t.adam_eps, t.max_grad_norm)
    config = TrainerConfig(
        ctc_weight=t.ctc_weight, label_smoothing=t.label_smoothing, blank_id=m.blank_index,
        pad_id=m.pad_index, bos_id=m.bos_index, eos_id=m.eos_index, augment=augment,
        speed_perturb=a.speed_perturb, speeds=tuple(a.speeds),
        normalize_update_until_epoch=cfg.features.normalize_update_until_epoch)
    return ASRTrainer(model, optimizer, fbank, config)

"""YAML recipe loader and model builder — the port of
`summarymixing_tpu/config/loader.py` for the Branchformer-SummaryMixing
CTC path. `yaml` is imported inside `load_recipe`, so building a model from
a config made in Python needs no YAML package."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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


def build_model(cfg: RecipeConfig, device=None) -> Tuple["torch.nn.Module", "torch.nn.Module"]:
    """RecipeConfig -> (SpeechRecognizer, Fbank) in eval mode on `device`
    (the card unless `device` says otherwise). Weights are drawn from
    `cfg.seed` with a `torch.Generator`; on the `meta`
    device nothing is drawn. `training.precision == "bf16"` casts the model
    to bfloat16; the Fbank stays float32."""
    from summarymixing_tpu_torch.frontend.features import Fbank
    from summarymixing_tpu_torch.models.asr import TransformerASR
    from summarymixing_tpu_torch.models.speech_recognizer import SpeechRecognizer
    from summarymixing_tpu_torch.utils.init import init_parameters

    device = resolve_device(device)
    if cfg.transducer is not None:
        raise NotImplementedError("the transducer is not ported; see ROADMAP.md")
    m = cfg.model
    with torch.device(device):
        asr = TransformerASR(
            tgt_vocab=m.output_neurons, input_size=m.input_size, d_model=m.d_model,
            nhead=m.nhead, num_encoder_layers=m.num_encoder_layers,
            num_decoder_layers=m.num_decoder_layers, kernel_size=m.csgu_kernel_size,
            encoder_module=m.encoder_module, attention_type=m.attention_type,
            causal=m.causal, csgu_linear_units=m.csgu_linear_units,
            local_proj_hid_dim=tuple(m.local_proj_hid_dim),
            local_proj_out_dim=m.local_proj_out_dim,
            summary_hid_dim=tuple(m.summary_hid_dim), summary_out_dim=m.summary_out_dim,
            mode=m.mode, branchformer_activation=m.activation)
        model = SpeechRecognizer(asr, m.output_neurons,
                                 frontend_channels=tuple(m.frontend_channels),
                                 frontend_strides=tuple(m.frontend_strides))
        f = cfg.features
        fbank = Fbank(sample_rate=f.sample_rate, n_fft=f.n_fft,
                      win_length_ms=float(f.win_length), hop_length_ms=float(f.hop_length),
                      n_mels=f.n_mels)
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(cfg.seed)
        init_parameters(model, gen)
    if cfg.training.precision == "bf16":
        model = model.to(torch.bfloat16)
    return model.eval(), fbank.eval()

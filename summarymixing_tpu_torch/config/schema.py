"""Recipe configuration schema — the port's own copy of the dataclasses of
`summarymixing_tpu/config/schema.py`: the same sections, field names and
defaults, so one YAML recipe configures both packages. The meaning of each
field is documented in the JAX package."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class FeaturesConfig:
    sample_rate: int = 16000
    n_fft: int = 512
    win_length: int = 25
    hop_length: int = 10
    n_mels: int = 80
    normalize_update_until_epoch: int = 4


@dataclass
class AugmentConfig:
    fea_augment: bool = True
    speed_perturb: bool = True
    speeds: Tuple[int, ...] = (95, 100, 105)
    time_drop_length_low: int = 15
    time_drop_length_high: int = 25
    time_drop_count: int = 4
    freq_drop_length_low: int = 10
    freq_drop_length_high: int = 20
    freq_drop_count: int = 4
    time_warp_window: int = 5
    drop_replace: str = "mean"
    min_augmentations: int = 3
    max_augmentations: int = 3
    shuffle_augmentations: bool = False
    concat_original: bool = False
    augment_warmup_steps: int = 0


@dataclass
class ModelConfig:
    attention_type: str = "SummaryMixing"
    mode: str = "SummaryMixing"
    encoder_module: str = "branchformer"
    decoder_attention_type: str = "regularMHA"
    d_model: int = 512
    nhead: int = 1
    num_encoder_layers: int = 18
    num_decoder_layers: int = 6
    d_ffn: int = 2048
    transformer_dropout: float = 0.1
    normalize_before: bool = True
    activation: str = "gelu"
    csgu_linear_units: int = 3072
    csgu_kernel_size: int = 31
    local_proj_hid_dim: Tuple[int, ...] = (512,)
    local_proj_out_dim: int = 512
    summary_hid_dim: Tuple[int, ...] = (512,)
    summary_out_dim: int = 512
    causal: bool = False
    max_length: int = 2500
    remat: bool = False
    act_int8: bool = False
    input_size: int = 640
    frontend_channels: Tuple[int, ...] = (64, 32)
    frontend_strides: Tuple[int, ...] = (2, 2)
    output_neurons: int = 5000
    blank_index: int = 0
    pad_index: int = 0
    bos_index: int = 1
    eos_index: int = 2


@dataclass
class TransducerConfig:
    joint_dim: int = 640
    joint: str = "sum"
    dec_dim: int = 512
    dec_emb_dropout: float = 0.2
    dec_dropout: float = 0.1
    joint_chunk: int = 0
    chunkwise_prob: float = 0.6
    chunk_size_min: int = 8
    chunk_size_max: int = 32
    limited_left_context_prob: float = 0.75
    left_context_chunks_min: int = 2
    left_context_chunks_max: int = 32


@dataclass
class TrainingConfig:
    number_of_epochs: int = 120
    batch_size: int = 16
    grad_accumulation_factor: int = 2
    max_grad_norm: float = 5.0
    loss_reduction: str = "batchmean"
    precision: str = "bf16"
    rng_impl: str = "rbg"
    ctc_weight: float = 0.3
    ce_weight: float = 0.0
    number_of_ctc_epochs: Optional[int] = None
    label_smoothing: float = 0.0
    lr_adam: float = 0.0008
    adam_betas: Tuple[float, float] = (0.9, 0.98)
    adam_eps: float = 1e-9
    weight_decay: float = 0.01
    scheduler: str = "noam"
    n_warmup_steps: int = 30000
    optimizer_step_limit: Optional[int] = None
    decay_factor: float = 0.05
    stage_one_epochs: Optional[int] = None
    lr_sgd: float = 0.000025
    sgd_momentum: float = 0.99
    sgd_nesterov: bool = True
    dynamic_batching: bool = True
    max_batch_length: float = 500.0
    max_batch_length_val: Optional[float] = None
    num_buckets: int = 200
    max_batch_ex: int = 128
    valid_every_steps: int = 0
    bucket_shape_grid: bool = False
    eval_token_multiple: int = 16
    ckpt_interval_minutes: float = 15.0
    avg_checkpoints: int = 10


@dataclass
class LMConfig:
    """Language model for shallow fusion (reference yaml:183-191:
    TransformerLM 768d/12h/12L/3072, GELU, normalize_before False; and
    transducer yaml:339-348: RNNLM emb 128, 2x2048 LSTM, 512 DNN)."""
    model_type: str = "transformer"
    d_model: int = 768
    nhead: int = 12
    num_layers: int = 12
    d_ffn: int = 3072
    embedding_dim: int = 128
    rnn_layers: int = 2
    rnn_neurons: int = 2048
    dnn_neurons: int = 512
    output_proj: str = "linear"
    lr: float = 1.0e-4
    dropout: float = 0.0
    batch_tokens: int = 4096
    max_seq_len: int = 256


@dataclass
class DecodingConfig:
    valid_search_interval: int = 10
    valid_beam_size: int = 10
    test_beam_size: int = 66
    lm_weight: float = 0.60
    lm_temperature: float = 1.15
    test_temperature: float = 1.0
    ctc_weight_decode: float = 0.40
    min_decode_ratio: float = 0.0
    max_decode_ratio: float = 1.0
    ctc_blank_skip: float = 0.0
    ctc_frame_cap: int = 0
    max_beam_rows: int = 1024
    beam_size: int = 10
    nbest: int = 1
    state_beam: float = 2.3
    expand_beam: float = 2.3


@dataclass
class RecipeConfig:
    name: str = "librispeech_branchformer_summarymixing"
    seed: int = 3407
    output_folder: str = "results"
    tokenizer_type: str = "sentencepiece"
    token_type: str = "unigram"
    character_coverage: float = 1.0
    features: FeaturesConfig = field(default_factory=FeaturesConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    transducer: Optional[TransducerConfig] = None
    lm: Optional[LMConfig] = None
    training: TrainingConfig = field(default_factory=TrainingConfig)
    decoding: DecodingConfig = field(default_factory=DecodingConfig)
    error_rate: str = "wer"
    remove_spaces: bool = False

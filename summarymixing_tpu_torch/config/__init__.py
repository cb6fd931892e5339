"""Recipe schema and loader of the port."""

from summarymixing_tpu_torch.config.loader import (
    build_lm,
    build_model,
    build_trainer,
    build_transducer_trainer,
    load_recipe,
)
from summarymixing_tpu_torch.config.schema import (
    DecodingConfig,
    FeaturesConfig,
    LMConfig,
    ModelConfig,
    RecipeConfig,
    TrainingConfig,
    TransducerConfig,
)

__all__ = [
    "DecodingConfig",
    "FeaturesConfig",
    "LMConfig",
    "ModelConfig",
    "RecipeConfig",
    "TrainingConfig",
    "TransducerConfig",
    "load_recipe",
    "build_model",
    "build_lm",
    "build_trainer",
    "build_transducer_trainer",
]

"""Models of the port."""

from summarymixing_tpu_torch.models.branchformer import (
    BranchformerEncoder,
    BranchformerEncoderLayer,
)
from summarymixing_tpu_torch.models.conformer import (
    ConformerDecoder,
    ConformerDecoderLayer,
    ConformerEncoder,
    ConformerEncoderLayer,
)
from summarymixing_tpu_torch.models.transformer import (
    NormalizedEmbedding,
    TransformerDecoder,
    TransformerDecoderLayer,
    TransformerEncoder,
    TransformerEncoderLayer,
)
from summarymixing_tpu_torch.models.asr import EncoderASR, EncoderWrapper, TransformerASR

__all__ = [
    "BranchformerEncoder",
    "BranchformerEncoderLayer",
    "ConformerDecoder",
    "ConformerDecoderLayer",
    "ConformerEncoder",
    "ConformerEncoderLayer",
    "NormalizedEmbedding",
    "TransformerDecoder",
    "TransformerDecoderLayer",
    "TransformerEncoder",
    "TransformerEncoderLayer",
    "TransformerASR",
    "EncoderASR",
    "EncoderWrapper",
]

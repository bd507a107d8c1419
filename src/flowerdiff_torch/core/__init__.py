"""Core NN building blocks (port of flowerdiff/core): the reference's
exports, under the same names."""
from flowerdiff_torch.core.attention import MultiHeadSelfAttention, SpatialSelfAttention2D
from flowerdiff_torch.core.embeddings import (
    ClassEmbedding,
    MultiConditionEmbedding,
    TimeEmbedding,
    sinusoidal_time_embedding,
)
from flowerdiff_torch.core.layers import (
    CALayer,
    ConditionedResidualBlock,
    LayerNorm2d,
    ResidualBlock,
    SpatialAttention,
    kaiming_std,
    swish,
)

__all__ = [
    "swish",
    "kaiming_std",
    "LayerNorm2d",
    "CALayer",
    "SpatialAttention",
    "ResidualBlock",
    "ConditionedResidualBlock",
    "SpatialSelfAttention2D",
    "sinusoidal_time_embedding",
    "TimeEmbedding",
    "ClassEmbedding",
    "MultiConditionEmbedding",
    "MultiHeadSelfAttention",
]

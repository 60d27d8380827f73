"""Attention, transformer, LSTM and pooling layers."""
from .attention import MultiheadAttention, dot_product_attention
from .dropout import dropout
from .lstm import LSTMLayer, LSTMStack
from .mlp import MLPLayers
from .pooling import AttentivePoolingLayer, MeanPoolingLayer
from .transformer import (
    MultiheadAttentionAndNorm,
    TransformerEncoder,
    TransformerEncoderLayer,
)

__all__ = [
    "MultiheadAttention",
    "dot_product_attention",
    "dropout",
    "LSTMLayer",
    "LSTMStack",
    "MLPLayers",
    "MeanPoolingLayer",
    "AttentivePoolingLayer",
    "TransformerEncoder",
    "TransformerEncoderLayer",
    "MultiheadAttentionAndNorm",
]

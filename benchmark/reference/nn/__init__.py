"""Network modules of the plain reference."""
from .embeddings import PairEmbedding, ResidueEmbedding
from .epsilon_net import EpsilonNet
from .ipa import GABlock, GAEncoder
from .layers import Embedding, LayerNorm, Linear, mlp

__all__ = [k for k in dir() if not k.startswith('_')]

"""Network modules in PyTorch (counterpart of ``ab_opt_tpu/nn``)."""
from .embeddings import PairEmbedding, ResidueEmbedding
from .epsilon_net import EpsilonNet, apply_fused_heads, precompute_head_weights
from .ipa import (GABlock, GAEncoder, precompute_encoder_pair_biases,
                  precompute_pair_bias)
from .layers import (AngularEncoding, Embedding, LayerNorm, Linear,
                     PerResiduePredictor, distance_to_bins_onehot, mlp)
from .plddt import PerResidueLDDTCaPredictor, compute_plddt, lddt, lddt_loss
from . import inits

__all__ = [k for k in dir() if not k.startswith('_')]

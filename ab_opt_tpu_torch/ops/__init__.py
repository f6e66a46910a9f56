"""Hand-written Hopper kernels with their wrappers and plain versions."""
from . import gablock, ipa_attention

# The wrappers whose ``launches`` count their kernel's launches.
COUNTED = (gablock.gablock_layer, gablock.gablock_attention,
           gablock.gablock_p2n, gablock.gablock_gemm,
           gablock.fused_encoder_chained, ipa_attention.ipa_attention_fwd,
           ipa_attention.ipa_attention_bwd,
           ipa_attention.ipa_attention_fwd_p2n)

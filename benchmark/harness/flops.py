"""Operation and byte counts of the layers the per-layer metrics read,
from each layer's mathematics at its unpadded widths, and the card's
peaks. Whatever implements a layer, the count reads the same work.

The GABlock layer's count and the bound are copies of the kernel
harness's ``_gablock_flops`` / ``_bound`` (``chip_smoke.py``); the K2/K3
counts of its attention phase (``4 pairs 64`` forward, ``8 pairs 64``
backward). A graph layer is counted over its edges (the adjacency a batch
has), not over the dense (L, L) grid an implementation may compute."""
from __future__ import annotations

# H100 SXM (NVIDIA data sheet, dense): bf16 tensor cores, float32 outside
# the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
PEAK_BYTES = 3.35e12

# GABlock widths (the port's defaults: 12 heads, query-key and value 32,
# 8 query and 8 value points).
H, QK, V, P, PV = 12, 32, 32, 8, 8
BF16, F32 = 2, 4


def bound_s(flops: float, nbytes: float, dtype: str = 'bfloat16') -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def gablock_flops(N: int, L: int, F: int = 128, Cz: int = 64) -> float:
    """One GABlock layer over N trajectories of L residues: projections;
    logits over QK + 3P + 2 terms a pair; alpha times V + 3PV values; p2n
    over Cz; the output transform and the three-layer transition."""
    M = N * L
    ko = H * (Cz + V + PV * 7)
    proj = H * (2 * QK + V) + 3 * H * (2 * P + PV)
    per_pair = (QK + 3 * P + 2) + (V + 3 * PV) + Cz
    return (2 * M * F * proj + 2 * N * H * L * L * per_pair
            + 2 * M * ko * F + 3 * 2 * M * F * F)


def gablock_bytes(N: int, L: int, reps: int, F: int = 128,
                  Cz: int = 64) -> float:
    """K1's bytes for one layer: x (float32) in and out, R9, t, the mask,
    z and the bias a complex (bf16), the bf16 weights, each read once."""
    Nc = N // reps
    M = N * L
    ko = H * (Cz + V + PV * 7)
    proj = H * (2 * QK + V) + 3 * H * (2 * P + PV)
    weights = (F * proj + ko * F + F + 3 * (F * F + F) + 4 * F) * BF16
    return (2 * M * F * F32 + M * (9 + 3 + 1) * F32
            + Nc * L * L * Cz * BF16 + Nc * H * L * L * BF16 + weights)


def attention_fwd(N: int, L: int) -> tuple:
    """(flops, bytes) of one K2 call (training: one complex a row):
    qa, ka, vvp and the bias in; out and alphas out (bf16)."""
    pairs = N * H * L * L
    rows = N * L * H * 64
    return 4 * pairs * 64, (3 * rows + pairs + rows + pairs) * BF16


def attention_bwd(N: int, L: int) -> tuple:
    """(flops, bytes) of one K3 call: qa, ka, vvp, alphas, dout, dalphas
    in; dqa, dka, dvvp, dbias out (bf16)."""
    pairs = N * H * L * L
    rows = N * L * H * 64
    return 8 * pairs * 64, (4 * rows + 2 * pairs + 3 * rows + pairs) * BF16


def _mlp(M: float, widths) -> float:
    return sum(2 * M * a * b for a, b in zip(widths[:-1], widths[1:]))


def diffab_embed_flops(N: int, L: int, F: int = 128, C: int = 64,
                       A: int = 15) -> float:
    """Residue and pair embeddings of N complexes (their MLPs and the
    atom-pair distances)."""
    res_in = 2 * F + 22 * A * 3 + 39
    pair_in = 3 * C + 26
    return (_mlp(N * L, (res_in, 2 * F, F, F, F))
            + N * L * L * (_mlp(1, (A * A, C, C)) + _mlp(1, (pair_in, C, C, C, C))
                           + 2 * A * A * 3))


def diffab_denoiser_flops(N: int, L: int, layers: int, bins: int,
                          F: int = 128, C: int = 64) -> float:
    """One denoiser evaluation over N trajectories: the sequence mix-in,
    the GABlock layers and the four output heads."""
    M = N * L
    heads = (3 * _mlp(M, (F + 3, F, F)) + 2 * M * F * (3 + 3 + 20)
             + _mlp(M, (F + 3, F, F, bins)))
    return _mlp(M, (2 * F, F, F)) + layers * gablock_flops(N, L, F, C) + heads


def diffab_request_flops(model: dict, fan_out: int, L: int,
                         steps: int) -> float:
    """A sampling request: one complex encoded, ``steps`` denoiser
    evaluations over its ``fan_out`` trajectories."""
    F, C = model['res_feat_dim'], model['pair_feat_dim']
    layers = model['diffusion']['eps_net_opt']['num_layers']
    bins = model.get('num_bins', 40)
    return (diffab_embed_flops(1, L, F, C)
            + steps * diffab_denoiser_flops(fan_out, L, layers, bins, F, C))


def diffab_train_flops(model: dict, N: int, L: int) -> float:
    """A training step at batch N: the forward (embeddings, one denoiser
    evaluation) and its backward, counted as twice the forward."""
    F, C = model['res_feat_dim'], model['pair_feat_dim']
    layers = model['diffusion']['eps_net_opt']['num_layers']
    bins = model.get('num_bins', 40)
    fwd = (diffab_embed_flops(N, L, F, C)
           + diffab_denoiser_flops(N, L, layers, bins, F, C))
    return 3 * fwd


def gnn_train_flops(model: dict, N: int, L: int, ctx_edges: int,
                    inter_edges: int) -> float:
    """A DiffGNN training step: the forward over the batch's edges (ctx
    edges for the GCLs, inter edges for the attention layers and the
    sequence head) and over its residues, the pair embedding over every
    pair, and the backward counted as twice the forward."""
    F = model['hidden_size']
    E = model['edge_feat_dim']
    R = model['res_feat_dim']
    C = model['num_atoms']
    n = model['n_layers']
    M = N * L
    geom = 2 * C * C
    gcl = (ctx_edges * (_mlp(1, (2 * F + geom + E, F, F)) + _mlp(1, (F, F, C)))
           + _mlp(M, (2 * F, F, F)))
    att = (inter_edges * (2 * (geom + F) * 2 * F + 4 * F + _mlp(1, (F, F, C)))
           + 2 * M * F * F)
    seq_w = F + 2 * (F // 2)
    seq = (inter_edges * (2 * (geom + F) * 2 * F + 4 * F) + 2 * M * F * F
           + _mlp(M, (seq_w, seq_w, seq_w, 21)))
    res_in = 2 * R + 22 * C * 3 + 39 + (R if model.get('hotspot') else 0)
    embed = (_mlp(M, (res_in, 2 * R, R, R, R))
             + N * L * L * (_mlp(1, (C * C, E, E))
                            + _mlp(1, (3 * E + 26, E, E, E)) + 2 * C * C * 3))
    fwd = (embed + 2 * M * R * F + n * (gcl + att) + gcl
           + 2 * M * (F + 3) * F + 2 * M * F * F + seq)
    return 3 * fwd

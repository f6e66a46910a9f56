"""A physically plausible synthetic complex (counterpart of
``ab_opt_tpu/utils/bench_fixture.py::synthetic_batch``): the same numpy
draws in the same order, so the same ``rng`` gives the same complex."""
from __future__ import annotations

import numpy as np
import torch

from .. import geometry as G


def synthetic_batch(rng, N=2, L=24, n_ab=16, gen_lo=6, gen_hi=12,
                    num_atoms=15, device='cpu'):
    """Residues [0, n_ab) are a heavy chain (fragment 1, chain 0), the rest
    antigen (fragment 3, chain 1); residues [gen_lo, gen_hi) are the CDR to
    generate. Returns a dict of tensors on ``device``."""
    q = rng.normal(size=(N, L, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = G.quaternion_to_rotation_matrix(torch.from_numpy(q))
    steps = rng.normal(size=(N, L, 3)).astype(np.float32)
    steps /= np.linalg.norm(steps, axis=-1, keepdims=True)
    t = np.cumsum(3.8 * steps, axis=1).astype(np.float32)
    t -= t.mean(axis=1, keepdims=True)

    aa = rng.integers(0, 20, (N, L))
    chain_nb = np.where(np.arange(L) < n_ab, 0, 1)[None].repeat(N, 0)
    res_nb = np.where(np.arange(L) < n_ab, np.arange(L) + 1,
                      np.arange(L) - n_ab + 1)[None].repeat(N, 0)
    mask = np.ones((N, L), bool)
    tt = lambda a: torch.from_numpy(np.asarray(a))

    bb = G.reconstruct_backbone(R, tt(t), tt(aa), tt(chain_nb), tt(res_nb),
                                tt(mask))
    pos = torch.zeros((N, L, num_atoms, 3))
    pos[:, :, :4] = bb
    mask_atoms = torch.zeros((N, L, num_atoms), dtype=torch.bool)
    mask_atoms[:, :, :4] = True
    generate_flag = np.zeros((N, L), bool)
    generate_flag[:, gen_lo:gen_hi] = True
    fragment_type = np.where(np.arange(L) < n_ab, 1, 3)[None].repeat(N, 0)

    batch = {
        'aa': tt(aa).long(), 'res_nb': tt(res_nb).long(),
        'chain_nb': tt(chain_nb).long(), 'pos_heavyatom': pos,
        'mask_heavyatom': mask_atoms, 'generate_flag': tt(generate_flag),
        'fragment_type': tt(fragment_type).long(), 'mask': tt(mask),
    }
    return {k: v.to(device) for k, v in batch.items()}


def encoder_case(L, Nc, reps, layers, n_pad=0, device='cpu', H=12, seed=0):
    """Seeded inputs of the sampler's GABlock encoder at full width (node
    128, pair 64, H heads), ``layers`` blocks with distinct weights and
    ``n_pad`` padded rows per complex, in the kernels' form (bf16 weights,
    z and biases). Returns ``(args, bundles, biases)``: the arguments of
    :func:`ab_opt_tpu_torch.ops.gablock.fused_encoder_chained`, and the
    per-layer bundles and (Nc, H, L, L) biases that
    :func:`~ab_opt_tpu_torch.ops.gablock.gablock_layer` takes."""
    from ..nn.ipa import GABlock, precompute_pair_bias
    from ..ops.gablock import build_gablock_weights, stack_encoder_weights
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    N = Nc * reps
    R9 = G.quaternion_to_rotation_matrix(r(N, L, 4)).reshape(N, L, 9)
    x, t = r(N, L, 128), r(N, L, 3)
    z = r(Nc, L, L, 64).to(device, torch.bfloat16)
    mask_c = torch.ones(Nc, L, device=device)
    if n_pad:
        mask_c[:, L - n_pad:] = 0.0
    bundles, biases = [], []
    with torch.no_grad():
        for i in range(layers):
            torch.manual_seed(seed + 1 + i)
            block = GABlock(128, 64, num_heads=H).to(device)
            bundles.append(build_gablock_weights(block, torch.bfloat16))
            biases.append(precompute_pair_bias(
                z, block.proj_pair_bias.weight.t(), mask_c, torch.bfloat16))
    to = lambda a: a.to(device).contiguous()
    args = (stack_encoder_weights(bundles), layers, to(R9), to(t), to(x), z,
            torch.stack(biases, 1).contiguous(),
            to(mask_c.repeat_interleave(reps, 0)), reps)
    return args, bundles, biases

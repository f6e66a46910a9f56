"""The traffic generator: synthetic complexes, training batches and every
noise draw of a request or a step, made from the seed.

:func:`synthetic_batch` is a frozen copy of the port's
``utils/bench_fixture.py::synthetic_batch`` (the same numpy draws in the
same order), extended with padding to a length bucket, the hotspot code
of the antigen residue nearest the generated span, and hydropathy and
charge labels on the generated span with label dropout (the
``patch_around_anchor_hotspot`` and ``aa_label`` transforms' fields).

A traffic file (``traffic/<name>.json``) holds the parameters: its
``kind`` (``sample`` or ``train``), the crop (``antibody`` and
``antigen`` residues, padded to ``length``), the generated span
(``cdr_start``, ``cdr_length``), the fan-out or batch, the pool of
distinct inputs, the sampler's flags, how many calls the traced run
traces and how many requests the output check reads."""
from __future__ import annotations

import numpy as np
import torch

from reference import geometry as G
from reference.constants import (Charge, Hydropathy, aa_charge_table,
                                 aa_hydropathy_table)

PAD_AA = 21


def sub_seed(*keys: int) -> int:
    """A 63-bit seed from the benchmark's seed and further keys (distinct
    keys give distinct streams; any seed up to 2**64 - 1 is taken)."""
    return int(np.random.SeedSequence([int(k) for k in keys])
               .generate_state(2, np.uint64)[0] >> np.uint64(1))


def synthetic_batch(rng, N: int, L: int, n_ab: int, gen_lo: int,
                    gen_hi: int, num_atoms: int = 15, n_valid=None,
                    label_drop: float = 0.0) -> dict:
    """N complexes of ``n_valid`` residues (default L) padded to L:
    residues [0, n_ab) a heavy chain (fragment 1, chain 0), the rest up to
    ``n_valid`` antigen (fragment 3, chain 1), [gen_lo, gen_hi) the span
    to generate. Numpy arrays, padded as the port's ``PaddingCollate``
    pads (aa 21, the rest 0, ``mask`` False)."""
    n_valid = L if n_valid is None else n_valid
    Lv = n_valid
    q = rng.normal(size=(N, Lv, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = G.quaternion_to_rotation_matrix(torch.from_numpy(q))
    steps = rng.normal(size=(N, Lv, 3)).astype(np.float32)
    steps /= np.linalg.norm(steps, axis=-1, keepdims=True)
    t = np.cumsum(3.8 * steps, axis=1).astype(np.float32)
    t -= t.mean(axis=1, keepdims=True)

    aa = rng.integers(0, 20, (N, Lv))
    chain_nb = np.where(np.arange(Lv) < n_ab, 0, 1)[None].repeat(N, 0)
    res_nb = np.where(np.arange(Lv) < n_ab, np.arange(Lv) + 1,
                      np.arange(Lv) - n_ab + 1)[None].repeat(N, 0)
    mask = np.ones((N, Lv), bool)
    tt = lambda a: torch.from_numpy(np.asarray(a))

    bb = G.reconstruct_backbone(R, tt(t), tt(aa), tt(chain_nb), tt(res_nb),
                                tt(mask))
    pos = np.zeros((N, Lv, num_atoms, 3), np.float32)
    pos[:, :, :4] = bb.numpy()
    mask_atoms = np.zeros((N, Lv, num_atoms), bool)
    mask_atoms[:, :, :4] = True
    generate_flag = np.zeros((N, Lv), bool)
    generate_flag[:, gen_lo:gen_hi] = True
    fragment_type = np.where(np.arange(Lv) < n_ab, 1, 3)[None].repeat(N, 0)

    # The antigen residue nearest the span is the hotspot (code 2), every
    # other residue 1; labels on the span, each dropped to unknown with
    # probability label_drop.
    ca = pos[:, :, 1]
    d = np.linalg.norm(ca[:, :, None] - ca[:, None, gen_lo:gen_hi],
                       axis=-1).min(-1)
    d = np.where(fragment_type == 3, d, np.inf)
    hotspot = np.ones((N, Lv), np.int64)
    hotspot[np.arange(N), d.argmin(1)] = 2
    hyd = np.full((N, Lv), int(Hydropathy.unknown))
    chg = np.full((N, Lv), int(Charge.unknown))
    span = aa[:, gen_lo:gen_hi]
    keep_h = rng.random(span.shape) >= label_drop
    keep_c = rng.random(span.shape) >= label_drop
    hyd[:, gen_lo:gen_hi] = np.where(keep_h, aa_hydropathy_table[span],
                                     int(Hydropathy.unknown))
    chg[:, gen_lo:gen_hi] = np.where(keep_c, aa_charge_table[span],
                                     int(Charge.unknown))

    batch = {'aa': aa, 'res_nb': res_nb, 'chain_nb': chain_nb,
             'pos_heavyatom': pos, 'mask_heavyatom': mask_atoms,
             'generate_flag': generate_flag, 'fragment_type': fragment_type,
             'mask': mask, 'hotspot_label': hotspot, 'hydropathy': hyd,
             'charge': chg}
    pad = L - Lv
    if pad:
        for k, v in batch.items():
            fill = PAD_AA if k == 'aa' else 0
            width = ((0, 0), (0, pad)) + ((0, 0),) * (v.ndim - 2)
            batch[k] = np.pad(v, width, constant_values=fill)
    return batch


def to_device(batch: dict, device) -> dict:
    """Tensors on ``device``: integers int64, booleans bool, floats
    float32 (as the port's ``to_device_batch`` takes them)."""
    out = {}
    for k, v in batch.items():
        v = torch.from_numpy(np.ascontiguousarray(v))
        if v.dtype.is_floating_point:
            v = v.float()
        elif v.dtype != torch.bool:
            v = v.long()
        out[k] = v.to(device)
    return out


def batch_rows(traffic: dict, model_cfg: dict, seed: int, index: int,
               rows: int) -> dict:
    """``rows`` complexes of the traffic's crop, the ``index``-th input
    of the pool drawn from ``seed`` (numpy; 15 heavy-atom slots, as the
    data pipeline gives every model)."""
    L = int(traffic['length'])
    n_ab = int(traffic['antibody'])
    n_valid = n_ab + int(traffic['antigen'])
    lo = int(traffic['cdr_start'])
    rng = np.random.default_rng(sub_seed(seed, 1, index))
    return synthetic_batch(rng, rows, L, n_ab, lo,
                           lo + int(traffic['cdr_length']),
                           n_valid=n_valid,
                           label_drop=float(traffic.get('label_drop', 0.0)))


# ------------------------------------------------------------------ draws

def _gumbel(u):
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u * (1.0 - tiny) + tiny))


def step_draws(seed: int, call: int, step: int, N: int, L: int, device,
               sequence: bool = True) -> dict:
    """Every noise draw of reverse step ``step`` of call ``call``: the
    entry of ``draws['steps']`` that the models' ``sample`` takes. Drawn
    from a generator of that (seed, call, step) alone, so any one step's
    draws can be made again."""
    g = torch.Generator(device=device).manual_seed(
        sub_seed(seed, 2, call, step))
    u = lambda *s: torch.rand(s, generator=g, device=device)
    n = lambda *s: torch.randn(s, generator=g, device=device)
    d = {'rot_axis': n(N, L, 3), 'rot_u': u(N, L), 'rot_frac': u(N, L),
         'rot_gauss': n(N, L), 'pos': n(N, L, 3)}
    if sequence:
        d['seq_gumbel'] = _gumbel(u(N, L, 20))
    return d


def check_steps(seed: int, call: int, steps: int, n: int) -> list:
    """The ``n`` reverse steps after the first (indices 1 to steps - 1)
    whose output the check of call ``call`` compares, drawn from the
    seed."""
    rng = np.random.default_rng(sub_seed(seed, 7, call))
    pick = rng.choice(np.arange(1, steps), min(n, steps - 1), replace=False)
    return sorted(int(k) for k in pick)


class StepDraws:
    """``draws['steps']`` of one call, made a step at a time as the loop
    reads it (the sampler's own generator would draw them so)."""

    def __init__(self, seed, call, steps, N, L, device, sequence=True):
        self.args = (seed, call, N, L, device, sequence)
        self.steps = steps

    def __len__(self):
        return self.steps

    def __getitem__(self, step):
        seed, call, N, L, device, sequence = self.args
        return step_draws(seed, call, step, N, L, device, sequence)


def request_draws(seed: int, call: int, steps: int, N: int, L: int, device,
                  sequence: bool = True) -> dict:
    """The ``draws`` of one sampling call of N trajectories: the initial
    state's and each step's (:class:`StepDraws`)."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 3, call))
    d = {'init_quat': torch.randn((N, L, 4), generator=g, device=device),
         'init_pos': torch.randn((N, L, 3), generator=g, device=device)}
    if sequence:
        d['init_seq'] = torch.randint(0, 19, (N, L), generator=g,
                                      device=device)
    d['steps'] = StepDraws(seed, call, steps, N, L, device, sequence)
    return d


def rows_of(draws: dict, rows) -> dict:
    """The draws of the trajectories ``rows`` (a tensor of indices)."""
    return {k: v[rows] for k, v in draws.items() if torch.is_tensor(v)}


def loss_draws(seed: int, step: int, N: int, L: int, num_steps: int, device,
               sequence: bool = True):
    """(t, draws) of training step ``step``: a level a complex and the
    noise the models' ``loss`` takes, from a generator of (seed, step)."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 4, step))
    u = lambda *s: torch.rand(s, generator=g, device=device)
    n = lambda *s: torch.randn(s, generator=g, device=device)
    t = torch.randint(0, num_steps, (N,), generator=g, device=device)
    d = {'rot_axis': n(N, L, 3), 'rot_u': u(N, L), 'rot_frac': u(N, L),
         'rot_gauss': n(N, L), 'pos': n(N, L, 3)}
    if sequence:
        d['seq_gumbel'] = _gumbel(u(N, L, 20))
    return t, d

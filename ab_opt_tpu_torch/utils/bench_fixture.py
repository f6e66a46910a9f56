"""A physically plausible synthetic complex (counterpart of
``ab_opt_tpu/utils/bench_fixture.py::synthetic_batch``): the same numpy
draws in the same order, so the same ``rng`` gives the same complex."""
from __future__ import annotations

import contextlib
import sys
import types

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


# Residue index (0-based) ranges of the synthetic complex's CA layout.
_ROW = 12          # residues per row of a chain's snake
_RISE = 3.8        # CA-CA along a row (A)
_ROW_GAP = 3.9     # between rows (A): consecutive CAs stay within 4 A


def _snake(n, origin, row_axis, col_axis):
    """CA positions of ``n`` residues in rows of _ROW along ``row_axis``,
    successive rows ``_ROW_GAP`` apart along ``col_axis``, boustrophedon."""
    pts = []
    for k in range(n):
        row, col = divmod(k, _ROW)
        if row % 2:
            col = _ROW - 1 - col
        pts.append(origin + _RISE * col * row_axis + _ROW_GAP * row * col_axis)
    return np.asarray(pts, np.float64)


def _backbone_atoms(ca):
    """N, CA, C, O, CB of each CA of a chain, from the local tangent."""
    n = len(ca)
    prev = np.concatenate([ca[:1], ca[:-1]])
    nxt = np.concatenate([ca[1:], ca[-1:]])
    d = nxt - prev
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = np.where(np.abs(d[:, 2:3]) > 0.9, [[0.0, 1.0, 0.0]], [[0.0, 0.0, 1.0]])
    nrm = np.cross(d, ref)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    b = np.cross(d, nrm)
    N = ca + 1.46 * (-0.83 * d + 0.56 * nrm)
    C = ca + 1.52 * (0.83 * d + 0.56 * nrm)
    O = C + 1.23 * b
    CB = ca + 1.53 * (-0.8 * nrm + 0.6 * b)
    out = np.zeros((n, 15, 3), np.float32)
    for j, a in enumerate((N, ca, C, O, CB)):
        out[:, j] = a
    return out


def synthetic_complex(seed: int = 0, n_antigen: int = 170) -> dict:
    """A synthetic antibody-antigen complex in Chothia numbering, as the
    structure dict :func:`~ab_opt_tpu_torch.data.pdb.save_pdb` writes:
    heavy chain ``H`` (resseq 1-113, CDR-H3 95-102 a hairpin rising out of
    the heavy chain's plane), light chain ``L`` (1-107, a plane 5 A below)
    and antigen ``A`` (``n_antigen`` residues in a vertical plane whose
    lowest row lies 6.5 A above the hairpin's tip, so that a few
    antigen atoms lie within DockQ's 5 A of CDR-H3). Backbone atoms and CB,
    residue types drawn from ``seed`` (heavy 103 is Trp, as Chothia heavy
    chains carry). The 128 residues nearest CDR-H3 are mostly antibody, so
    a crop of 128 + 128 fills the 256 bucket and one of 20 antigen
    residues plus the CDR fills 32."""
    rng = np.random.default_rng(seed)
    ex, ey, ez = np.eye(3)
    heavy = _snake(94, np.zeros(3), ex, ey)
    x0 = heavy[-1]
    up = [x0 + _RISE * k * ez for k in range(1, 5)]
    down = [x0 + _ROW_GAP * ey + _RISE * (4 - k) * ez for k in range(4)]
    tail = _snake(11, x0 + _ROW_GAP * ey, ex, ey)
    heavy = np.concatenate([heavy, up, down, tail])             # 113
    light = _snake(107, np.array([0.0, 0.0, -5.0]), ex, ey)
    tip = x0 + 4 * _RISE * ez + 0.5 * _ROW_GAP * ey
    antigen = _snake(n_antigen, tip + np.array([-2.0 * _RISE, 0.0, 6.5]),
                     ex, ez)
    chains = (('H', heavy), ('L', light), ('A', antigen))
    aa = rng.integers(0, 20, sum(len(c) for _, c in chains))
    aa[102] = 18                                                # TRP at H103
    if aa[113 + 102] == 18:                                     # not at L103
        aa[113 + 102] = 5
    pos = np.concatenate([_backbone_atoms(c) for _, c in chains])
    mask = np.zeros(pos.shape[:2], bool)
    mask[:, :5] = True
    mask[aa == 5, 4] = False                                    # GLY: no CB
    return {
        'chain_id': [cid for cid, c in chains for _ in range(len(c))],
        'resseq': np.concatenate([np.arange(1, len(c) + 1)
                                  for _, c in chains]),
        'icode': [' '] * len(aa), 'aa': aa, 'pos_heavyatom': pos,
        'mask_heavyatom': mask,
    }


def write_synthetic_complex(path: str, seed: int = 0,
                            n_antigen: int = 170) -> str:
    """Write :func:`synthetic_complex` as a PDB file; returns ``path``."""
    from ..data.pdb import save_pdb
    save_pdb(synthetic_complex(seed, n_antigen), path)
    return path


# The summary TSV's columns, as the SAbDab summary file names them.
SABDAB_COLUMNS = ('pdb', 'Hchain', 'Lchain', 'model', 'antigen_chain',
                  'antigen_type', 'antigen_het_name', 'antigen_name', 'date',
                  'resolution', 'method', 'scfv')


def write_mini_sabdab(root: str, n: int = 44, n_antigen: int = 170) -> dict:
    """A SAbDab-shaped dataset of ``n`` synthetic complexes under ``root``:
    ``chothia/<code>.pdb`` (:func:`synthetic_complex` with seed i, chains H,
    L and A) and ``summary.tsv``. Entries 0 and 1 name the antigen
    ``mers s``, which puts them in the test split; entry 2 has the PDB code
    ``5mes``, whose id ``5mes_H_L_A`` is a dock-test complex; the rest go
    to val (the first 20 after the split's shuffle) and train. Returns the
    dataset paths a config's ``dataset`` section takes (``processed_dir``
    not yet written)."""
    import os
    chothia = os.path.join(root, 'chothia')
    os.makedirs(chothia, exist_ok=True)
    lines = ['\t'.join(SABDAB_COLUMNS)]
    for i in range(n):
        code = '5mes' if i == 2 else f'{i // 26 + 1}x{chr(97 + i % 26)}{i % 10}'
        write_synthetic_complex(os.path.join(chothia, f'{code}.pdb'), seed=i,
                                n_antigen=n_antigen)
        name = 'mers s' if i < 2 else f'synthetic antigen {i}'
        lines.append('\t'.join((code, 'H', 'L', '0', 'A', 'protein', 'NA', name,
                                f'{1 + i % 12:02d}/01/{10 + i % 12}', '2.5',
                                'X-RAY', 'False')))
    summary = os.path.join(root, 'summary.tsv')
    with open(summary, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return {'summary_path': summary, 'chothia_dir': chothia,
            'processed_dir': os.path.join(root, 'processed')}


# --------------------------------------------------------------------------- #
# Reference-format checkpoints
# --------------------------------------------------------------------------- #

# The source of a stand-in ``easydict`` module: its EasyDict as the package
# defines it (a dict whose items are also attributes, nested dicts and the
# dicts in lists converted). The reference pickles its config as
# ``easydict.EasyDict``; the package is not a dependency of this repo.
EASYDICT_SOURCE = '''
class EasyDict(dict):
    def __init__(self, d=None, **kwargs):
        super().__init__()
        for k, v in dict(d or {}, **kwargs).items():
            setattr(self, k, v)

    def __setattr__(self, name, value):
        if isinstance(value, (list, tuple)):
            value = type(value)(EasyDict(x) if isinstance(x, dict) else x
                                for x in value)
        elif isinstance(value, dict) and not isinstance(value, EasyDict):
            value = EasyDict(value)
        super().__setattr__(name, value)
        super().__setitem__(name, value)

    __setitem__ = __setattr__
'''


@contextlib.contextmanager
def easydict_standin():
    """A module ``easydict`` built from :data:`EASYDICT_SOURCE` in
    ``sys.modules`` for the block only (the module it replaced, if any, is
    put back); yields its EasyDict."""
    module = types.ModuleType('easydict')
    exec(EASYDICT_SOURCE, module.__dict__)
    before = sys.modules.get('easydict')
    sys.modules['easydict'] = module
    try:
        yield module.EasyDict
    finally:
        if before is None:
            sys.modules.pop('easydict', None)
        else:
            sys.modules['easydict'] = before


def reference_buffers(model) -> dict:
    """Keys a reference state dict holds besides the learnable weights, for
    a port ``DiffAb`` or ``DiffGNN``: the diffusion's position affine and
    variance schedules (the reference registers them as buffers) and, for
    the graph model, each layer's unused ``time_mlp``. Their names and
    shapes follow the reference's module layout as far as this repository
    records it; no released file has been read to check them. The port has
    no parameter of these names, so a converter drops them all."""
    steps = model.cfg.num_steps + 1
    gnn = hasattr(model, 'gnn')
    pre = '' if gnn else 'diffusion.'
    out = {f'{pre}position_mean': torch.zeros(1, 1, 3 if not gnn else 1),
           f'{pre}position_scale': torch.full((1, 1, 1), 10.0),
           f'{pre}_dummy': torch.empty(0)}
    for trans in ('trans_pos', 'trans_rot') + (() if gnn else ('trans_seq',)):
        for name in ('betas', 'alpha_bars', 'alphas', 'sigmas'):
            out[f'{pre}{trans}.var_sched.{name}'] = torch.linspace(
                0.0, 1.0, steps)
    if gnn:
        F = model.cfg.hidden_size
        for i in range(model.cfg.n_layers):
            out[f'gnn.gcl_{i}.time_mlp.weight'] = torch.zeros(F, F)
            out[f'gnn.gcl_{i}.time_mlp.bias'] = torch.zeros(F)
    return out


def write_reference_checkpoint(path: str, model, config: dict,
                               iteration: int = 250000) -> str:
    """Write ``model`` (a port ``DiffAb`` or ``DiffGNN``, which keeps the
    reference's parameter names and layouts) as the reference's training
    loop saves a checkpoint: ``torch.save`` of ``{config, model, optimizer,
    scheduler, iteration}``, the config an ``easydict.EasyDict`` (through
    :func:`easydict_standin`), the state dict with
    :func:`reference_buffers`, an Adam state over its first two parameters
    and a plateau scheduler's state. Returns ``path``."""
    state = dict(model.state_dict(), **reference_buffers(model))
    first = list(model.state_dict().values())[:2]
    optimizer = {
        'state': {i: {'step': torch.tensor(float(iteration)),
                      'exp_avg': torch.zeros_like(p),
                      'exp_avg_sq': torch.zeros_like(p)}
                  for i, p in enumerate(first)},
        'param_groups': [{'lr': 1e-4, 'betas': (0.9, 0.999), 'eps': 1e-8,
                          'weight_decay': 0.0, 'amsgrad': False,
                          'params': list(range(len(state)))}]}
    scheduler = {'factor': 0.8, 'patience': 10, 'mode': 'min', 'best': 1.25,
                 'num_bad_epochs': 0, 'last_epoch': iteration // 1000,
                 '_last_lr': [1e-4], 'min_lrs': [5e-6]}
    with easydict_standin() as EasyDict:
        torch.save({'config': EasyDict(config), 'model': state,
                    'optimizer': optimizer, 'scheduler': scheduler,
                    'iteration': iteration}, path)
    return path

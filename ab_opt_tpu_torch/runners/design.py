"""The design runner: one PDB complex in, designed PDBs, DockQ, AAR, pRMSD
and a consensus ranking out (counterpart of ``ab_opt_tpu/runners/design.py``).

  parse -> variants (mode) -> crop (PatchAroundAnchor [+RemoveNative]) ->
  batched reverse-diffusion sampling (:class:`BatchedSampler`: every
  trajectory of a chunk in one call, the encoder through K1, K5 or K4 on
  the card) -> backbone reconstruction on the device -> paste back into
  the full complex -> save PDBs -> DockQ / AAR / pRMSD -> consensus
  ranking -> results.csv + aa.csv.

The host side (variants, crops, collation, pasting, PDB text, DockQ, the
ranking and the CSVs) is the same numpy code as the JAX package, with the
same ``numpy.random.default_rng(seed)`` stream, so the same seed gives the
same variants and crops. The sampler takes an integer seed per chunk of
trajectories, derived from ``(seed, lo)`` (:func:`chunk_seed`).
"""
from __future__ import annotations

import copy
import dataclasses
import json
import logging
import os
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .. import metrics
from ..constants import CDR, BBHeavyAtom, Fragment, resindex_to_ressymb
from ..data import (apply_patch_to_tensor, get_transform, mask_select_data,
                    preprocess_antibody_structure, save_pdb)
from ..data.collate import PaddingCollate, to_device_batch
from ..data.transforms import generate_mask_from_contig
from ..geometry import reconstruct_backbone_partially, so3vec_to_rotation
from ..models import get_model
from ..models.diff_gnn import DiffGNN
from ..models.diffab import DiffAb
from ..ops.gablock import fused_encoder_chained, gablock_layer
from ..ops.ipa_attention import ipa_attention_fwd_p2n
from ..parallel.mesh import replicate_batch
from ..tools.dockq import calc_dockq
from ..train.checkpoint import read_weights
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

# The sampler's encoder kernels, by the name the runner logs them under.
_KERNELS = {'K1': gablock_layer, 'K5': fused_encoder_chained,
            'K4': ipa_attention_fwd_p2n}

_CDR_NAMES = {int(CDR.H1): 'H_CDR1', int(CDR.H2): 'H_CDR2',
              int(CDR.H3): 'H_CDR3', int(CDR.L1): 'L_CDR1',
              int(CDR.L2): 'L_CDR2', int(CDR.L3): 'L_CDR3'}

# Crop lengths round up to these; K1 takes every one up to 256.
LENGTH_BUCKETS = (32, 48, 64, 96, 128, 160, 192, 224, 256, 320, 384, 512)


def find_cdrs(structure) -> List[str]:
    """CDR names present in a structure."""
    cdrs = []
    for key, prefix in (('heavy', 'H'), ('light', 'L')):
        if structure[key] is not None:
            flags = set(int(x) for x in np.unique(structure[key]['cdr_flag']))
            for i in (1, 2, 3):
                cdr = int(getattr(CDR, f'{prefix}{i}'))
                if cdr in flags:
                    cdrs.append(_CDR_NAMES[cdr])
    return cdrs


def get_residue_first_last(data):
    idx = np.flatnonzero(data['generate_flag'])
    lo, hi = int(idx.min()), int(idx.max())
    f = lambda i: (data['chain_id'][i], int(data['resseq'][i]), data['icode'][i])
    return f(lo), f(hi)


def create_data_variants(mode: str, sampling_cfg: Dict, structure,
                         rng: Optional[np.random.Generator] = None) -> List[Dict]:
    """Build masked+merged variants per the sampling mode."""
    rng = rng or np.random.default_rng(0)
    structure_id = structure['id']
    variants = []

    def run_tfm(tfm_cfg):
        return get_transform(tfm_cfg)(copy.deepcopy(structure), rng=rng)

    def selected_cdrs():
        return sorted(set(find_cdrs(structure))
                      & set(sampling_cfg.get('cdrs', find_cdrs(structure))))

    def single_cdr(cdr_name):
        data = run_tfm([
            {'type': 'mask_single_cdr', 'selection': cdr_name,
             'augmentation': False},
            {'type': 'merge_chains'}])
        return data, get_residue_first_last(data)

    if mode == 'single_cdr':
        for cdr_name in selected_cdrs():
            data, (first, last) = single_cdr(cdr_name)
            variants.append({'data': data, 'name': f'{structure_id}-{cdr_name}',
                             'tag': cdr_name, 'cdr': cdr_name,
                             'residue_first': first, 'residue_last': last})
    elif mode == 'multiple_cdrs':
        cdrs = selected_cdrs()
        data = run_tfm([
            {'type': 'mask_multiple_cdrs', 'selection': cdrs,
             'augmentation': False},
            {'type': 'merge_chains'}])
        variants.append({'data': data, 'name': f'{structure_id}-MultipleCDRs',
                         'tag': 'MultipleCDRs', 'cdrs': cdrs,
                         'residue_first': None, 'residue_last': None})
    elif mode == 'dock_antibody':
        data = run_tfm([
            {'type': 'mask_full_antibody',
             'antibody_chains': sampling_cfg.get('antibody_chains', ['heavy'])},
            {'type': 'merge_chains'}])
        variants.append({'data': data, 'name': f'{structure_id}-{mode}',
                         'tag': mode, 'residue_first': None,
                         'residue_last': None})
    elif mode == 'full':
        data = run_tfm([{'type': 'mask_antibody'}, {'type': 'merge_chains'}])
        variants.append({'data': data, 'name': f'{structure_id}-Full',
                         'tag': 'Full', 'residue_first': None,
                         'residue_last': None})
    elif mode == 'abopt':
        for cdr_name in selected_cdrs():
            data, (first, last) = single_cdr(cdr_name)
            for opt_step in sampling_cfg.get('optimize_steps', [50]):
                variants.append({
                    'data': data, 'name': f'{structure_id}-{cdr_name}-O{opt_step}',
                    'tag': f'{cdr_name}-O{opt_step}', 'cdr': cdr_name,
                    'opt_step': opt_step, 'residue_first': first,
                    'residue_last': last})
    else:
        raise ValueError(f'Unknown mode: {mode}')
    return variants


@dataclasses.dataclass
class DesignArgs:
    pdb_path: str
    ckpt: Optional[str] = None          # None -> random init from ``seed``
    config: Optional[Dict] = None       # test config dict (mode, sampling, model)
    heavy: str = 'H'
    light: str = 'L'
    no_renumber: bool = True
    num_samples: int = 10
    batch_size: int = 16
    topk: int = 1
    seed: int = 0
    out_root: str = './results'
    tag: str = ''
    contig: str = ''
    label_heavy_as_cdr: bool = False
    keep_traj: bool = True
    run_dockq: bool = True
    id: str = ''
    stride: int = 1                     # >1: strided (DDIM-style) sampling
    device: Optional[str] = None        # None -> the CUDA card


def chunk_seed(seed: int, lo: int) -> int:
    """The sampler's seed for the chunk of trajectories starting at ``lo``:
    distinct (seed, lo) pairs give distinct streams."""
    return int(np.random.SeedSequence([seed, lo]).generate_state(1)[0])


def random_model(model_cfg: Dict, seed: int) -> Union[DiffAb, DiffGNN]:
    """A model of ``model_cfg`` with random weights drawn from ``seed``
    (the global torch generator is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return get_model(model_cfg)


def load_model_from_checkpoint(ckpt_path: str):
    """Rebuild the architecture from the checkpoint's embedded config and
    load its weights; returns ``(model, config)``. Reads port checkpoints
    and JAX ones."""
    saved = read_weights(ckpt_path)
    config = saved['config'] or {}
    model_cfg = dict(config.get('model', {'type': 'diffab'}))
    model_cfg.setdefault('type', 'diffab')
    model = get_model(model_cfg)
    model.load_state_dict(saved['state_dict'])
    return model, config


def _to_numpy(out: Dict) -> Dict:
    return {k: _to_numpy(v) if isinstance(v, dict) else v.cpu().numpy()
            for k, v in out.items()}


class BatchedSampler:
    """One design request: ``num_replicas`` trajectories per complex of a
    batch, their backbones rebuilt on the device, returned as numpy (the
    trajectory too, copied once at the end).

    ``sample_structure`` / ``sample_sequence`` choose what is generated (the
    other modality stays native: docking samples structure only, sequence
    design sequence only); ``keep_traj`` adds every step's state under
    'traj'; ``opt_step`` switches to the optimize path (noise the native
    state to that step, then denoise); ``stride`` > 1 samples with strided
    (DDIM) steps.

    ``device=None`` runs on the CUDA card (and raises without one); pass
    ``device='cpu'`` to run on the CPU. The model is moved there."""

    def __init__(self, model: Union[DiffAb, DiffGNN], device=None,
                 sample_structure: bool = True, sample_sequence: bool = True,
                 keep_traj: bool = False, opt_step: Optional[int] = None,
                 stride: int = 1):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.sample_structure = sample_structure
        self.sample_sequence = sample_sequence
        self.keep_traj = keep_traj
        self.opt_step = opt_step
        self.stride = stride

    def __call__(self, batch: Dict, seed: int,
                 num_replicas: int = 1) -> Dict[str, np.ndarray]:
        device = self.device
        batch = to_device_batch(batch, device)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        flags = dict(sample_structure=self.sample_structure,
                     sample_sequence=self.sample_sequence,
                     keep_traj=self.keep_traj)
        if self.opt_step is not None:
            # The optimize path starts from the native state: replicate the
            # batch (no encode fan-out there).
            if num_replicas > 1:
                batch = replicate_batch(batch, num_replicas)
            out = self.model.optimize(batch, self.opt_step,
                                      generator=generator, **flags)
        else:
            out = self.model.sample(batch, generator=generator,
                                    num_replicas=num_replicas,
                                    stride=self.stride, **flags)
        # Tile the context batch to the trajectory axis (sample() encodes
        # once and fans out internally; replicas are contiguous per complex).
        B = out['s'].shape[0]
        tile = lambda x: x.repeat_interleave(B // x.shape[0], dim=0)
        pos_new, mask_new = reconstruct_backbone_partially(
            tile(batch['pos_heavyatom']), so3vec_to_rotation(out['v']),
            out['p'], out['s'], tile(batch['chain_nb']), tile(batch['res_nb']),
            tile(batch['mask_heavyatom']), tile(batch['generate_flag']))
        out['pos_atom_new'] = pos_new
        out['mask_atom_new'] = mask_new
        return _to_numpy(out)


def _paste_sample(data_tmpl, data_cropped, aa_i, pos_i, mask_i, origin):
    """Paste a sampled patch back into the full merged complex."""
    aa = apply_patch_to_tensor(data_tmpl['aa'], aa_i, data_cropped['patch_idx'])
    mask_ha = apply_patch_to_tensor(data_tmpl['mask_heavyatom'], mask_i,
                                    data_cropped['patch_idx'])
    pos_ha = apply_patch_to_tensor(
        data_tmpl['pos_heavyatom'], pos_i + origin.reshape(1, 1, 3),
        data_cropped['patch_idx'])
    return aa, pos_ha, mask_ha


def _antigen_and_patch_mask(data_tmpl, data_cropped):
    antigen_mask = data_tmpl['fragment_type'] == int(Fragment.Antigen)
    patch_mask = np.zeros_like(antigen_mask)
    patch_mask[data_cropped['patch_idx']] = True
    return antigen_mask | patch_mask


def design_for_pdb(args: DesignArgs,
                   model: Optional[Union[DiffAb, DiffGNN]] = None) -> Dict:
    """Run the full design/dock pipeline for one PDB. Returns the summary
    dict.

    ``model`` may be passed in by pipeline loops (one model, many poses);
    otherwise it is loaded from
    ``args.ckpt`` or built from ``args.config`` with random weights drawn
    from ``args.seed``.
    """
    cfg = args.config or {}
    rng = np.random.default_rng(args.seed)

    structure_id = args.id or os.path.basename(args.pdb_path)
    pdb_path = args.pdb_path
    if not args.no_renumber:
        from ..tools.renumber import renumber_antibody
        out_path = os.path.join(args.out_root, f'{structure_id}_chothia.pdb')
        os.makedirs(args.out_root, exist_ok=True)
        pdb_path, heavy_chains, light_chains = renumber_antibody(
            args.pdb_path, out_path)
        if args.heavy is None and heavy_chains:
            args.heavy = heavy_chains[0]
        if args.light is None and light_chains:
            args.light = light_chains[0]

    structure = preprocess_antibody_structure(
        {'id': structure_id, 'pdb_path': pdb_path,
         'heavy_id': args.heavy, 'light_id': args.light},
        label_whole_heavy_chain_as_cdr=args.label_heavy_as_cdr)
    if structure is None:
        raise ValueError(f'Failed to parse {args.pdb_path}')

    if model is None:
        if args.ckpt:
            model, ckpt_cfg = load_model_from_checkpoint(args.ckpt)
            cfg = dict(ckpt_cfg.get('test', {}), **cfg) if ckpt_cfg else cfg
        else:
            model_cfg = dict(cfg.get('model', {}))
            model_cfg.setdefault('type', 'diffab')
            model = random_model(model_cfg, args.seed)

    log_dir = os.path.join(args.out_root,
                           f'{structure_id}_{args.tag}'.rstrip('_'))
    os.makedirs(log_dir, exist_ok=True)

    return design_for_structure(structure, model, cfg, args, log_dir, rng)


def design_for_structure(structure, model: Union[DiffAb, DiffGNN], cfg: Dict,
                         args: DesignArgs, log_dir: str,
                         rng: Optional[np.random.Generator] = None) -> Dict:
    """Run the variant loop for an already-preprocessed structure.

    Each variant's stage wall-clocks (sample, paste_io, dockq, rank, with
    its sample count and total) and the encoder kernels' launches in its
    sampler calls are logged, one line each.
    """
    rng = rng or np.random.default_rng(args.seed)
    device = resolve_device(args.device)
    mode = cfg.get('mode', 'single_cdr')
    sampling_cfg = dict(cfg.get('sampling', {}))
    variants = create_data_variants(mode, sampling_cfg, structure, rng)

    # Metadata for the downstream relax/eval scanners.
    metadata = {
        'identifier': structure['id'],
        'items': [{k: v for k, v in var.items() if k != 'data'}
                  for var in variants],
    }
    with open(os.path.join(log_dir, 'metadata.json'), 'w') as f:
        json.dump(metadata, f, indent=2, default=str)

    # Inference crop: patch around anchor (+ optional native wipe). The
    # graph model additionally needs hotspot labels + property channels.
    model_type = cfg.get('model', {}).get('type', 'diffab')
    is_gnn = model_type == 'diff_gnn' or model.__class__.__name__ == 'DiffGNN'
    patch_cfg = {
        'type': 'patch_around_anchor_hotspot' if is_gnn else 'patch_around_anchor',
        'initial_patch_size': cfg.get('model', {}).get('initial_patch_size', 128),
        'antigen_size': cfg.get('model', {}).get('antigen_size', 128),
        'remove_anchor': cfg.get('model', {}).get('remove_anchor', False),
    }
    inference_steps = [patch_cfg]
    if is_gnn:
        inference_steps.append({'type': 'aa_label', 'hydropathy': True,
                                'charge': True})
    sample_structure = sampling_cfg.get('sample_structure', True)
    sample_sequence = sampling_cfg.get('sample_sequence', True)
    if mode != 'abopt' and not args.contig:
        inference_steps.append({'type': 'remove_native',
                                'remove_structure': sample_structure,
                                'remove_sequence': sample_sequence})
    inference_tfm = get_transform(inference_steps)

    collate = PaddingCollate(buckets=LENGTH_BUCKETS)
    results: Dict[str, Dict] = {}
    aa_rows = []

    for variant in variants:
        vdir = os.path.join(log_dir, variant['tag'])
        os.makedirs(vdir, exist_ok=True)
        data_cropped = inference_tfm(copy.deepcopy(variant['data']), rng=rng)
        single = collate([data_cropped])

        if args.contig:
            gen_idx = np.flatnonzero(single['generate_flag'][0])
            contig = generate_mask_from_contig(args.contig, len(gen_idx))
            cm = np.zeros_like(single['generate_flag'])
            cm[0, gen_idx[contig]] = True
            single['generate_flag'] = single['generate_flag'] & cm

        sampler = BatchedSampler(model, device=device,
                                 sample_structure=sample_structure,
                                 sample_sequence=sample_sequence,
                                 keep_traj=args.keep_traj,
                                 opt_step=variant.get('opt_step'),
                                 stride=args.stride)

        # Native reference patch (antigen + patch region) for DockQ.
        data_tmpl = variant['data']
        keep = _antigen_and_patch_mask(data_tmpl, data_cropped)
        native_patch = mask_select_data(copy.deepcopy(data_tmpl), keep)
        ref_path = os.path.join(vdir, 'REF1.pdb')
        save_pdb(native_patch, ref_path)

        scores = {k: [] for k in ('DockQ', 'irms', 'Lrms', 'fnat', 'AAR',
                                  'prmsd', 'PPL')}
        candidates = []
        count = 0
        n_crop = len(data_cropped['aa'])
        gen_flag_full = apply_patch_to_tensor(
            data_tmpl['generate_flag'], single['generate_flag'][0][:n_crop],
            data_cropped['patch_idx'])
        native_aa_gen = data_tmpl['aa'][gen_flag_full]

        single_np = {k: v for k, v in single.items() if isinstance(v, np.ndarray)}
        # Stage wall-clocks: sampling incl. the device's backbone
        # reconstruction and the copy to the host; paste-back + per-sample
        # PDB writes; DockQ; consensus ranking.
        stage_s = {'sample': 0.0, 'paste_io': 0.0, 'dockq': 0.0, 'rank': 0.0}
        launches0 = {k: fn.launches for k, fn in _KERNELS.items()}
        t_var0 = time.perf_counter()
        for lo in range(0, args.num_samples, args.batch_size):
            n = min(args.batch_size, args.num_samples - lo)
            t0 = time.perf_counter()
            out = sampler(single_np, chunk_seed(args.seed, lo),
                          num_replicas=n)
            stage_s['sample'] += time.perf_counter() - t0

            if args.keep_traj and lo == 0 and 'traj' in out:
                _save_trajectory(out, single_np, data_tmpl, data_cropped,
                                 os.path.join(log_dir, 'traj.pdb'))

            origin = np.asarray(data_cropped['origin'])
            for i in range(n):
                aa_i = out['s'][i]
                pos_i = out['pos_atom_new'][i]
                mask_i = out['mask_atom_new'][i]
                prmsd_i = (round(float(out['prmsd'][:, i].mean()), 6)
                           if 'prmsd' in out else float('nan'))
                ppl_i = (round(float(out['perplexity'][-1, i]), 6)
                         if 'perplexity' in out else float('nan'))

                t0 = time.perf_counter()
                aa, pos_ha, mask_ha = _paste_sample(
                    data_tmpl, data_cropped, aa_i[:n_crop], pos_i[:n_crop],
                    mask_i[:n_crop], origin)

                pred_aa_gen = aa[gen_flag_full]
                aar = metrics.amino_acid_recovery(pred_aa_gen, native_aa_gen)
                aa_rows.append({
                    'Region': variant['tag'],
                    'native_aa': ''.join(resindex_to_ressymb[int(x)]
                                         for x in native_aa_gen),
                    'sampled_aa': ''.join(resindex_to_ressymb[int(x)]
                                          for x in pred_aa_gen),
                    'AAR': aar, 'PPL': ppl_i,
                })

                data_out = dict(data_tmpl, aa=aa, pos_heavyatom=pos_ha,
                                mask_heavyatom=mask_ha)
                sample_patch = mask_select_data(data_out, keep)
                save_path = os.path.join(vdir, '%04d.pdb' % count)
                save_pdb(sample_patch, save_path)
                candidates.append(pos_ha[gen_flag_full][:, (BBHeavyAtom.N,
                                                            BBHeavyAtom.CA,
                                                            BBHeavyAtom.CB)])

                stage_s['paste_io'] += time.perf_counter() - t0

                row = {'AAR': aar, 'prmsd': prmsd_i, 'PPL': ppl_i}
                if args.run_dockq:
                    t0 = time.perf_counter()
                    dq = calc_dockq(save_path, ref_path, use_ca_only=True)
                    stage_s['dockq'] += time.perf_counter() - t0
                    row.update({k: round(dq[k], 3)
                                for k in ('DockQ', 'irms', 'Lrms', 'fnat')})
                for k, v in row.items():
                    scores[k].append(v)
                count += 1

        # Consensus ranking by pairwise structural similarity.
        t0 = time.perf_counter()
        cand = np.stack(candidates).reshape(count, -1, 3)
        topk_idx = metrics.rank_commonness(cand, min(args.topk, count))
        stage_s['rank'] = time.perf_counter() - t0
        total = time.perf_counter() - t_var0
        logger.info(
            'variant %s timing (%d samples): sample=%.3fs paste+io=%.3fs '
            'dockq=%.3fs rank=%.3fs total=%.3fs', variant['tag'], count,
            stage_s['sample'], stage_s['paste_io'], stage_s['dockq'],
            stage_s['rank'], total)
        launches = {k: fn.launches - launches0[k]
                    for k, fn in _KERNELS.items()}
        logger.info('variant %s kernel launches: %s', variant['tag'],
                    ' '.join(f'{k}={n}' for k, n in launches.items()))
        summary = {f'{k}_mean': round(float(np.mean(v)), 3)
                   for k, v in scores.items() if v}
        # Per-metric spread + full per-sample lists: screening filters on
        # DockQ_std / prmsd_std quantiles.
        summary.update({f'{k}_std': round(float(np.std(v)), 3)
                        for k, v in scores.items() if v})
        summary.update({f'{k}_all': [float(x) for x in v]
                        for k, v in scores.items()
                        if v and k in ('DockQ', 'prmsd')})
        summary.update({f'{k}_top{args.topk}': [scores[k][i] for i in topk_idx]
                        for k in scores if scores[k]})
        summary['per_sample_rmsd'] = round(metrics.average_pairwise_rmsd(cand), 3)
        summary['topk_idx'] = [int(i) for i in topk_idx]
        results[variant['tag']] = summary

    _write_csvs(results, aa_rows, log_dir)
    return results


def _save_trajectory(out, single_np, data_tmpl, data_cropped, path,
                     sample_idx: int = 0):
    """Multi-MODEL PDB of one sample's reverse trajectory. Every step's
    backbone is rebuilt on the host in one batched call."""
    traj = out['traj']
    T = traj['p'].shape[0]
    L = len(data_cropped['aa'])
    origin = np.asarray(data_cropped['origin'])
    keep = _antigen_and_patch_mask(data_tmpl, data_cropped)
    b = to_device_batch(single_np)
    tile = lambda x: x.expand(T, *x.shape[1:])
    row = lambda a: torch.from_numpy(np.ascontiguousarray(a[:, sample_idx]))
    pos_new, mask_new = reconstruct_backbone_partially(
        tile(b['pos_heavyatom']), so3vec_to_rotation(row(traj['v'])),
        row(traj['p']), row(traj['s']).long(), tile(b['chain_nb']),
        tile(b['res_nb']), tile(b['mask_heavyatom']),
        tile(b['generate_flag']))
    pos_new, mask_new = pos_new.numpy(), mask_new.numpy()
    s = traj['s'][:, sample_idx]
    chunks = []
    for step in range(T):
        aa, pos_ha, mask_ha = _paste_sample(
            data_tmpl, data_cropped, s[step][:L], pos_new[step][:L],
            mask_new[step][:L], origin)
        data_out = dict(data_tmpl, aa=aa, pos_heavyatom=pos_ha,
                        mask_heavyatom=mask_ha)
        text = save_pdb(mask_select_data(data_out, keep))
        chunks.append(f'MODEL     {step + 1}\n{text}ENDMDL\n')
    with open(path, 'w') as f:
        f.write(''.join(chunks))


def _write_csvs(results: Dict, aa_rows: List[Dict], log_dir: str):
    """results.csv (one row per variant, its scalar scores) and aa.csv (one
    row per sample)."""
    import pandas as pd
    df = pd.DataFrame.from_dict(
        {tag: {k: v for k, v in summ.items() if not isinstance(v, list)}
         for tag, summ in results.items()}, orient='index')
    df.to_csv(os.path.join(log_dir, 'results.csv'))
    pd.DataFrame(aa_rows).to_csv(os.path.join(log_dir, 'aa.csv'), index=False)


# --------------------------------------------------------------------------- #
# AbDesign property-spec conditioning: hydropathy/charge specification
# strings over the CDR.
# --------------------------------------------------------------------------- #

_HYDRO_CHARS = {'+': 1, '-': 2, '?': 3}          # hydrophilic / moderate / unknown
_CHARGE_CHARS = {'+': 1, '-': 2, '=': 3, '?': 4}  # pos / neg / neutral / unknown


def apply_property_spec(data: Dict, hydropathy_spec: Optional[str] = None,
                        charge_spec: Optional[str] = None) -> Dict:
    """Condition the generate region on per-position property strings.

    Spec strings use one char per CDR position: hydropathy '+'/'-'/'?'
    (hydrophilic/moderate/unknown) and charge '+'/'-'/'='/'?'
    (positive/negative/neutral/unknown). Returns a copy of ``data`` with the
    'hydropathy'/'charge' channels set (AbDesign conditioning inputs).
    """
    data = dict(data)
    gen_idx = np.flatnonzero(data['generate_flag'])
    L = data['aa'].shape[0]
    for spec, chars, key, unknown in (
            (hydropathy_spec, _HYDRO_CHARS, 'hydropathy', 3),
            (charge_spec, _CHARGE_CHARS, 'charge', 4)):
        if spec is None:
            continue
        if len(spec) != len(gen_idx):
            raise ValueError(
                f'{key} spec length {len(spec)} != CDR length {len(gen_idx)}')
        labels = np.full(L, unknown, np.int64)
        labels[gen_idx] = [chars[c] for c in spec]
        data[key] = labels
    return data

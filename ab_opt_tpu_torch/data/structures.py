"""Antibody-structure preprocessing: chain grouping and Chothia CDR
labelling (the port's own copy of ``ab_opt_tpu/data/structures.py``)."""
from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

from ..constants import CDR, ChothiaCDRRange, resindex_to_ressymb
from .pdb import ParsingException, parse_pdb, pdb_chain_ids

logger = logging.getLogger(__name__)

MAX_RESSEQ_HEAVY = 113   # Chothia, end of heavy-chain Fv
MAX_RESSEQ_LIGHT = 106   # Chothia, end of light-chain Fv


def aa_to_sequence(aa) -> str:
    return ''.join(resindex_to_ressymb[int(a)] for a in np.asarray(aa).ravel())


def label_heavy_chain_cdr(data, seq_map, max_cdr3_length: int = 30):
    if data is None or seq_map is None:
        return data, seq_map
    cdr_flag = np.zeros_like(data['aa'])
    for (chain, resseq, icode), idx in seq_map.items():
        cdr = ChothiaCDRRange.to_cdr('H', resseq)
        if cdr is not None:
            cdr_flag[idx] = int(cdr)
    data['cdr_flag'] = cdr_flag
    for n, c in (('H1_seq', CDR.H1), ('H2_seq', CDR.H2), ('H3_seq', CDR.H3)):
        data[n] = aa_to_sequence(data['aa'][cdr_flag == int(c)])

    cdr3_length = int((cdr_flag == int(CDR.H3)).sum())
    if cdr3_length > max_cdr3_length:
        logger.warning('CDR-H3 too long %d. Removed.', cdr3_length)
        return None, None
    if cdr3_length == 0:
        logger.warning('No CDR-H3 found in the heavy chain.')
        return None, None
    return data, seq_map


def label_light_chain_cdr(data, seq_map, max_cdr3_length: int = 30):
    if data is None or seq_map is None:
        return data, seq_map
    cdr_flag = np.zeros_like(data['aa'])
    for (chain, resseq, icode), idx in seq_map.items():
        cdr = ChothiaCDRRange.to_cdr('L', resseq)
        if cdr is not None:
            cdr_flag[idx] = int(cdr)
    data['cdr_flag'] = cdr_flag
    for n, c in (('L1_seq', CDR.L1), ('L2_seq', CDR.L2), ('L3_seq', CDR.L3)):
        data[n] = aa_to_sequence(data['aa'][cdr_flag == int(c)])

    cdr3_length = int((cdr_flag == int(CDR.L3)).sum())
    if cdr3_length > max_cdr3_length:
        logger.warning('CDR-L3 too long %d. Removed.', cdr3_length)
        return None, None
    if cdr3_length == 0:
        logger.warning('No CDRs found in the light chain.')
        return None, None
    return data, seq_map


def label_whole_chain_as_cdr(data, seq_map, max_chain_length: int = 120):
    """Label an entire chain as CDR-H3 (re-docking designed CDR-only chains)."""
    if data is None or seq_map is None:
        return data, seq_map
    if len(data['aa']) > max_chain_length:
        raise ParsingException(f'Chain too long {len(data["aa"])}')
    data['cdr_flag'] = np.full_like(data['aa'], int(CDR.H3))
    return data, seq_map


def preprocess_antibody_structure(task: Dict,
                                  label_whole_heavy_chain_as_cdr: bool = False
                                  ) -> Optional[Dict]:
    """Parse a PDB into {heavy, light, antigen} structure groups.

    task: {'id', 'pdb_path', optional 'heavy_id' (default H), 'light_id' (L)}.
    Chains that are neither heavy nor light are merged into the antigen.
    """
    pdb_path = task['pdb_path']
    H_id = task.get('heavy_id', 'H')
    L_id = task.get('light_id', 'L')

    all_chain_ids = pdb_chain_ids(pdb_path)
    parsed = {'id': task['id'],
              'heavy': None, 'heavy_seqmap': None,
              'light': None, 'light_seqmap': None,
              'antigen': None, 'antigen_seqmap': None}
    try:
        if H_id in all_chain_ids:
            label_fn = (label_whole_chain_as_cdr if label_whole_heavy_chain_as_cdr
                        else label_heavy_chain_cdr)
            parsed['heavy'], parsed['heavy_seqmap'] = label_fn(
                *parse_pdb(pdb_path, chain_ids=[H_id],
                           max_resseq=MAX_RESSEQ_HEAVY))
        if L_id in all_chain_ids:
            parsed['light'], parsed['light_seqmap'] = label_light_chain_cdr(
                *parse_pdb(pdb_path, chain_ids=[L_id],
                           max_resseq=MAX_RESSEQ_LIGHT))
        if parsed['heavy'] is None and parsed['light'] is None:
            raise ValueError(
                'Neither valid antibody H-chain or L-chain is found. '
                f'Please ensure the heavy chain id is "{H_id}" and the light '
                f'chain id is "{L_id}".')

        ag_chain_ids = [c for c in all_chain_ids if c not in (H_id, L_id)]
        if ag_chain_ids:
            parsed['antigen'], parsed['antigen_seqmap'] = parse_pdb(
                pdb_path, chain_ids=ag_chain_ids)
    except (ParsingException, KeyError, ValueError) as e:
        logger.warning('[%s] %s: %s', task['id'], e.__class__.__name__, e)
        return None
    return parsed

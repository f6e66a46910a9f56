"""Chothia renumbering of antibody chains (optional AbNumber plug-in); the
port's own copy of ``ab_opt_tpu/tools/renumber.py``.

Extract each chain's sequence, number it with AbNumber's Chothia scheme,
rebuild the chain with the new (resseq, icode) ids, and classify chains as
heavy/light. AbNumber (and its ANARCI backend) is optional; when absent,
``renumber_antibody`` takes the passthrough, which checks that the input
already carries Chothia-consistent CDRs and raises otherwise.
"""
from __future__ import annotations

import logging
import shutil
from typing import List, Tuple

from ..constants import ChothiaCDRRange
from ..data.pdb import parse_pdb, save_pdb
from ..data.structures import aa_to_sequence

logger = logging.getLogger(__name__)


def abnumber_available() -> bool:
    try:
        import abnumber   # noqa: F401
        return True
    except ImportError:
        return False


def _renumber_with_abnumber(in_pdb: str, out_pdb: str
                            ) -> Tuple[str, List[str], List[str]]:
    import abnumber

    data, _ = parse_pdb(in_pdb)
    chain_ids = sorted(set(data['chain_id']))
    heavy_chains, light_chains = [], []

    new_resseq = data['resseq'].copy()
    new_icode = list(data['icode'])

    for cid in chain_ids:
        idx = [i for i, c in enumerate(data['chain_id']) if c == cid]
        seq = aa_to_sequence(data['aa'][idx])
        try:
            chain = abnumber.Chain(seq, scheme='chothia')
        except abnumber.ChainParseError:
            continue   # not an antibody chain (antigen)
        if chain.chain_type == 'H':
            heavy_chains.append(cid)
        elif chain.chain_type in ('K', 'L'):
            light_chains.append(cid)
        # abnumber numbers only the Fv; map its positions onto our residues.
        offset = seq.index(chain.seq)
        for k, (pos, _aa) in enumerate(chain):
            i = idx[offset + k]
            new_resseq[i] = pos.number
            new_icode[i] = (pos.letter or ' ')

    out = dict(data, resseq=new_resseq, icode=new_icode)
    save_pdb(out, out_pdb)
    return out_pdb, heavy_chains, light_chains


def _passthrough_check(in_pdb: str, out_pdb: str
                       ) -> Tuple[str, List[str], List[str]]:
    """No-renumber fallback: detect chains already numbered in Chothia style
    (a CDR-H3/L3 window exists within the Fv range)."""
    from .. import constants as C

    data, _ = parse_pdb(in_pdb)
    heavy, light = [], []
    for cid in sorted(set(data['chain_id'])):
        idx = [i for i, c in enumerate(data['chain_id']) if c == cid]
        res = {int(data['resseq'][i]) for i in idx}
        by_resseq = {int(data['resseq'][i]): int(data['aa'][i]) for i in idx}
        h3 = set(range(ChothiaCDRRange.H3[0], ChothiaCDRRange.H3[1] + 1))
        l3 = set(range(ChothiaCDRRange.L3[0], ChothiaCDRRange.L3[1] + 1))
        max_r = max(res)
        if max_r > 150 or not (res & (h3 | l3)):
            continue   # antigen or non-Fv chain
        # Chothia heavy chains carry the conserved FR4 Trp at position 103
        # (W-G-x-G) and extend past 107; light chains end at ~106-107.
        looks_heavy = (by_resseq.get(103) == int(C.AA.TRP)) or max_r >= 108
        (heavy if looks_heavy else light).append(cid)
    if not heavy and not light:
        raise RuntimeError(
            'AbNumber is not installed and the input does not look '
            'Chothia-numbered; install abnumber/ANARCI or provide a '
            'pre-renumbered PDB (e.g. SAbDab chothia structures).')
    shutil.copyfile(in_pdb, out_pdb)
    return out_pdb, heavy, light


def renumber_antibody(in_pdb: str, out_pdb: str
                      ) -> Tuple[str, List[str], List[str]]:
    """Returns (out_path, heavy_chain_ids, light_chain_ids)."""
    if abnumber_available():
        return _renumber_with_abnumber(in_pdb, out_pdb)
    logger.warning('AbNumber unavailable; checking for pre-Chothia numbering')
    return _passthrough_check(in_pdb, out_pdb)

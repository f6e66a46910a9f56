"""Structure and sequence similarity of designed CDRs; the port's own copy
of ``ab_opt_tpu/tools/eval/similarity.py``.

``reslist_rmsd`` is the banded DP that aligns a shorter CA list inside a
longer one, minimising the summed squared distance; sequence identity is
the BLOSUM62 global alignment of :mod:`ab_opt_tpu_torch.metrics`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ...data.pdb import parse_pdb
from ...metrics import global_align_identity


def reslist_rmsd(ca_short: np.ndarray, ca_long: np.ndarray) -> float:
    """Best RMSD of the shorter CA list slid/DP-aligned within the longer
    one. Inputs: (M, 3) and (N, 3); the two swap when M > N."""
    if len(ca_short) > len(ca_long):
        ca_short, ca_long = ca_long, ca_short
    M, N = len(ca_short), len(ca_long)
    d = ((ca_short[:, None, :] - ca_long[None, :, :]) ** 2).sum(-1)   # (M, N)

    SD = np.full((M, N), np.inf)
    for i in range(M):
        j = N - (M - i)
        SD[i, j] = sum(d[i + k, j + k] for k in range(N - j))
    SD[M - 1, :] = d[M - 1, :]
    for i in range(M - 2, -1, -1):
        for j in range(N - (M - i) - 1, -1, -1):
            SD[i, j] = min(d[i, j] + SD[i + 1, j + 1], SD[i, j + 1])
    return float(np.sqrt(SD[0, :N - M + 1].min() / M))


def _cdr_region(data, first: Tuple, last: Tuple):
    """Residue index range matching (chain, resseq, icode) bounds."""
    keys = list(zip(data['chain_id'], data['resseq'], data['icode']))
    norm = lambda t: (t[0], int(t[1]), (t[2] or ' '))
    try:
        lo = keys.index(norm(tuple(first)))
        hi = keys.index(norm(tuple(last)))
    except ValueError:
        return None
    return lo, hi


def eval_similarity(gen_path: str, ref_path: str,
                    residue_first: Optional[Tuple] = None,
                    residue_last: Optional[Tuple] = None) -> Dict[str, float]:
    """CDR CA-RMSD and aligned sequence identity between a generated and a
    reference structure (paths, or PDB text)."""
    gen, _ = parse_pdb(gen_path, is_text='\n' in gen_path)
    ref, _ = parse_pdb(ref_path, is_text='\n' in ref_path)

    if residue_first is not None and residue_last is not None:
        rg = _cdr_region(gen, residue_first, residue_last)
        rr = _cdr_region(ref, residue_first, residue_last)
    else:
        rg = rr = None

    if rg is not None and rr is not None:
        g_slice = slice(rg[0], rg[1] + 1)
        r_slice = slice(rr[0], rr[1] + 1)
    else:
        g_slice = r_slice = slice(None)

    ca_gen = gen['pos_heavyatom'][g_slice, 1]
    ca_ref = ref['pos_heavyatom'][r_slice, 1]
    rmsd = reslist_rmsd(ca_gen, ca_ref)
    seqid = global_align_identity(gen['aa'][g_slice], ref['aa'][r_slice])
    return {'rmsd': rmsd, 'seqid': seqid}

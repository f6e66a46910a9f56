"""Self-contained PDB read/write (no Biopython dependency): the port's own
copy of ``ab_opt_tpu/data/pdb.py``.

Read side:

* residues sorted by (resseq, icode) within each chain, chains in the order
  asked for (all chains sorted by id by default);
* a residue is kept only if it is a standard (or substitutable) amino acid
  and has N, CA and C atoms;
* ``res_nb`` renumbers gap-aware: +1 when consecutive CA-CA distance <= 4 A,
  else jumps by max(2, delta resseq);
* UNK residues are counted then dropped; raises if their fraction exceeds
  ``unknown_threshold``.

Write side: structure dict -> PDB text, 3 decimals per coordinate.

Structures are dicts of numpy arrays:
  chain_id: list[str], resseq/icode/res_nb/aa: (L,), pos_heavyatom: (L, 15, 3)
  float32, mask_heavyatom: (L, 15) bool.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..constants import (
    AA,
    BBHeavyAtom,
    MAX_NUM_HEAVYATOMS,
    ONE_TO_THREE,
    resindex_to_ressymb,
    restype_to_heavyatom_names,
)


class ParsingException(Exception):
    pass


@dataclasses.dataclass
class _RawResidue:
    resname: str
    resseq: int
    icode: str
    atoms: Dict[str, np.ndarray]


def _read_pdb_residues(pdb_path_or_str: str, is_text: bool = False):
    """Parse ATOM records of the first model into per-chain residue lists."""
    if is_text:
        lines = pdb_path_or_str.splitlines()
    else:
        with open(pdb_path_or_str) as f:
            lines = f.read().splitlines()

    chains: Dict[str, Dict[Tuple[int, str], _RawResidue]] = {}
    for line in lines:
        rec = line[:6]
        if rec == 'ENDMDL':
            break   # first model only
        if rec not in ('ATOM  ', 'HETATM'):
            continue
        altloc = line[16]
        if altloc not in (' ', 'A', '1'):
            continue
        atom_name = line[12:16].strip()
        resname = line[17:20].strip()
        chain_id = line[21]
        try:
            resseq = int(line[22:26])
            xyz = np.array([float(line[30:38]), float(line[38:46]),
                            float(line[46:54])], np.float32)
        except ValueError:
            continue
        icode = line[26]
        res_key = (resseq, icode)
        chain = chains.setdefault(chain_id, {})
        res = chain.get(res_key)
        if res is None:
            res = chain[res_key] = _RawResidue(resname, resseq, icode, {})
        res.atoms.setdefault(atom_name, xyz)
    return chains


def parse_pdb(pdb_path: str, chain_ids: Optional[Sequence[str]] = None,
              unknown_threshold: float = 1.0, max_resseq: Optional[int] = None,
              is_text: bool = False):
    """Parse a PDB file into a structure dict + seq_map.

    Args:
      chain_ids: restrict to these chains (in the given grouping); None = all
        chains, sorted by id.
    Returns:
      (data, seq_map) where seq_map maps (chain_id, resseq, icode) -> index.
    Raises:
      ParsingException on empty or overly-unknown structures.
    """
    raw = _read_pdb_residues(pdb_path, is_text=is_text)
    if chain_ids is None:
        chain_ids = sorted(raw.keys())

    chain_id_out: List[str] = []
    resseq_out: List[int] = []
    icode_out: List[str] = []
    res_nb_out: List[int] = []
    aa_out: List[int] = []
    pos_out: List[np.ndarray] = []
    mask_out: List[np.ndarray] = []

    count_aa, count_unk = 0, 0

    for cid in chain_ids:
        if cid not in raw:
            continue
        seq_this = 0
        residues = sorted(raw[cid].values(), key=lambda r: (r.resseq, r.icode))
        for res in residues:
            if max_resseq is not None and res.resseq > max_resseq:
                continue
            if not AA.is_aa(res.resname):
                continue
            if not all(a in res.atoms for a in ('CA', 'C', 'N')):
                continue
            restype = AA(res.resname)
            count_aa += 1
            if restype == AA.UNK:
                count_unk += 1
                continue

            pos = np.zeros((MAX_NUM_HEAVYATOMS, 3), np.float32)
            mask = np.zeros((MAX_NUM_HEAVYATOMS,), bool)
            for idx, name in enumerate(restype_to_heavyatom_names[restype]):
                if name and name in res.atoms:
                    pos[idx] = res.atoms[name]
                    mask[idx] = True

            chain_id_out.append(cid)
            aa_out.append(int(restype))
            pos_out.append(pos)
            mask_out.append(mask)

            if seq_this == 0:
                seq_this = 1
            else:
                d_ca = np.linalg.norm(pos_out[-2][BBHeavyAtom.CA]
                                      - pos_out[-1][BBHeavyAtom.CA])
                if d_ca <= 4.0:
                    seq_this += 1
                else:
                    seq_this += max(2, res.resseq - resseq_out[-1])
            resseq_out.append(res.resseq)
            icode_out.append(res.icode)
            res_nb_out.append(seq_this)

    if not aa_out:
        raise ParsingException('No parsed residues.')
    if count_aa > 0 and (count_unk / count_aa) >= unknown_threshold:
        raise ParsingException(
            f'Too many unknown residues, threshold {unknown_threshold:.2f}.')

    data = {
        'chain_id': chain_id_out,
        'resseq': np.asarray(resseq_out, np.int64),
        'icode': icode_out,
        'res_nb': np.asarray(res_nb_out, np.int64),
        'aa': np.asarray(aa_out, np.int64),
        'pos_heavyatom': np.stack(pos_out),
        'mask_heavyatom': np.stack(mask_out),
    }
    seq_map = {(c, int(r), i): k for k, (c, r, i) in
               enumerate(zip(chain_id_out, resseq_out, icode_out))}
    return data, seq_map


def pdb_chain_ids(pdb_path: str) -> List[str]:
    """All chain ids present in the file (first model)."""
    return sorted(_read_pdb_residues(pdb_path).keys())


_ELEMENT = {'C': ' C', 'N': ' N', 'O': ' O', 'S': ' S'}


def save_pdb(data: Dict, path: Optional[str] = None) -> str:
    """Structure dict -> PDB text (optionally written to ``path``).

    Accepts the same keys as :func:`parse_pdb` output; ``mask`` (L,) or
    ``mask_heavyatom`` select which residues/atoms are emitted.
    """
    aa = np.asarray(data['aa']).astype(np.int64)
    L = aa.shape[0]
    pos = np.asarray(data['pos_heavyatom'], np.float64)
    mask_atoms = np.asarray(data['mask_heavyatom']).astype(bool)
    chain_id = data.get('chain_id', ['A'] * L)
    resseq = np.asarray(data.get('resseq', np.arange(1, L + 1)))
    icode = data.get('icode', [' '] * L)
    mask_res = np.asarray(data.get('mask', np.ones(L, bool))).astype(bool)

    lines = []
    serial = 1
    for i in range(L):
        if not mask_res[i] or aa[i] > 19:
            continue
        restype = AA(int(aa[i]))
        resname = ONE_TO_THREE[resindex_to_ressymb[int(aa[i])]]
        names = restype_to_heavyatom_names[restype]
        ic = icode[i] if icode[i].strip() else ' '
        for j, name in enumerate(names):
            if not name or not mask_atoms[i, j]:
                continue
            x, y, z = pos[i, j]
            element = _ELEMENT.get(name[0], ' ' + name[0])
            atom_field = f' {name:<3s}' if len(name) < 4 else name
            lines.append(
                f'ATOM  {serial:>5d} {atom_field}{"":1s}{resname:>3s} '
                f'{chain_id[i]:1s}{int(resseq[i]):>4d}{ic:1s}   '
                f'{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}'
                f'          {element:>2s}  ')
            serial += 1
        # Chain break marker at the end of each chain.
        is_last = (i == L - 1) or (chain_id[i] != chain_id[i + 1])
        if is_last:
            lines.append(f'TER   {serial:>5d}      {resname:>3s} '
                         f'{chain_id[i]:1s}{int(resseq[i]):>4d}{ic:1s}')
            serial += 1
    lines.append('END')
    text = '\n'.join(lines) + '\n'
    if path is not None:
        with open(path, 'w') as f:
            f.write(text)
    return text

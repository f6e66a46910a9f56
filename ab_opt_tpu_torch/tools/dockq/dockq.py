"""DockQ scoring: a native contact kernel and numpy superposition (the
port's own copy of ``ab_opt_tpu/tools/dockq/dockq.py``).

* contacts: inter-chain residue pairs with any-atom distance < cutoff
  (5 A for fnat, 10 A for the interface set), counted by the C++ cell-list
  kernel ``fnat_kernel.cc`` (built with ``g++`` at first use into the
  package's ``_build/``), or by its plain numpy version;
* irms: Kabsch superposition of interface backbone atoms (CA-only mode uses
  just CA, matching the runners' ``use_ca_only=True``);
* LRMS: superpose on the receptor (the chain group with more atoms), then
  plain rms of ligand atoms;
* DockQ = (fnat + 1/(1+(irms/1.5)^2) + 1/(1+(Lrms/8.5)^2)) / 3.

Residue correspondence: keys are (chain, resseq, icode). When the model and
native numbering disagree (externally-produced poses), the model's keys are
rebuilt by per-chain BLOSUM62 global alignment; the default ``'auto'``
aligns only when direct key matching looks wrong.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...constants import AA, restype_to_heavyatom_names
from ...data.pdb import parse_pdb

logger = logging.getLogger(__name__)

_SRC_PATH = Path(__file__).resolve().with_name('fnat_kernel.cc')
_BUILD_DIR = Path(__file__).resolve().parents[2] / '_build'
_GXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')
_lib = None


def library_path() -> Path:
    """Where the contact kernel is built: ``_build/`` of the package, named
    by a digest of the source and the compile flags."""
    h = hashlib.sha256(_SRC_PATH.read_bytes())
    h.update(' '.join(_GXX_FLAGS).encode())
    return _BUILD_DIR / f'fnat-{h.hexdigest()[:16]}.so'


def native_library():
    """The native contact kernel, built with ``g++`` at first use and
    loaded with ctypes; None if it cannot be built or loaded (a warning is
    logged once, and the numpy contact path runs instead)."""
    global _lib
    if _lib is not None:
        return _lib or None
    try:
        path = library_path()
        if not path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix='.so', dir=_BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(['g++', *_GXX_FLAGS, str(_SRC_PATH), '-o', tmp],
                               check=True, capture_output=True, text=True)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(path))
        lib.count_contacts.restype = ctypes.c_int
        lib.count_contacts.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        _lib = lib
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, 'stderr', '') or e
        logger.warning('DockQ: the native contact kernel %s did not build or '
                       'load (%s); contacts take the numpy path', _SRC_PATH,
                       detail)
        _lib = False
    return _lib or None


def _contacts(xyz_a, res_a, xyz_b, res_b, cutoff) -> set:
    lib = native_library()
    if lib is None:
        return _contacts_numpy(xyz_a, res_a, xyz_b, res_b, cutoff)
    _contacts.native_calls += 1
    max_pairs = 262144
    out = np.zeros((max_pairs, 2), np.int32)
    n = lib.count_contacts(
        xyz_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        res_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(res_a),
        xyz_b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        res_b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(res_b),
        ctypes.c_float(cutoff),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_pairs)
    return {(int(a), int(b)) for a, b in out[:min(n, max_pairs)]}


_contacts.native_calls = 0


def _contacts_numpy(xyz_a, res_a, xyz_b, res_b, cutoff) -> set:
    d2 = ((xyz_a[:, None, :] - xyz_b[None, :, :]) ** 2).sum(-1)
    ii, jj = np.nonzero(d2 < cutoff * cutoff)
    return {(int(res_a[i]), int(res_b[j])) for i, j in zip(ii, jj)}


def kabsch_rmsd(P: np.ndarray, Q: np.ndarray,
                apply_to: Optional[np.ndarray] = None):
    """Least-squares superposition of Q onto P. Returns (rmsd, transformed).

    P, Q: (N, 3). If ``apply_to`` is given, the fitted transform is applied
    to it and returned instead of Q.
    """
    pc, qc = P.mean(0), Q.mean(0)
    P0, Q0 = P - pc, Q - qc
    H = Q0.T @ P0
    U, S, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    Q_fit = Q0 @ R.T + pc
    rmsd = float(np.sqrt(((Q_fit - P) ** 2).sum() / len(P)))
    if apply_to is not None:
        return rmsd, (apply_to - qc) @ R.T + pc
    return rmsd, Q_fit


def plain_rmsd(P: np.ndarray, Q: np.ndarray) -> float:
    return float(np.sqrt(((P - Q) ** 2).sum() / len(P)))


class _Complex:
    """Two-chain-group view of a parsed structure, keyed by (chain, resseq,
    icode)."""

    def __init__(self, data, group_of: Dict[str, int]):
        self.keys: List[Tuple[str, int, str]] = []
        self.group = []
        atoms = {}
        L = data['aa'].shape[0]
        for i in range(L):
            key = (data['chain_id'][i], int(data['resseq'][i]), data['icode'][i])
            self.keys.append(key)
            self.group.append(group_of[data['chain_id'][i]])
            names = restype_to_heavyatom_names[AA(int(data['aa'][i]))]
            for j, name in enumerate(names):
                if name and data['mask_heavyatom'][i, j]:
                    atoms[key + (name,)] = data['pos_heavyatom'][i, j]
        self.atoms = atoms
        self.res_index = {k: i for i, k in enumerate(self.keys)}

    def atom_arrays(self, group: int):
        xyz, res = [], []
        for full_key, pos in self.atoms.items():
            key = full_key[:3]
            i = self.res_index[key]
            if self.group[i] == group:
                xyz.append(pos)
                res.append(i)
        return (np.asarray(xyz, np.float32).reshape(-1, 3),
                np.asarray(res, np.int32))


def _chain_groups(chain_ids_model: Sequence[str]) -> Dict[str, int]:
    """First chain = group 0 (antibody/ligand side), the rest = group 1.

    The reference assumes exactly two chains (DockQ.py:289-295); the runners'
    saved patches are CDR-chain + antigen chains, so we generalize to
    first-vs-rest while preserving two-chain behavior exactly.
    """
    uniq = list(dict.fromkeys(chain_ids_model))
    return {c: (0 if c == uniq[0] else 1) for c in uniq}


def _chain_seq_indices(data) -> Dict[str, List[int]]:
    """Residue indices per chain, in file order."""
    out: Dict[str, List[int]] = {}
    for i, c in enumerate(data['chain_id']):
        out.setdefault(c, []).append(i)
    return out


def _numbering_matches(model, native) -> bool:
    """True when direct (chain, resseq, icode) matching is trustworthy.

    Trust the keys when (a) the model/native key sets essentially coincide
    (two-sided overlap >= 0.995 — a designed pose saved against its own
    native patch matches exactly even though the *sequence* is mutated), or
    (b) most native keys resolve in the model AND carry the same amino acid
    there (catches shifted renumbering, where key overlap can be high but
    the sequence read through the keys is displaced)."""
    keys_m = {}
    for i in range(len(model['aa'])):
        k = (model['chain_id'][i], int(model['resseq'][i]), model['icode'][i])
        keys_m[k] = int(model['aa'][i])
    shared = same = 0
    for i in range(len(native['aa'])):
        k = (native['chain_id'][i], int(native['resseq'][i]),
             native['icode'][i])
        if k in keys_m:
            shared += 1
            same += int(keys_m[k] == int(native['aa'][i]))
    n_nat = max(len(native['aa']), 1)
    n_mod = max(len(keys_m), 1)
    if shared / n_nat >= 0.995 and shared / n_mod >= 0.995:
        return True
    return shared / n_nat >= 0.8 and same / max(shared, 1) >= 0.9


def _align_model_numbering(model, native):
    """Rewrite the model's residue keys to the native's via per-chain global
    sequence alignment (fix_numbering.pl semantics).

    Chains are paired by id when the chain sets match, otherwise greedily by
    alignment score. Model residues without an aligned native partner get
    sentinel keys (never matching a native key) so they still contribute
    non-native contacts to fnonnat.
    """
    from ...metrics import global_align_pairs

    model = dict(model)
    chains_m = _chain_seq_indices(model)
    chains_n = _chain_seq_indices(native)

    pair_cache = {}

    def aligned_pairs(cm_id, cn_id):
        key = (cm_id, cn_id)
        if key not in pair_cache:
            pair_cache[key] = global_align_pairs(
                model['aa'][chains_m[cm_id]], native['aa'][chains_n[cn_id]])
        return pair_cache[key]

    if set(chains_m) == set(chains_n):
        pairing = [(c, c) for c in chains_m]
    else:
        scored = []
        for cm_id in chains_m:
            for cn_id in chains_n:
                _, score = aligned_pairs(cm_id, cn_id)
                scored.append((score, cm_id, cn_id))
        scored.sort(reverse=True)
        pairing, used_m, used_n = [], set(), set()
        for _, cm_id, cn_id in scored:
            if cm_id in used_m or cn_id in used_n:
                continue
            pairing.append((cm_id, cn_id))
            used_m.add(cm_id)
            used_n.add(cn_id)

    chain_id = list(model['chain_id'])
    resseq = np.array(model['resseq'], np.int64, copy=True)
    icode = list(model['icode'])
    sentinel = -100000
    matched = np.zeros(len(chain_id), bool)
    for cm_id, cn_id in pairing:
        idx_m, idx_n = chains_m[cm_id], chains_n[cn_id]
        # The whole model chain takes its paired native chain's id — an
        # unmatched (inserted) residue must still land in its own chain's
        # group, or its intra-chain contacts would count as inter-group.
        for gi in idx_m:
            chain_id[gi] = cn_id
        pairs, _ = aligned_pairs(cm_id, cn_id)
        for i_m, j_n in pairs:
            gi, gj = idx_m[i_m], idx_n[j_n]
            resseq[gi] = int(native['resseq'][gj])
            icode[gi] = native['icode'][gj]
            matched[gi] = True
    for i in np.nonzero(~matched)[0]:
        resseq[i] = sentinel - int(i)
    model['chain_id'] = np.asarray(chain_id, dtype=model['chain_id'].dtype) \
        if isinstance(model['chain_id'], np.ndarray) else chain_id
    model['resseq'] = resseq
    model['icode'] = np.asarray(icode, dtype=model['icode'].dtype) \
        if isinstance(model['icode'], np.ndarray) else icode
    return model


def calc_dockq(model_path: str, native_path: str,
               use_ca_only: bool = False,
               align_numbering='auto') -> Dict[str, float]:
    """DockQ between a model and native complex (paths or pdb text).

    ``align_numbering``: True forces sequence-alignment-based residue
    correspondence, False trusts (chain, resseq, icode) keys, 'auto'
    (default) aligns only when direct matching looks wrong. Contacts are
    counted by the native kernel (each call adds one to
    ``_contacts.native_calls``) when it loaded, else by numpy.
    """
    model, _ = parse_pdb(model_path, is_text='\n' in model_path)
    native, _ = parse_pdb(native_path, is_text='\n' in native_path)

    if align_numbering is True or (
            align_numbering == 'auto'
            and not _numbering_matches(model, native)):
        model = _align_model_numbering(model, native)

    # Group from the native's chain order; chains only in the model (none
    # after alignment) fall into the 'rest' group.
    groups = _chain_groups(list(native['chain_id'])
                           + list(model['chain_id']))
    cm = _Complex(model, groups)
    cn = _Complex(native, groups)

    # --- fnat / fnonnat (all-atom contacts at 5 A) ------------------------- #
    def residue_contacts(cx: _Complex, cutoff: float) -> set:
        xyz0, res0 = cx.atom_arrays(0)
        xyz1, res1 = cx.atom_arrays(1)
        if len(res0) == 0 or len(res1) == 0:
            return set()
        pairs = _contacts(xyz0, res0, xyz1, res1, cutoff)
        # Map atom-level residue indices to (chain, resseq, icode) keys so the
        # model/native sets are comparable.
        return {(cx.keys[a], cx.keys[b]) for a, b in pairs}

    nat_5 = residue_contacts(cn, 5.0)
    mod_5 = residue_contacts(cm, 5.0)
    nat_correct = len(nat_5 & mod_5)
    nat_total = len(nat_5)
    nonnat = len(mod_5 - nat_5)
    model_total = len(mod_5)
    fnat = nat_correct / nat_total if nat_total else 0.0
    fnonnat = nonnat / model_total if model_total else 0.0

    # --- interface set (native contacts at 10 A) --------------------------- #
    nat_10 = residue_contacts(cn, 10.0)
    interface = set()
    for a, b in nat_10:
        interface.add(a)
        interface.add(b)

    sup_names = ('CA',) if use_ca_only else ('CA', 'C', 'N', 'O')

    def matched_coords(keys_filter):
        """Atom coords present in both structures, in native iteration order."""
        P, Q = [], []
        for key in cn.keys:
            if key not in cm.res_index or not keys_filter(key):
                continue
            for name in sup_names:
                kn, km = key + (name,), key + (name,)
                if kn in cn.atoms and km in cm.atoms:
                    P.append(cn.atoms[kn])
                    Q.append(cm.atoms[km])
        return np.asarray(P, np.float64), np.asarray(Q, np.float64)

    # irms: superposition over interface atoms. A native with no interface
    # contacts (e.g. screening against a badly-docked pose used as the
    # reference) has an empty interface set — score the model as maximally
    # wrong (irms -> inf => its DockQ term -> 0) instead of poisoning
    # downstream rankings with NaN.
    P_int, Q_int = matched_coords(lambda k: k in interface)
    if len(P_int) >= 3:
        irms, _ = kabsch_rmsd(P_int, Q_int)
    else:
        irms = float('inf')

    # LRMS: align receptor (larger group by matched atoms), measure ligand.
    P0, Q0 = matched_coords(lambda k: cn.group[cn.res_index[k]] == 0)
    P1, Q1 = matched_coords(lambda k: cn.group[cn.res_index[k]] == 1)
    if len(P0) > len(P1):
        P_rec, Q_rec, P_lig, Q_lig = P0, Q0, P1, Q1
    else:
        P_rec, Q_rec, P_lig, Q_lig = P1, Q1, P0, Q0
    if len(P_rec) >= 3 and len(P_lig) >= 1:
        _, Q_lig_fit = kabsch_rmsd(P_rec, Q_rec, apply_to=Q_lig)
        lrms = plain_rmsd(P_lig, Q_lig_fit)
    else:
        lrms = float('inf')

    # inf rms terms contribute 0 (1/(1+inf) == 0 under IEEE semantics).
    irms_term = 0.0 if np.isinf(irms) else 1.0 / (1 + (irms / 1.5) ** 2)
    lrms_term = 0.0 if np.isinf(lrms) else 1.0 / (1 + (lrms / 8.5) ** 2)
    dockq = (fnat + irms_term + lrms_term) / 3.0

    return {
        'DockQ': dockq, 'irms': irms, 'Lrms': lrms, 'fnat': fnat,
        'fnonnat': fnonnat, 'nat_correct': nat_correct, 'nat_total': nat_total,
        'nonnat_count': nonnat, 'model_total': model_total,
    }


def capri_class(dockq: float, fnat: float = None) -> str:
    """CAPRI quality class from DockQ (ref DockQ.py:51-95)."""
    if dockq < 0.23:
        return 'Incorrect'
    if dockq < 0.49:
        return 'Acceptable'
    if dockq < 0.80:
        return 'Medium'
    return 'High'

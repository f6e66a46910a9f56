"""The SAbDab dataset (the port's own copy of ``ab_opt_tpu/data/sabdab.py``):
the summary TSV filtered, each Chothia PDB preprocessed into a pickle
cache, the CDR sequences clustered, and the antigen-held-out and
dock-test splits.

The cache is a directory of per-entry pickles of numpy arrays and plain
Python (plus an ids index), the same files the JAX package writes, so
either package reads a ``processed_dir`` the other wrote. Preprocessing
fans out over a process pool; clustering runs mmseqs2 where the binary is
on the PATH and a greedy sequence-identity clusterer otherwise. The
split shuffles with ``random.Random(split_seed)`` as the JAX package does,
and :meth:`SAbDabDataset.get` draws each item's augmentation from
``numpy.random.default_rng((split_seed, index) + salt)``, so both packages
give the same split and the same items.
"""
from __future__ import annotations

import concurrent.futures
import datetime
import logging
import multiprocessing
import os
import pickle
import random
import shutil
import subprocess
from typing import Dict, List, Optional

import numpy as np

from .structures import label_heavy_chain_cdr, label_light_chain_cdr
from .pdb import ParsingException, parse_pdb
from .transforms import DISTVIOLATION
from ._registry import register_dataset

logger = logging.getLogger(__name__)

# Factual filter tables from the reference (sabdab.py:23-89).
ALLOWED_AG_TYPES = {
    'protein',
    'protein | protein',
    'protein | protein | protein',
    'protein | protein | protein | protein',
    'protein | protein | protein | protein | protein',
}
RESOLUTION_THRESHOLD = 4.0

TEST_ANTIGENS = [
    'sars-cov-2 receptor binding domain',
    'hiv-1 envelope glycoprotein gp160',
    'mers s',
    'influenza a virus',
    'cd27 antigen',
]

DOCK_TESTSETS = [
    '5mes_H_L_A', '1ic7_H_L_Y', '1ncb_H_L_N', '4lvn_C_B_A', '2adf_H_L_A',
    '4ydk_H_L_G', '1a2y_B_A_C', '3o2d_H_L_A', '1n8z_B_A_C', '4g6j_H_L_A',
    '1osp_H_L_O', '4fqj_H_L_A', '1uj3_B_A_C', '3uzq_A_a_B', '4h8w_H_L_G',
    '4dvr_H_L_G', '3s35_H_L_X', '3w9e_A_B_C', '5f9o_H_L_G', '1iqd_B_A_C',
    '4g6m_H_L_A', '3k2u_H_L_A', '4dtg_H_L_K', '5en2_A_B_C', '3mxw_H_L_A',
    '2dd8_H_L_S', '2ypv_H_L_A', '1a14_H_L_N', '4ffv_H_L_A', '3nid_E_F_C',
    '5ggs_C_D_Y', '3rkd_D_C_B', '4xnq_B_A_D', '2ghw_B_b_A', '2b2x_H_L_A',
    '4qci_H_L_C', '3l95_B_A_X', '3hi6_H_L_A', '3cx5_U_V_P', '5bv7_C_B_A',
    '4ki5_E_F_M', '5nuz_H_L_D', '3bn9_D_C_B', '1fe8_H_L_A',
]


def _nan_to_none(v):
    if v is None or v != v or not v:
        return None
    return v


def _split_delimited(v) -> List[str]:
    v = _nan_to_none(v)
    if v is None:
        return []
    return [s.strip() for s in str(v).split('|')]


def parse_sabdab_resolution(v) -> Optional[float]:
    if v is None or v == 'NOT' or v != v or not v:
        return None
    if isinstance(v, str) and ',' in v:
        return float(v.split(',')[0].strip())
    return float(v)


def load_sabdab_entries(summary_path: str) -> List[Dict]:
    """Parse + filter the SAbDab summary tsv (ref sabdab.py:297-345)."""
    import pandas as pd
    df = pd.read_csv(summary_path, sep='\t')
    entries = []
    for _, row in df.iterrows():
        ag_chains = _split_delimited(row.get('antigen_chain'))
        h = _nan_to_none(row.get('Hchain'))
        l = _nan_to_none(row.get('Lchain'))
        entry = {
            'id': '{}_{}_{}_{}'.format(row['pdb'], h or '', l or '',
                                       ''.join(ag_chains)),
            'pdbcode': row['pdb'],
            'H_chain': h,
            'L_chain': l,
            'ag_chains': ag_chains,
            'ag_type': _nan_to_none(row.get('antigen_type')),
            'ag_name': _nan_to_none(row.get('antigen_name')),
            'date': datetime.datetime.strptime(row['date'], '%m/%d/%y'),
            'resolution': parse_sabdab_resolution(row.get('resolution')),
            'method': row.get('method'),
            'scfv': row.get('scfv'),
        }
        if ((entry['ag_type'] in ALLOWED_AG_TYPES or entry['ag_type'] is None)
                and entry['resolution'] is not None
                and entry['resolution'] <= RESOLUTION_THRESHOLD):
            entries.append(entry)
    return entries


def preprocess_sabdab_structure(task: Dict) -> Optional[Dict]:
    """Parse one chothia PDB into {heavy, light, antigen} (ref :196-253)."""
    entry = task['entry']
    pdb_path = task['pdb_path']
    parsed = {'id': entry['id'], 'heavy': None, 'heavy_seqmap': None,
              'light': None, 'light_seqmap': None,
              'antigen': None, 'antigen_seqmap': None}
    try:
        if entry['H_chain'] is not None:
            parsed['heavy'], parsed['heavy_seqmap'] = label_heavy_chain_cdr(
                *parse_pdb(pdb_path, chain_ids=[entry['H_chain']],
                           max_resseq=113))
        if entry['L_chain'] is not None:
            parsed['light'], parsed['light_seqmap'] = label_light_chain_cdr(
                *parse_pdb(pdb_path, chain_ids=[entry['L_chain']],
                           max_resseq=106))
        if parsed['heavy'] is None and parsed['light'] is None:
            raise ValueError('Neither valid H-chain or L-chain is found.')
        if entry['ag_chains']:
            parsed['antigen'], parsed['antigen_seqmap'] = parse_pdb(
                pdb_path, chain_ids=entry['ag_chains'])
    except (ParsingException, KeyError, ValueError, FileNotFoundError) as e:
        logger.warning('[%s] %s: %s', task['id'], e.__class__.__name__, e)
        return None
    return parsed


# --------------------------------------------------------------------------- #
# CDR-sequence clustering (mmseqs2 or greedy fallback)
# --------------------------------------------------------------------------- #


def _identity(a: str, b: str) -> float:
    """Cheap un-gapped identity with end-sliding, adequate for short CDR3s."""
    if not a or not b:
        return 0.0
    if len(a) < len(b):
        a, b = b, a
    best = 0
    for off in range(len(a) - len(b) + 1):
        best = max(best, sum(x == y for x, y in zip(a[off:], b)))
    return best / len(a)


def greedy_cluster(seqs: Dict[str, str], min_identity: float = 0.5) -> Dict[str, str]:
    """Greedy centroid clustering at >= min_identity (mmseqs-like semantics).

    Returns id -> cluster_name (cluster name = representative id).
    """
    reps: List[str] = []
    assignment: Dict[str, str] = {}
    # Longest-first like mmseqs' cascaded clustering.
    for sid in sorted(seqs, key=lambda s: -len(seqs[s])):
        seq = seqs[sid]
        placed = False
        for rep in reps:
            if _identity(seq, seqs[rep]) >= min_identity:
                assignment[sid] = rep
                placed = True
                break
        if not placed:
            reps.append(sid)
            assignment[sid] = sid
    return assignment


def mmseqs_cluster(seqs: Dict[str, str], workdir: str,
                   min_identity: float = 0.5) -> Optional[Dict[str, str]]:
    """Cluster with mmseqs2 easy-cluster if available (ref :417-446)."""
    if shutil.which('mmseqs') is None:
        return None
    fasta = os.path.join(workdir, 'cdr_sequences.fasta')
    with open(fasta, 'w') as f:
        for sid, seq in seqs.items():
            f.write(f'>{sid}\n{seq}\n')
    subprocess.run(
        ['mmseqs', 'easy-cluster', os.path.realpath(fasta), 'cluster_result',
         'cluster_tmp', '--min-seq-id', str(min_identity), '-c', '0.8',
         '--cov-mode', '1'],
        cwd=workdir, check=True, capture_output=True)
    out = {}
    with open(os.path.join(workdir, 'cluster_result_cluster.tsv')) as f:
        for line in f:
            rep, sid = line.split()
            out[sid] = rep
    return out


# --------------------------------------------------------------------------- #
# Dataset
# --------------------------------------------------------------------------- #


class SAbDabDataset:
    def __init__(self, summary_path='./data/sabdab_summary_all.tsv',
                 chothia_dir='./data/all_structures/chothia',
                 processed_dir='./data/processed', split='train',
                 split_seed=2022, transform=None, reset=False,
                 must_have_antigen=False, num_workers: Optional[int] = None):
        if not os.path.exists(chothia_dir):
            raise FileNotFoundError(
                f'SAbDab structures not found in {chothia_dir}. Download from '
                'http://opig.stats.ox.ac.uk/webapps/newsabdab/sabdab/archive/all/')
        self.summary_path = summary_path
        self.chothia_dir = chothia_dir
        self.processed_dir = processed_dir
        self.must_have_antigen = must_have_antigen
        self.transform = transform
        os.makedirs(processed_dir, exist_ok=True)

        self.sabdab_entries = load_sabdab_entries(summary_path)
        self._load_structures(reset, num_workers)
        self._load_clusters(reset)
        self._load_split(split, split_seed)
        self.split_seed = split_seed
        self._rng = np.random.default_rng(split_seed)

    # ----------------------------------------------------------- structures

    @property
    def _cache_dir(self):
        return os.path.join(self.processed_dir, 'structures')

    @property
    def _ids_path(self):
        return os.path.join(self.processed_dir, 'structures-ids.pkl')

    def _entry_path(self, sid):
        return os.path.join(self._cache_dir, f'{sid}.pkl')

    def _load_structures(self, reset, num_workers):
        if not os.path.exists(self._ids_path) or reset:
            self._preprocess_structures(num_workers)
        with open(self._ids_path, 'rb') as f:
            self.db_ids = pickle.load(f)
        self.sabdab_entries = [e for e in self.sabdab_entries
                               if e['id'] in set(self.db_ids)]

    def _preprocess_structures(self, num_workers):
        os.makedirs(self._cache_dir, exist_ok=True)
        tasks = []
        for entry in self.sabdab_entries:
            pdb_path = os.path.join(self.chothia_dir, f"{entry['pdbcode']}.pdb")
            if not os.path.exists(pdb_path):
                logger.warning('PDB not found: %s', pdb_path)
                continue
            tasks.append({'id': entry['id'], 'entry': entry,
                          'pdb_path': pdb_path})

        workers = num_workers or max((os.cpu_count() or 2) // 2, 1)
        ids = []
        # forkserver: this process may run threads (torch's, a loader's),
        # and fork from it can deadlock.
        ctx = multiprocessing.get_context('forkserver')
        with concurrent.futures.ProcessPoolExecutor(workers,
                                                    mp_context=ctx) as ex:
            for task, data in zip(tasks, ex.map(preprocess_sabdab_structure,
                                                tasks, chunksize=8)):
                if data is None:
                    continue
                with open(self._entry_path(data['id']), 'wb') as f:
                    pickle.dump(data, f)
                ids.append(data['id'])
        with open(self._ids_path, 'wb') as f:
            pickle.dump(ids, f)
        logger.info('Preprocessed %d/%d SAbDab structures', len(ids), len(tasks))

    def get_structure(self, sid):
        with open(self._entry_path(sid), 'rb') as f:
            return pickle.load(f)

    # ------------------------------------------------------------- clusters

    @property
    def _cluster_path(self):
        return os.path.join(self.processed_dir, 'cluster_result_cluster.tsv')

    def _load_clusters(self, reset):
        if not os.path.exists(self._cluster_path) or reset:
            self._create_clusters()
        clusters, id_to_cluster = {}, {}
        with open(self._cluster_path) as f:
            for line in f:
                rep, sid = line.split()
                clusters.setdefault(rep, []).append(sid)
                id_to_cluster[sid] = rep
        self.clusters = clusters
        self.id_to_cluster = id_to_cluster

    def _create_clusters(self):
        seqs = {}
        for sid in self.db_ids:
            s = self.get_structure(sid)
            if s['heavy'] is not None:
                seqs[sid] = s['heavy']['H3_seq']
            elif s['light'] is not None:
                seqs[sid] = s['light']['L3_seq']
        assignment = mmseqs_cluster(seqs, self.processed_dir)
        if assignment is None:
            logger.info('mmseqs2 not found; using greedy CDR clustering')
            assignment = greedy_cluster(seqs)
        with open(self._cluster_path, 'w') as f:
            for sid, rep in assignment.items():
                f.write(f'{rep}\t{sid}\n')

    # ---------------------------------------------------------------- split

    def _load_split(self, split, split_seed):
        # The wet-experiment config (AbDock/configs/train/
        # dock_single_wet_experiment.yml) names *_4_wet_experiment splits
        # that the reference's own dataset never implements
        # (AbDock/src/datasets/sabdab.py:450 asserts the four base names);
        # accept them as documented aliases so the config is runnable.
        split = {'train_4_wet_experiment': 'train',
                 'val_4_wet_experiment': 'val'}.get(split, split)
        assert split in ('train', 'val', 'test', 'dock_test')
        ids_test = [e['id'] for e in self.sabdab_entries
                    if e['ag_name'] in TEST_ANTIGENS]
        test_clusters = {self.id_to_cluster[i] for i in ids_test}
        ids_docktest = [e['id'] for e in self.sabdab_entries
                        if e['id'] in set(DOCK_TESTSETS)]
        dock_clusters = {self.id_to_cluster[i] for i in ids_docktest}
        ids_train_val = [
            e['id'] for e in self.sabdab_entries
            if self.id_to_cluster[e['id']] not in test_clusters
            and self.id_to_cluster[e['id']] not in dock_clusters]
        random.Random(split_seed).shuffle(ids_train_val)
        self.ids_in_split = {
            'test': ids_test,
            'dock_test': ids_docktest,
            'val': ids_train_val[:20],
            'train': ids_train_val[20:],
        }[split]

    # ------------------------------------------------------------- get item

    def __len__(self):
        return len(self.ids_in_split)

    def get(self, index, salt: tuple = (0, 0)):
        """Deterministic fetch: augmentation rng keyed by (seed, idx, salt)
        — the DataLoader passes (epoch, attempt), so the stream does not
        depend on pool-worker scheduling or per-process rng state."""
        sid = self.ids_in_split[index]
        data = self.get_structure(sid)
        if self.must_have_antigen and data.get('antigen') is None:
            return self.get((index + 1) % len(self), salt)
        if self.transform is not None:
            # DISTVIOLATION propagates; the DataLoader resamples a neighbor.
            rng = np.random.default_rng(
                (self.split_seed, index) + tuple(salt))
            data = self.transform(data, rng=rng)
        return data

    def __getitem__(self, index):
        sid = self.ids_in_split[index]
        data = self.get_structure(sid)
        if self.must_have_antigen and data.get('antigen') is None:
            return self[(index + 1) % len(self)]
        if self.transform is not None:
            # DISTVIOLATION propagates; the DataLoader resamples a neighbor.
            data = self.transform(data, rng=self._rng)
        return data


@register_dataset('sabdab')
def build_sabdab_dataset(cfg, transform):
    return SAbDabDataset(
        summary_path=cfg['summary_path'],
        chothia_dir=cfg['chothia_dir'],
        processed_dir=cfg['processed_dir'],
        split=cfg['split'],
        split_seed=cfg.get('split_seed', 2022),
        transform=transform,
        must_have_antigen=cfg.get('must_have_antigen', False),
    )


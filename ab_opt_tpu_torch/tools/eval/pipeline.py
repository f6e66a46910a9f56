"""Evaluation task pipeline over (relaxed) design results; the port's own
copy of ``ab_opt_tpu/tools/eval/pipeline.py``.

Scan a results tree for sample PDBs, score similarity (and, optionally,
interface energy), keep the visited tasks in a pickle db and write
summary.csv. A db the JAX package wrote names its ``EvalTask`` class by
the JAX module's path; :class:`_EvalDbUnpickler` reads it as the port's
class without importing the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import pickle
import re
from typing import Dict, List, Optional, Tuple

from .energy import eval_interface_energy, pyrosetta_available
from .similarity import eval_similarity

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class EvalTask:
    in_path: str
    ref_path: str
    info: dict
    structure: str
    name: str
    method: str
    cdr: str
    ab_chains: List[str]
    residue_first: Optional[Tuple] = None
    residue_last: Optional[Tuple] = None
    scores: dict = dataclasses.field(default_factory=dict)

    def to_report_dict(self) -> Dict:
        return {'method': self.method, 'structure': self.structure,
                'cdr': self.cdr, 'filename': os.path.basename(self.in_path),
                **self.scores}


class _EvalDbUnpickler(pickle.Unpickler):
    """Reads an evaluation db of either package: the JAX package's
    ``EvalTask`` becomes the port's; no other class of it is read."""

    def find_class(self, module, name):
        if module == 'ab_opt_tpu.tools.eval.pipeline' and name == 'EvalTask':
            return EvalTask
        if module.split('.')[0] == 'ab_opt_tpu':
            raise pickle.UnpicklingError(
                f'the evaluation db holds {module}.{name}, which the port '
                'cannot read')
        return super().find_class(module, name)


def _load_db(db_path: str) -> Dict:
    with open(db_path, 'rb') as f:
        return _EvalDbUnpickler(f).load()


class EvalTaskScanner:
    """Scan results trees for sample PDBs to score."""

    def __init__(self, root: str, postfix: str = '', db_path: Optional[str] = None):
        self.root = root
        self.postfix = postfix
        self.db_path = db_path
        self.visited = set()
        if db_path and os.path.exists(db_path):
            self.visited = set(_load_db(db_path).keys())

    def scan(self) -> List[EvalTask]:
        if self.postfix:
            pat = re.compile(r'^\d+\_%s\.pdb$' % self.postfix)
        else:
            pat = re.compile(r'^\d+\.pdb$')
        tasks = []
        for parent, _, files in os.walk(self.root):
            fset = set(files)
            ref = ('REF1_%s.pdb' % self.postfix if self.postfix else 'REF1.pdb')
            if ref not in fset:
                ref = 'REF1.pdb' if 'REF1.pdb' in fset else None
            for fname in files:
                if not pat.match(fname):
                    continue
                fpath = os.path.join(parent, fname)
                if fpath in self.visited or ref is None:
                    continue
                info = self._metadata(fpath)
                tasks.append(EvalTask(
                    in_path=fpath, ref_path=os.path.join(parent, ref),
                    info=info, structure=info.get('structure', ''),
                    name=os.path.splitext(fname)[0],
                    method=info.get('method', ''),
                    cdr=os.path.basename(parent),
                    ab_chains=info.get('ab_chains', []),
                    residue_first=info.get('residue_first'),
                    residue_last=info.get('residue_last')))
                self.visited.add(fpath)
        return tasks

    @staticmethod
    def _metadata(fpath: str) -> dict:
        json_path = os.path.join(os.path.dirname(os.path.dirname(fpath)),
                                 'metadata.json')
        tag = os.path.basename(os.path.dirname(fpath))
        try:
            with open(json_path) as f:
                metadata = json.load(f)
            for item in metadata.get('items', []):
                if item.get('tag') == tag:
                    return item
        except (json.JSONDecodeError, FileNotFoundError):
            pass
        return {}


def evaluate_task(task: EvalTask, with_energy: bool = False) -> EvalTask:
    try:
        task.scores.update(eval_similarity(
            task.in_path, task.ref_path, task.residue_first, task.residue_last))
        if with_energy and task.ab_chains and pyrosetta_available():
            task.scores['dG_separated'] = eval_interface_energy(
                task.in_path, task.ab_chains)
    except Exception as e:
        logger.warning('eval failed for %s: %s', task.in_path, e)
    return task


def evaluate_directory(root: str, postfix: str = '',
                       with_energy: bool = False,
                       db_path: Optional[str] = None):
    """Score every unvisited sample under ``root``; writes summary.csv and
    returns it as a DataFrame."""
    import pandas as pd
    db_path = db_path or os.path.join(root, 'evaluation_db.pkl')
    scanner = EvalTaskScanner(root, postfix, db_path)
    tasks = [evaluate_task(t, with_energy) for t in scanner.scan()]

    db = _load_db(db_path) if os.path.exists(db_path) else {}
    for t in tasks:
        db[t.in_path] = t
    with open(db_path, 'wb') as f:
        pickle.dump(db, f)

    rows = [t.to_report_dict() for t in db.values() if t.scores]
    df = pd.DataFrame(rows)
    df.to_csv(os.path.join(root, 'summary.csv'), index=False)
    return df

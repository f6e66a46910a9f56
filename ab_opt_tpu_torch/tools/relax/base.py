"""Filesystem-resumable relax task pipeline; the port's own copy of
``ab_opt_tpu/tools/relax/base.py``.

The RelaxTask state machine and the TaskScanner (finished outputs skipped
by their filename tag, empty files removed) run each pose through the
stage chain on a host process pool: relaxation is CPU physics (OpenMM,
PyRosetta), not tensor work, so it never touches the card.

OpenMM and PyRosetta are optional: importing this module never fails, and
``relax_directory`` raises a RuntimeError when a backend it needs is
missing.

The JAX package hands the pool a function nested in ``run_pipeline``,
which a process pool cannot pickle, so its pool path raises
AttributeError; here the worker is the module-level :func:`_run_stages`,
and the serial path (``max_workers=0``) and every result are the same.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import json
import logging
import multiprocessing
import os
import re
from typing import Callable, List, Optional, Tuple

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class RelaxTask:
    in_path: str
    current_path: str
    info: dict
    status: str = 'created'
    flexible_residue_first: Optional[Tuple] = None
    flexible_residue_last: Optional[Tuple] = None

    def path_with_tag(self, tag: str) -> str:
        name, ext = os.path.splitext(self.in_path)
        return f'{name}_{tag}{ext}'

    def set_current_path_tag(self, tag: str) -> str:
        self.current_path = self.path_with_tag(tag)
        return self.current_path

    def check_current_path_exists(self) -> bool:
        if not os.path.exists(self.current_path):
            self.status = 'failed'
            return False
        if os.path.getsize(self.current_path) == 0:
            self.status = 'failed'
            os.unlink(self.current_path)
            return False
        return True

    def update_if_finished(self, tag: str) -> bool:
        out = self.path_with_tag(tag)
        if os.path.exists(out) and os.path.getsize(out) > 0:
            self.set_current_path_tag(tag)
            self.status = 'success'
            return True
        return False

    def can_proceed(self) -> bool:
        self.check_current_path_exists()
        return self.status != 'failed'


class TaskScanner:
    """Scan a results tree for pose PDBs to relax (NNNN.pdb / REFn.pdb),
    skipping already-finished outputs by filename tag."""

    INPUT_PATTERN = re.compile(r'^(?!.*patch)(\d+\.pdb|REF\d\.pdb)$')

    def __init__(self, root: str, final_postfix: Optional[str] = None):
        self.root = root
        self.final_postfix = final_postfix
        self.visited = set()

    def _metadata(self, fpath: str) -> Optional[dict]:
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

    def scan(self) -> List[RelaxTask]:
        tasks = []
        for parent, _, files in os.walk(self.root):
            for fname in files:
                if not self.INPUT_PATTERN.match(fname):
                    continue
                fpath = os.path.join(parent, fname)
                if os.path.getsize(fpath) == 0 or fpath in self.visited:
                    continue
                if self.final_postfix is not None:
                    name, ext = os.path.splitext(fpath)
                    if os.path.exists(f'{name}_{self.final_postfix}{ext}'):
                        continue
                info = self._metadata(fpath) or {}
                tasks.append(RelaxTask(
                    in_path=fpath, current_path=fpath, info=info,
                    flexible_residue_first=info.get('residue_first'),
                    flexible_residue_last=info.get('residue_last')))
                self.visited.add(fpath)
        return tasks


def available_backends() -> dict:
    out = {}
    try:
        import openmm                      # noqa: F401
        import pdbfixer                    # noqa: F401
        out['openmm'] = True
    except ImportError:
        out['openmm'] = False
    try:
        import pyrosetta                   # noqa: F401
        out['pyrosetta'] = True
    except ImportError:
        out['pyrosetta'] = False
    return out


def _run_stages(task: RelaxTask, stages: List[Callable]) -> RelaxTask:
    """One task through the stage chain, stopping at the first failure."""
    for stage in stages:
        task = stage(task)
        if task.status == 'failed':
            break
    return task


def run_pipeline(tasks: List[RelaxTask], stages: List[Callable],
                 max_workers: Optional[int] = None) -> List[RelaxTask]:
    """Run each task through the stage chain: serially for
    ``max_workers=0``, else on a pool of that many spawned processes
    (``None``: one a CPU). Stages must be module-level functions."""
    run_one = functools.partial(_run_stages, stages=stages)
    if max_workers == 0:
        return [run_one(t) for t in tasks]
    with concurrent.futures.ProcessPoolExecutor(
            max_workers, mp_context=multiprocessing.get_context('spawn')) as ex:
        return list(ex.map(run_one, tasks))


def relax_directory(root: str, pipeline: str = 'openmm_pyrosetta',
                    max_workers: Optional[int] = None) -> List[RelaxTask]:
    """Relax every unfinished pose under ``root``. Raises if no backend."""
    backends = available_backends()
    stages: List[Callable] = []
    if 'openmm' in pipeline:
        if not backends['openmm']:
            raise RuntimeError(
                'OpenMM/pdbfixer not installed; relaxation is an optional '
                'plug-in (see ab_opt_tpu_torch.tools.relax).')
        from .openmm_relaxer import run_openmm
        stages.append(run_openmm)
    if 'pyrosetta' in pipeline:
        if not backends['pyrosetta']:
            raise RuntimeError(
                'PyRosetta not installed; relaxation is an optional plug-in.')
        from .pyrosetta_relaxer import run_pyrosetta
        stages.append(run_pyrosetta)
    final_tag = 'rosetta' if 'pyrosetta' in pipeline else 'openmm'
    tasks = TaskScanner(root, final_postfix=final_tag).scan()
    return run_pipeline(tasks, stages, max_workers)

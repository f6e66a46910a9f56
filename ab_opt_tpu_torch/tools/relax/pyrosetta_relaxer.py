"""PyRosetta FastRelax (optional plug-in); the port's own copy of
``ab_opt_tpu/tools/relax/pyrosetta_relaxer.py``.

Behavioral rewrite of ``AbDock/src/tools/relax/pyrosetta_relaxer.py:74-187``:
FastRelax with a MoveMap restricted to the flexible residue range (+ spatial
neighbors), repack-only sidechains elsewhere; plus a backbone-fixed
(``fixbb``) repack variant. Only imported when PyRosetta is installed.
"""
from __future__ import annotations

import logging

from .base import RelaxTask

logger = logging.getLogger(__name__)

_INITIALIZED = False


def _init_pyrosetta():
    global _INITIALIZED
    if not _INITIALIZED:
        import pyrosetta
        pyrosetta.init(' '.join([
            '-mute', 'all', '-use_input_sc', '-ignore_unrecognized_res',
            '-ignore_zero_occupancy', 'false', '-load_PDB_components', 'false',
            '-relax:default_repeats', '2', '-no_fconfig',
        ]))
        _INITIALIZED = True


def _flexible_selector(pose, first, last):
    """Residue selector for the flexible range + 8A neighborhood."""
    from pyrosetta.rosetta.core.select import residue_selector as rs
    if first is None or last is None:
        return rs.TrueResidueSelector(), rs.TrueResidueSelector()
    chain, r0, _ = first
    _, r1, _ = last
    span = rs.ResidueIndexSelector()
    info = pose.pdb_info()
    for i in range(1, pose.total_residue() + 1):
        if info.chain(i) == chain and r0 <= info.number(i) <= r1:
            span.append_index(i)
    nbr = rs.NeighborhoodResidueSelector(span, 8.0, True)
    return span, nbr


def relax_pose(pdb_path: str, out_path: str, flexible_first=None,
               flexible_last=None, fix_backbone: bool = False) -> float:
    import pyrosetta
    from pyrosetta.rosetta.core.kinematics import MoveMap
    from pyrosetta.rosetta.core.pack.task import TaskFactory, operation
    from pyrosetta.rosetta.protocols.relax import FastRelax

    _init_pyrosetta()
    pose = pyrosetta.pose_from_pdb(pdb_path)
    scorefxn = pyrosetta.get_fa_scorefxn()

    span, nbr = _flexible_selector(pose, flexible_first, flexible_last)
    span_vec = span.apply(pose)
    nbr_vec = nbr.apply(pose)

    mm = MoveMap()
    mm.set_bb(False)
    mm.set_chi(False)
    for i in range(1, pose.total_residue() + 1):
        if span_vec[i] and not fix_backbone:
            mm.set_bb(i, True)
        if nbr_vec[i]:
            mm.set_chi(i, True)

    tf = TaskFactory()
    tf.push_back(operation.InitializeFromCommandline())
    tf.push_back(operation.RestrictToRepacking())   # no design, repack only

    relax = FastRelax()
    relax.set_scorefxn(scorefxn)
    relax.set_movemap(mm)
    relax.set_task_factory(tf)
    relax.apply(pose)

    pose.dump_pdb(out_path)
    return float(scorefxn(pose))


def run_pyrosetta(task: RelaxTask) -> RelaxTask:
    if not task.can_proceed():
        return task
    if task.update_if_finished('rosetta'):
        return task
    try:
        out = task.path_with_tag('rosetta')
        relax_pose(task.current_path, out, task.flexible_residue_first,
                   task.flexible_residue_last)
        task.set_current_path_tag('rosetta')
        task.status = 'success'
    except Exception as e:
        logger.warning('PyRosetta relax failed for %s: %s', task.in_path, e)
        task.status = 'failed'
    return task


def run_pyrosetta_fixbb(task: RelaxTask) -> RelaxTask:
    if not task.can_proceed():
        return task
    if task.update_if_finished('fixbb'):
        return task
    try:
        out = task.path_with_tag('fixbb')
        relax_pose(task.current_path, out, task.flexible_residue_first,
                   task.flexible_residue_last, fix_backbone=True)
        task.set_current_path_tag('fixbb')
        task.status = 'success'
    except Exception as e:
        logger.warning('PyRosetta fixbb failed for %s: %s', task.in_path, e)
        task.status = 'failed'
    return task

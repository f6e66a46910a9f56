"""Evaluation of design results (counterpart of ``ab_opt_tpu/tools/eval``):
CDR RMSD and sequence identity, optional interface energy, and the
resumable task pipeline that writes summary.csv."""
from .pipeline import EvalTask, EvalTaskScanner, evaluate_directory
from .similarity import eval_similarity, reslist_rmsd
from .energy import eval_interface_energy, pyrosetta_available

__all__ = ['EvalTask', 'EvalTaskScanner', 'evaluate_directory',
           'eval_similarity', 'reslist_rmsd', 'eval_interface_energy',
           'pyrosetta_available']

"""Relaxation of designed poses (counterpart of ``ab_opt_tpu/tools/relax``):
the resumable task pipeline over the optional OpenMM and PyRosetta
backends."""
from .base import (
    RelaxTask,
    TaskScanner,
    available_backends,
    relax_directory,
    run_pipeline,
)

__all__ = ['RelaxTask', 'TaskScanner', 'available_backends',
           'relax_directory', 'run_pipeline']

"""Host-side tools (counterpart of ``ab_opt_tpu/tools``): Chothia
renumbering, DockQ, evaluation, relaxation and HDock.

Heavy third-party backends (OpenMM, PyRosetta, AbNumber, hdock) are
optional plug-ins: the modules import without them and raise informative
errors when invoked.
"""
from . import dockq  # noqa: F401

__all__ = ['dockq']

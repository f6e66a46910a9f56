"""Runners (counterpart of ``ab_opt_tpu/runners``): the design runner, the
test-set runner and the 3-stage optimization pipeline. design-dock
(``runners/design_dock.py``) and the training CLI (``runners/train_cli.py``)
are imported by their module paths."""
from .design import (
    BatchedSampler,
    DesignArgs,
    create_data_variants,
    design_for_pdb,
    find_cdrs,
    load_model_from_checkpoint,
)
from .optimize import OptimizeArgs, optimize_antibody, scan_poses
from .testset import aggregate_results, design_for_testset

__all__ = [k for k in dir() if not k.startswith('_')]

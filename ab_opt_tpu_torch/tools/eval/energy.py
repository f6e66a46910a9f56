"""PyRosetta interface energy (optional plug-in); the port's own copy of
``ab_opt_tpu/tools/eval/energy.py``: InterfaceAnalyzerMover's
dG_separated between the antibody chains and the rest of the complex.
PyRosetta is imported only when a function needs it.
"""
from __future__ import annotations

from typing import Sequence


def pyrosetta_available() -> bool:
    try:
        import pyrosetta   # noqa: F401
        return True
    except ImportError:
        return False


def eval_interface_energy(pdb_path: str, ab_chains: Sequence[str]) -> float:
    """dG_separated of the antibody/antigen interface (kcal/mol)."""
    import pyrosetta
    from pyrosetta.rosetta.protocols.analysis import InterfaceAnalyzerMover
    from .._pyrosetta_init import ensure_init
    ensure_init()

    pose = pyrosetta.pose_from_pdb(pdb_path)
    # Interface definition: antibody chains vs everything else, e.g. "HL_A".
    all_chains = {pose.pdb_info().chain(i)
                  for i in range(1, pose.total_residue() + 1)}
    ag_chains = sorted(all_chains - set(ab_chains))
    interface = '{}_{}'.format(''.join(sorted(ab_chains)), ''.join(ag_chains))

    mover = InterfaceAnalyzerMover(interface)
    mover.set_pack_separated(True)
    mover.apply(pose)
    return float(pose.scores['dG_separated'])

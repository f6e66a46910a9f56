"""OpenMM restrained minimization (optional plug-in); the port's own copy
of ``ab_opt_tpu/tools/relax/openmm_relaxer.py``.

Behavioral rewrite of ``AbDock/src/tools/relax/openmm_relaxer.py:26-143``:
pdbfixer cleanup -> amber99sb implicit setup -> harmonic positional
restraints (k = 10 kcal/mol/A^2) on heavy atoms outside the flexible
residue range -> L-BFGS minimization -> PDB with energy REMARKs.

Only imported when OpenMM + pdbfixer are installed.
"""
from __future__ import annotations

import io
import logging

from .base import RelaxTask

logger = logging.getLogger(__name__)


def _in_flexible_range(chain_id, resseq, icode, first, last):
    if first is None or last is None:
        return False
    c0, r0, i0 = first
    c1, r1, i1 = last
    if chain_id != c0:
        return False
    return r0 <= resseq <= r1


class OpenMMRelaxer:
    def __init__(self, stiffness: float = 10.0, tolerance: float = 2.39,
                 max_iterations: int = 0, platform: str = 'CPU'):
        import openmm
        from openmm import app, unit
        self.openmm, self.app, self.unit = openmm, app, unit
        self.stiffness = stiffness
        self.tolerance = tolerance
        self.max_iterations = max_iterations
        self.platform = platform

    def relax(self, pdb_path: str, out_path: str,
              flexible_first=None, flexible_last=None) -> float:
        import pdbfixer
        app, unit, openmm = self.app, self.unit, self.openmm

        fixer = pdbfixer.PDBFixer(filename=pdb_path)
        fixer.findMissingResidues()
        fixer.findMissingAtoms()
        fixer.addMissingAtoms()
        fixer.addMissingHydrogens(7.0)

        ff = app.ForceField('amber99sb.xml', 'tip3p.xml')
        modeller = app.Modeller(fixer.topology, fixer.positions)
        system = ff.createSystem(modeller.topology,
                                 constraints=app.HBonds,
                                 nonbondedMethod=app.NoCutoff)

        # Restrain heavy atoms of non-flexible residues.
        force = openmm.CustomExternalForce(
            '0.5 * k * ((x-x0)^2 + (y-y0)^2 + (z-z0)^2)')
        force.addGlobalParameter(
            'k', self.stiffness * unit.kilocalories_per_mole / unit.angstroms**2)
        for p in ('x0', 'y0', 'z0'):
            force.addPerParticleParameter(p)
        for atom, pos in zip(modeller.topology.atoms(), modeller.positions):
            res = atom.residue
            flexible = _in_flexible_range(
                res.chain.id, int(res.id), ' ', flexible_first, flexible_last)
            if atom.element.symbol != 'H' and not flexible:
                force.addParticle(atom.index, pos.value_in_unit(unit.nanometers))
        system.addForce(force)

        integrator = openmm.LangevinIntegrator(0, 0.01, 0.0)
        platform = openmm.Platform.getPlatformByName(self.platform)
        sim = app.Simulation(modeller.topology, system, integrator, platform)
        sim.context.setPositions(modeller.positions)

        e0 = sim.context.getState(getEnergy=True).getPotentialEnergy()
        sim.minimizeEnergy(
            tolerance=self.tolerance * unit.kilocalories_per_mole,
            maxIterations=self.max_iterations)
        state = sim.context.getState(getEnergy=True, getPositions=True)
        e1 = state.getPotentialEnergy()

        buf = io.StringIO()
        app.PDBFile.writeFile(modeller.topology, state.getPositions(), buf)
        with open(out_path, 'w') as f:
            f.write(f'REMARK   1 ENERGY BEFORE MINIMIZATION: {e0}\n')
            f.write(f'REMARK   1 ENERGY AFTER  MINIMIZATION: {e1}\n')
            f.write(buf.getvalue())
        return e1.value_in_unit(self.unit.kilojoule_per_mole)


_RELAXER = None


def run_openmm(task: RelaxTask) -> RelaxTask:
    """Pipeline stage: <name>.pdb -> <name>_openmm.pdb."""
    global _RELAXER
    if not task.can_proceed():
        return task
    if task.update_if_finished('openmm'):
        return task
    try:
        if _RELAXER is None:
            _RELAXER = OpenMMRelaxer()
        out = task.path_with_tag('openmm')
        _RELAXER.relax(task.current_path, out,
                       task.flexible_residue_first, task.flexible_residue_last)
        task.set_current_path_tag('openmm')
        task.status = 'success'
    except Exception as e:
        logger.warning('OpenMM relax failed for %s: %s', task.in_path, e)
        task.status = 'failed'
    return task

"""HDock global docking wrapper (external-binary plug-in); the port's own
copy of ``ab_opt_tpu/tools/hdock.py``.

A subprocess wrapper around the ``hdock``/``createpl`` binaries;
``HDockAntibody`` constrains the CDR-H3 ligand site (Chothia 95-102) and
optional epitope receptor sites. Host code: it runs nothing on a device.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import List, Optional

from ..constants import ChothiaCDRRange


def hdock_available() -> bool:
    return (shutil.which('hdock') is not None
            and shutil.which('createpl') is not None)


class HDock:
    """Base docking session in a temp directory (ref hdock.py:26-96)."""

    def __init__(self, hdock_bin: str = 'hdock', createpl_bin: str = 'createpl'):
        if not hdock_available():
            raise RuntimeError(
                'hdock/createpl binaries not found on PATH; HDock is an '
                'external-tool plug-in (http://huanglab.phys.hust.edu.cn/software/hdock/)')
        self.hdock_bin = hdock_bin
        self.createpl_bin = createpl_bin
        self.tmpdir = tempfile.mkdtemp(prefix='hdock_')
        self._receptor = None
        self._ligand = None
        self._lsite: Optional[str] = None
        self._rsite: Optional[str] = None

    def set_receptor(self, pdb_path: str):
        self._receptor = os.path.join(self.tmpdir, 'receptor.pdb')
        shutil.copyfile(pdb_path, self._receptor)

    def set_ligand(self, pdb_path: str):
        self._ligand = os.path.join(self.tmpdir, 'ligand.pdb')
        shutil.copyfile(pdb_path, self._ligand)

    def _dump_sites(self):
        if self._lsite:
            with open(os.path.join(self.tmpdir, 'lsite.txt'), 'w') as f:
                f.write(self._lsite)
        if self._rsite:
            with open(os.path.join(self.tmpdir, 'rsite.txt'), 'w') as f:
                f.write(self._rsite)

    def dock(self, num_poses: int = 10) -> List[str]:
        """Run hdock + createpl; returns per-pose PDB paths."""
        assert self._receptor and self._ligand
        self._dump_sites()
        cmd = [self.hdock_bin, 'receptor.pdb', 'ligand.pdb', '-out', 'Hdock.out']
        if self._lsite:
            cmd += ['-lsite', 'lsite.txt']
        if self._rsite:
            cmd += ['-rsite', 'rsite.txt']
        subprocess.run(cmd, cwd=self.tmpdir, check=True, capture_output=True)
        subprocess.run(
            [self.createpl_bin, 'Hdock.out', 'top%d.pdb' % num_poses,
             '-nmax', str(num_poses), '-complex', '-models'],
            cwd=self.tmpdir, check=True, capture_output=True)
        poses = []
        for i in range(1, num_poses + 1):
            p = os.path.join(self.tmpdir, f'model_{i}.pdb')
            if os.path.exists(p):
                poses.append(p)
        return poses

    def cleanup(self):
        shutil.rmtree(self.tmpdir, ignore_errors=True)


class HDockAntibody(HDock):
    """Antibody-specific session: ligand site pinned to CDR-H3
    (ref hdock.py:99-157)."""

    def set_antigen(self, pdb_path: str, epitope_sites: Optional[List] = None):
        self.set_receptor(pdb_path)
        if epitope_sites:
            self._rsite = ', '.join(f'{r}:{c}' for r, c in epitope_sites)

    def set_antibody(self, pdb_path: str, heavy_id: str = 'H'):
        self.set_ligand(pdb_path)
        lo, hi = ChothiaCDRRange.H3
        self._lsite = ', '.join(f'{r}:{heavy_id}' for r in range(lo, hi + 1))

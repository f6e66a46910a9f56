"""Protein constants the port uses: the heavy-atom slots, the amino-acid
code range, and the idealized backbone geometry.

The port's own copy of the parts of ``ab_opt_tpu/constants.py`` it needs
(the same tables, built by the same code), so that the port imports
nothing of the JAX package.
"""
from __future__ import annotations

import enum

import numpy as np


class BBHeavyAtom(enum.IntEnum):
    N = 0; CA = 1; C = 2; O = 3; CB = 4; OXT = 14


AA_UNK = 20          # 'X'
MAX_AA_TYPES = 22    # incl. UNK + PAD slots used by embeddings

# Three-letter residue names in code order (A C D E F G H I K L M N P Q R S
# T V W Y); code 20 is UNK.
_RESTYPES = ('ALA', 'CYS', 'ASP', 'GLU', 'PHE', 'GLY', 'HIS', 'ILE', 'LYS',
             'LEU', 'MET', 'ASN', 'PRO', 'GLN', 'ARG', 'SER', 'THR', 'VAL',
             'TRP', 'TYR')

# In the CA-centered local frame every backbone atom lies in the z=0 plane:
#   N = (nx, ny, 0), CA = (0, 0, 0), C = (cx, 0, 0), O = (ox, oy, 0),
# so each residue type stores (nx, ny, cx, ox, oy).
_IDEAL_BB = {
    'ALA': (-0.525, 1.363, 1.526, 2.153, -1.062),
    'ARG': (-0.524, 1.362, 1.525, 2.151, -1.062),
    'ASN': (-0.536, 1.357, 1.526, 2.151, -1.062),
    'ASP': (-0.525, 1.362, 1.527, 2.153, -1.062),
    'CYS': (-0.522, 1.362, 1.524, 2.149, -1.062),
    'GLN': (-0.526, 1.361, 1.526, 2.152, -1.062),
    'GLU': (-0.528, 1.361, 1.526, 2.152, -1.062),
    'GLY': (-0.572, 1.337, 1.517, 2.143, -1.062),
    'HIS': (-0.527, 1.360, 1.525, 2.150, -1.063),
    'ILE': (-0.493, 1.373, 1.527, 2.154, -1.062),
    'LEU': (-0.520, 1.363, 1.525, 2.150, -1.063),
    'LYS': (-0.526, 1.362, 1.526, 2.152, -1.062),
    'MET': (-0.521, 1.364, 1.525, 2.150, -1.062),
    'PHE': (-0.518, 1.363, 1.524, 2.150, -1.062),
    'PRO': (-0.566, 1.351, 1.527, 2.148, -1.066),
    'SER': (-0.529, 1.360, 1.525, 2.151, -1.062),
    'THR': (-0.517, 1.364, 1.526, 2.152, -1.062),
    'TRP': (-0.521, 1.363, 1.525, 2.152, -1.062),
    'TYR': (-0.522, 1.362, 1.524, 2.151, -1.062),
    'VAL': (-0.494, 1.373, 1.527, 2.154, -1.062),
}


def _build_ideal_tables():
    bb = np.zeros((21, 3, 3), dtype=np.float32)   # [restype, atom(N/CA/C), xyz]
    oxy = np.zeros((21, 3), dtype=np.float32)     # [restype, xyz]
    for name, (nx, ny, cx, ox, oy) in _IDEAL_BB.items():
        i = _RESTYPES.index(name)
        bb[i, 0] = (nx, ny, 0.0)
        # CA row stays at the origin.
        bb[i, 2] = (cx, 0.0, 0.0)
        oxy[i] = (ox, oy, 0.0)
    return bb, oxy


# (21, 3, 3) idealized N/CA/C local coordinates and (21, 3) O coordinate in
# the psi-rotated frame; row 20 (UNK) is all zero.
backbone_atom_coordinates, bb_oxygen_coordinate = _build_ideal_tables()

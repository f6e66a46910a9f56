"""Protein constants: the amino-acid alphabet, CDR definitions, the
heavy-atom layout, the idealized backbone geometry and the amino-acid
property labels.

The port's own copy of ``ab_opt_tpu/constants.py`` (the same tables, built
by the same code), so that the port imports nothing of the JAX package.
The host data layer (``data/``), DockQ and the design runner read the
alphabet and CDR tables; the model reads the heavy-atom slots and the
backbone geometry.
"""
from __future__ import annotations

import enum

import numpy as np

# --------------------------------------------------------------------------- #
# CDR / fragment / chain enums (ref: constants.py:4-45)
# --------------------------------------------------------------------------- #


class CDR(enum.IntEnum):
    H1 = 1
    H2 = 2
    H3 = 3
    L1 = 4
    L2 = 5
    L3 = 6


class ChothiaCDRRange:
    """Chothia-numbering CDR ranges (inclusive). ref: constants.py:13-38."""

    H1 = (26, 32)
    H2 = (52, 56)
    H3 = (95, 102)
    L1 = (24, 34)
    L2 = (50, 56)
    L3 = (89, 97)

    @classmethod
    def to_cdr(cls, chain_type: str, resseq: int):
        if chain_type == 'H':
            ranges = {CDR.H1: cls.H1, CDR.H2: cls.H2, CDR.H3: cls.H3}
        elif chain_type == 'L':
            ranges = {CDR.L1: cls.L1, CDR.L2: cls.L2, CDR.L3: cls.L3}
        else:
            raise ValueError(f'chain_type must be H or L, got {chain_type!r}')
        for cdr, (lo, hi) in ranges.items():
            if lo <= resseq <= hi:
                return cdr
        return None


class Fragment(enum.IntEnum):
    """Fragment type codes; 0 is reserved for padding. ref: constants.py:41-45."""

    Heavy = 1
    Light = 2
    Antigen = 3


# --------------------------------------------------------------------------- #
# Amino-acid alphabet (ref: constants.py:94-134)
# --------------------------------------------------------------------------- #

# Index order follows the one-letter-alphabetical convention used by the
# reference: A C D E F G H I K L M N P Q R S T V W Y, then X (unknown).
AA_1LETTER = 'ACDEFGHIKLMNPQRSTVWY'
AA_UNK = 20          # 'X'
AA_PAD = 21          # padding token used by the collator
NUM_AA_TYPES = 21    # incl. UNK
MAX_AA_TYPES = 22    # incl. UNK + PAD slots used by embeddings

ressymb_to_resindex = {sym: i for i, sym in enumerate(AA_1LETTER)}
ressymb_to_resindex['X'] = AA_UNK
resindex_to_ressymb = {i: s for s, i in ressymb_to_resindex.items()}

_THREE_TO_ONE = {
    'ALA': 'A', 'CYS': 'C', 'ASP': 'D', 'GLU': 'E', 'PHE': 'F',
    'GLY': 'G', 'HIS': 'H', 'ILE': 'I', 'LYS': 'K', 'LEU': 'L',
    'MET': 'M', 'ASN': 'N', 'PRO': 'P', 'GLN': 'Q', 'ARG': 'R',
    'SER': 'S', 'THR': 'T', 'VAL': 'V', 'TRP': 'W', 'TYR': 'Y',
    'UNK': 'X',
}
ONE_TO_THREE = {v: k for k, v in _THREE_TO_ONE.items()}


class AA(enum.IntEnum):
    ALA = 0; CYS = 1; ASP = 2; GLU = 3; PHE = 4
    GLY = 5; HIS = 6; ILE = 7; LYS = 8; LEU = 9
    MET = 10; ASN = 11; PRO = 12; GLN = 13; ARG = 14
    SER = 15; THR = 16; VAL = 17; TRP = 18; TYR = 19
    UNK = 20

    @classmethod
    def _missing_(cls, value):
        if isinstance(value, str):
            v = value.upper()
            if len(v) == 3:
                v = non_standard_residue_substitutions.get(v, v)
                if v in cls.__members__:
                    return cls[v]
            elif len(v) == 1 and v in ressymb_to_resindex:
                return cls(ressymb_to_resindex[v])
        return None

    def __str__(self):
        return self.name

    @classmethod
    def is_aa(cls, value) -> bool:
        if isinstance(value, str):
            v = value.upper()
            return (v in ressymb_to_resindex or v in non_standard_residue_substitutions
                    or v in cls.__members__)
        return isinstance(value, (int, np.integer, AA))


# Modified/non-standard residue names -> parent residue. Factual table from the
# OpenMM toolkit (same data as ref constants.py:76-91).
non_standard_residue_substitutions = {
    '2AS': 'ASP', '3AH': 'HIS', '5HP': 'GLU', 'ACL': 'ARG', 'AGM': 'ARG',
    'AIB': 'ALA', 'ALM': 'ALA', 'ALO': 'THR', 'ALY': 'LYS', 'ARM': 'ARG',
    'ASA': 'ASP', 'ASB': 'ASP', 'ASK': 'ASP', 'ASL': 'ASP', 'ASQ': 'ASP',
    'AYA': 'ALA', 'BCS': 'CYS', 'BHD': 'ASP', 'BMT': 'THR', 'BNN': 'ALA',
    'BUC': 'CYS', 'BUG': 'LEU', 'C5C': 'CYS', 'C6C': 'CYS', 'CAS': 'CYS',
    'CCS': 'CYS', 'CEA': 'CYS', 'CGU': 'GLU', 'CHG': 'ALA', 'CLE': 'LEU',
    'CME': 'CYS', 'CSD': 'ALA', 'CSO': 'CYS', 'CSP': 'CYS', 'CSS': 'CYS',
    'CSW': 'CYS', 'CSX': 'CYS', 'CXM': 'MET', 'CY1': 'CYS', 'CY3': 'CYS',
    'CYG': 'CYS', 'CYM': 'CYS', 'CYQ': 'CYS', 'DAH': 'PHE', 'DAL': 'ALA',
    'DAR': 'ARG', 'DAS': 'ASP', 'DCY': 'CYS', 'DGL': 'GLU', 'DGN': 'GLN',
    'DHA': 'ALA', 'DHI': 'HIS', 'DIL': 'ILE', 'DIV': 'VAL', 'DLE': 'LEU',
    'DLY': 'LYS', 'DNP': 'ALA', 'DPN': 'PHE', 'DPR': 'PRO', 'DSN': 'SER',
    'DSP': 'ASP', 'DTH': 'THR', 'DTR': 'TRP', 'DTY': 'TYR', 'DVA': 'VAL',
    'EFC': 'CYS', 'FLA': 'ALA', 'FME': 'MET', 'GGL': 'GLU', 'GL3': 'GLY',
    'GLZ': 'GLY', 'GMA': 'GLU', 'GSC': 'GLY', 'HAC': 'ALA', 'HAR': 'ARG',
    'HIC': 'HIS', 'HIP': 'HIS', 'HMR': 'ARG', 'HPQ': 'PHE', 'HTR': 'TRP',
    'HYP': 'PRO', 'IAS': 'ASP', 'IIL': 'ILE', 'IYR': 'TYR', 'KCX': 'LYS',
    'LLP': 'LYS', 'LLY': 'LYS', 'LTR': 'TRP', 'LYM': 'LYS', 'LYZ': 'LYS',
    'MAA': 'ALA', 'MEN': 'ASN', 'MHS': 'HIS', 'MIS': 'SER', 'MLE': 'LEU',
    'MPQ': 'GLY', 'MSA': 'GLY', 'MSE': 'MET', 'MVA': 'VAL', 'NEM': 'HIS',
    'NEP': 'HIS', 'NLE': 'LEU', 'NLN': 'LEU', 'NLP': 'LEU', 'NMC': 'GLY',
    'OAS': 'SER', 'OCS': 'CYS', 'OMT': 'MET', 'PAQ': 'TYR', 'PCA': 'GLU',
    'PEC': 'CYS', 'PHI': 'PHE', 'PHL': 'PHE', 'PR3': 'CYS', 'PRR': 'ALA',
    'PTR': 'TYR', 'PYX': 'CYS', 'SAC': 'SER', 'SAR': 'GLY', 'SCH': 'CYS',
    'SCS': 'CYS', 'SCY': 'CYS', 'SEL': 'SER', 'SEP': 'SER', 'SET': 'SER',
    'SHC': 'CYS', 'SHR': 'LYS', 'SMC': 'CYS', 'SOC': 'CYS', 'STY': 'TYR',
    'SVA': 'SER', 'TIH': 'ALA', 'TPL': 'TRP', 'TPO': 'THR', 'TPQ': 'ALA',
    'TRG': 'LYS', 'TRO': 'TRP', 'TYB': 'TYR', 'TYI': 'TYR', 'TYQ': 'TYR',
    'TYS': 'TYR', 'TYY': 'TYR',
}

# --------------------------------------------------------------------------- #
# Heavy-atom layout (ref: constants.py:139-181)
# --------------------------------------------------------------------------- #


class BBHeavyAtom(enum.IntEnum):
    N = 0; CA = 1; C = 2; O = 3; CB = 4; OXT = 14


NUM_BB_ATOMS = 5          # N CA C O CB
MAX_NUM_HEAVYATOMS = 15   # 14 sidechain/backbone slots + OXT

# Per-residue heavy-atom slot names; slot 14 is always OXT, empty string means
# the slot is unused for that residue type. Same layout as AlphaFold's
# residue_constants (ref constants.py:158-180).
_HEAVYATOM_LAYOUT = {
    'ALA': 'N CA C O CB',
    'ARG': 'N CA C O CB CG CD NE CZ NH1 NH2',
    'ASN': 'N CA C O CB CG OD1 ND2',
    'ASP': 'N CA C O CB CG OD1 OD2',
    'CYS': 'N CA C O CB SG',
    'GLN': 'N CA C O CB CG CD OE1 NE2',
    'GLU': 'N CA C O CB CG CD OE1 OE2',
    'GLY': 'N CA C O',
    'HIS': 'N CA C O CB CG ND1 CD2 CE1 NE2',
    'ILE': 'N CA C O CB CG1 CG2 CD1',
    'LEU': 'N CA C O CB CG CD1 CD2',
    'LYS': 'N CA C O CB CG CD CE NZ',
    'MET': 'N CA C O CB CG SD CE',
    'PHE': 'N CA C O CB CG CD1 CD2 CE1 CE2 CZ',
    'PRO': 'N CA C O CB CG CD',
    'SER': 'N CA C O CB OG',
    'THR': 'N CA C O CB OG1 CG2',
    'TRP': 'N CA C O CB CG CD1 CD2 NE1 CE2 CE3 CZ2 CZ3 CH2',
    'TYR': 'N CA C O CB CG CD1 CD2 CE1 CE2 CZ OH',
    'VAL': 'N CA C O CB CG1 CG2',
    'UNK': '',
}


def _layout_to_slots(layout: str) -> list:
    names = layout.split() if layout else []
    slots = names + [''] * (MAX_NUM_HEAVYATOMS - 1 - len(names))
    slots.append('OXT' if layout else '')
    return slots


restype_to_heavyatom_names = {
    AA[name]: _layout_to_slots(layout) for name, layout in _HEAVYATOM_LAYOUT.items()
}

# --------------------------------------------------------------------------- #
# Idealized backbone geometry (ref: constants.py:184-320)
#
# In the CA-centered local frame, every backbone atom lies in the z=0 plane:
#   N  = (nx, ny, 0),  CA = (0, 0, 0),  C = (cx, 0, 0),  O = (ox, oy, 0)
# so we store just 5 numbers per residue type: (nx, ny, cx, ox, oy).
# --------------------------------------------------------------------------- #

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
        i = int(AA[name])
        bb[i, 0] = (nx, ny, 0.0)
        # CA row stays at the origin.
        bb[i, 2] = (cx, 0.0, 0.0)
        oxy[i] = (ox, oy, 0.0)
    return bb, oxy


# (21, 3, 3) idealized N/CA/C local coordinates and (21, 3) O coordinate in the
# psi-rotated frame; row 20 (UNK) is all-zero like the reference tensors.
backbone_atom_coordinates, bb_oxygen_coordinate = _build_ideal_tables()

# --------------------------------------------------------------------------- #
# Amino-acid property labels (AbDesign conditioning;
# ref: AbDesign/diffab/utils/protein/constants.py:4-92)
# --------------------------------------------------------------------------- #


class Hydropathy(enum.IntEnum):
    """0 reserved for padding (embedding padding_idx)."""

    hydrophilic = 1
    moderate = 2
    unknown = 3


class Charge(enum.IntEnum):
    positive = 1
    negative = 2
    neutral = 3
    unknown = 4


# Only C/H/M are labeled 'moderate'; everything else 'hydrophilic'
# (AbDesign constants.py:20-42, reproduced for conditioning parity).
_HYDROPATHY_MODERATE = 'CHM'
_CHARGE_POSITIVE = 'RKH'
_CHARGE_NEGATIVE = 'DE'

hydropathy_to_char = {Hydropathy.hydrophilic: '+', Hydropathy.moderate: '-',
                      Hydropathy.unknown: '?'}
charge_to_char = {Charge.positive: '+', Charge.negative: '-',
                  Charge.neutral: '=', Charge.unknown: '?'}


def _build_property_tables():
    hyd = np.full((MAX_AA_TYPES,), int(Hydropathy.unknown), dtype=np.int32)
    chg = np.full((MAX_AA_TYPES,), int(Charge.unknown), dtype=np.int32)
    for i in range(20):
        sym = resindex_to_ressymb[i]
        hyd[i] = int(Hydropathy.moderate if sym in _HYDROPATHY_MODERATE
                     else Hydropathy.hydrophilic)
        if sym in _CHARGE_POSITIVE:
            chg[i] = int(Charge.positive)
        elif sym in _CHARGE_NEGATIVE:
            chg[i] = int(Charge.negative)
        else:
            chg[i] = int(Charge.neutral)
    return hyd, chg


aa_hydropathy_table, aa_charge_table = _build_property_tables()

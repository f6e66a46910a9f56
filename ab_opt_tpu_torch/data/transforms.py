"""Host-side data transforms (numpy): masking, chain merging, the
inference crop around the anchor, atom selection, native removal and the
property labels, behind a registry that configs name by ``type`` (the
port's own copy of ``ab_opt_tpu/data/transforms.py``). Randomized
transforms draw from an explicit ``numpy.random.Generator``, so the same
seed gives the same variants and crops as the JAX package.
"""
from __future__ import annotations

import copy
from typing import List, Optional

import numpy as np

from ..constants import CDR, BBHeavyAtom, Fragment, AA_UNK

_TRANSFORM_DICT = {}


def register_transform(name):
    def decorator(cls):
        _TRANSFORM_DICT[name] = cls
        cls.transform_name = name
        return cls
    return decorator


def get_transform(cfg):
    """Build a Compose from a list of {'type': ..., **kwargs} dicts."""
    if not cfg:
        return None
    tfms = []
    for t in cfg:
        t = copy.deepcopy(dict(t))
        cls = _TRANSFORM_DICT[t.pop('type')]
        tfms.append(cls(**t))
    return Compose(tfms)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data, rng: Optional[np.random.Generator] = None):
        rng = rng if rng is not None else np.random.default_rng()
        for t in self.transforms:
            data = _call_transform(t, data, rng)
        return data


def _call_transform(t, data, rng):
    import inspect
    params = inspect.signature(t.__call__).parameters
    if 'rng' in params:
        return t(data, rng=rng)
    return t(data)


class DISTVIOLATION(Exception):
    """Anchor-antigen distance violation: the sample should be resampled."""


# --------------------------------------------------------------------------- #
# Selection helpers
# --------------------------------------------------------------------------- #


def _mask_select(v, mask):
    n = mask.shape[0]
    if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n:
        return v[mask]
    if isinstance(v, list) and len(v) == n:
        return [x for x, b in zip(v, mask) if b]
    return v


def mask_select_data(data, mask):
    return {k: _mask_select(v, mask) for k, v in data.items()}


def continuous_flag_to_range(flag):
    idx = np.flatnonzero(flag)
    return int(idx.min()), int(idx.max())


def random_shrink_extend(flag, rng, min_length=5, shrink_limit=1, extend_limit=2):
    """Randomly shrink/extend a contiguous mask (ref mask.py:9-18)."""
    first, last = continuous_flag_to_range(flag)
    if (int(flag.sum()) - 2 * shrink_limit) < min_length:
        shrink_limit = 0
    first_ext = max(0, first - int(rng.integers(-shrink_limit, extend_limit + 1)))
    last_ext = min(last + int(rng.integers(-shrink_limit, extend_limit + 1)),
                   flag.shape[0] - 1)
    out = flag.copy()
    out[first_ext:last_ext + 1] = True
    return out


def generate_random_mask(shape, mask_ratio_min, mask_ratio_max, rng):
    """Bernoulli mask with a random per-sample ratio (ref models/diffab.py:166)."""
    ratio = rng.uniform(mask_ratio_min, mask_ratio_max)
    return rng.random(shape) < ratio


def generate_mask_from_contig(contig: str, length: int) -> np.ndarray:
    """'start-end' (1-based, inclusive) -> boolean mask of ``length``."""
    start, end = (int(x) for x in contig.split('-'))
    mask = np.zeros(length, bool)
    mask[start - 1:end] = True
    return mask


_CDR_STR_TO_ENUM = {
    'H1': CDR.H1, 'H2': CDR.H2, 'H3': CDR.H3,
    'L1': CDR.L1, 'L2': CDR.L2, 'L3': CDR.L3,
    'H_CDR1': CDR.H1, 'H_CDR2': CDR.H2, 'H_CDR3': CDR.H3,
    'L_CDR1': CDR.L1, 'L_CDR2': CDR.L2, 'L_CDR3': CDR.L3,
}


# --------------------------------------------------------------------------- #
# Masking transforms (operate on {heavy, light, antigen} structures)
# --------------------------------------------------------------------------- #


def _set_cdr_mask(data, cdr_to_mask, rng, augmentation):
    flag = (data['cdr_flag'] == int(cdr_to_mask))
    if augmentation:
        flag = random_shrink_extend(flag, rng)
    first, last = continuous_flag_to_range(flag)
    anchor = np.zeros(data['aa'].shape, bool)
    anchor[max(0, first - 1)] = True
    anchor[min(data['aa'].shape[0] - 1, last + 1)] = True
    if 'generate_flag' in data:
        data['generate_flag'] = data['generate_flag'] | flag
        data['anchor_flag'] = data['anchor_flag'] | anchor
    else:
        data['generate_flag'] = flag
        data['anchor_flag'] = anchor


@register_transform('mask_single_cdr')
class MaskSingleCDR:
    """Mask one CDR for generation, anchors at its flanks (ref mask.py:26-97).

    selection: specific CDR name, 'CDR3' (H3 else L3), or None = random.
    """

    def __init__(self, selection=None, augmentation=True):
        assert selection is None or selection == 'CDR3' or selection in _CDR_STR_TO_ENUM
        self.selection = (_CDR_STR_TO_ENUM.get(selection, selection)
                          if selection is not None else None)
        self.augmentation = augmentation

    def __call__(self, structure, rng):
        if self.selection is None:
            candidates = [structure[k] for k in ('heavy', 'light')
                          if structure[k] is not None]
            data = candidates[int(rng.integers(len(candidates)))]
            cdr_flag = data['cdr_flag']
            present = np.unique(cdr_flag[cdr_flag > 0])
            sel = int(present[int(rng.integers(len(present)))])
        elif self.selection == 'CDR3':
            if structure['heavy'] is not None:
                data, sel = structure['heavy'], CDR.H3
            else:
                data, sel = structure['light'], CDR.L3
        elif self.selection in (CDR.H1, CDR.H2, CDR.H3):
            data, sel = structure['heavy'], self.selection
        else:
            data, sel = structure['light'], self.selection
        _set_cdr_mask(data, sel, rng, self.augmentation)
        return structure


@register_transform('mask_multiple_cdrs')
class MaskMultipleCDRs:
    """Mask a random subset (or a fixed selection) of CDRs per chain."""

    def __init__(self, selection: Optional[List[str]] = None, augmentation=True):
        self.selection = ([int(_CDR_STR_TO_ENUM[s]) for s in selection]
                          if selection is not None else None)
        self.augmentation = augmentation

    def _mask_chain(self, data, rng):
        cdr_flag = data['cdr_flag']
        cdr_all = [int(c) for c in np.unique(cdr_flag[cdr_flag > 0])]
        if self.selection is not None:
            cdrs_to_mask = sorted(set(cdr_all) & set(self.selection))
        else:
            num = int(rng.integers(1, len(cdr_all) + 1))
            rng.shuffle(cdr_all)
            cdrs_to_mask = cdr_all[:num]
        for cdr in cdrs_to_mask:
            _set_cdr_mask(data, cdr, rng, self.augmentation)

    def __call__(self, structure, rng):
        for k in ('heavy', 'light'):
            if structure[k] is not None:
                self._mask_chain(structure[k], rng)
        return structure


@register_transform('mask_full_antibody')
class MaskFullAntibody:
    """Generate entire antibody chain(s); anchors at termini (ref mask.py:168)."""

    def __init__(self, antibody_chains: Optional[List[str]] = None):
        self.chains = antibody_chains or ['heavy']

    def __call__(self, structure):
        for name in self.chains:
            data = structure[name]
            if data is None:
                continue
            data['generate_flag'] = np.ones(data['aa'].shape, bool)
            anchor = np.zeros(data['aa'].shape, bool)
            anchor[0] = anchor[-1] = True
            data['anchor_flag'] = anchor
        return structure


@register_transform('mask_antibody')
class MaskAntibody:
    """Dock mode: generate the whole Fv; anchor on an antigen contact residue
    (ref mask.py:199-233)."""

    def __call__(self, structure, rng):
        pos_ab = []
        for k in ('heavy', 'light'):
            if structure[k] is not None:
                structure[k]['generate_flag'] = np.ones(structure[k]['aa'].shape, bool)
                pos_ab.append(structure[k]['pos_heavyatom'][:, BBHeavyAtom.CA])
        pos_ab = np.concatenate(pos_ab, axis=0)

        ag = structure['antigen']
        if ag is not None:
            pos_ag = ag['pos_heavyatom'][:, BBHeavyAtom.CA]
            d = np.linalg.norm(pos_ag[:, None] - pos_ab[None, :], axis=-1)
            nn_dist = d.min(axis=1)
            contact = nn_dist <= 6.0
            if not contact.any():
                contact[nn_dist.argmin()] = True
            anchor_idx = int(rng.choice(np.flatnonzero(contact)))
            anchor = np.zeros(ag['aa'].shape, bool)
            anchor[anchor_idx] = True
            ag['anchor_flag'] = anchor
            ag['contact_flag'] = contact
        return structure


@register_transform('remove_antigen')
class RemoveAntigen:
    def __call__(self, structure):
        structure['antigen'] = None
        structure['antigen_seqmap'] = None
        return structure


# --------------------------------------------------------------------------- #
# Merge + patch + atom selection
# --------------------------------------------------------------------------- #


@register_transform('merge_chains')
class MergeChains:
    """H/L/Ag -> one residue array with fragment_type + chain_nb (ref merge.py)."""

    LIST_PROPS = ('chain_id', 'icode')
    TENSOR_PROPS = ('chain_nb', 'resseq', 'res_nb', 'aa', 'pos_heavyatom',
                    'mask_heavyatom', 'generate_flag', 'cdr_flag',
                    'anchor_flag', 'fragment_type')

    def __call__(self, structure):
        data_list = []
        if structure['heavy'] is not None:
            structure['heavy']['fragment_type'] = np.full_like(
                structure['heavy']['aa'], int(Fragment.Heavy))
            data_list.append(structure['heavy'])
        if structure['light'] is not None:
            structure['light']['fragment_type'] = np.full_like(
                structure['light']['aa'], int(Fragment.Light))
            data_list.append(structure['light'])
        if structure.get('antigen') is not None:
            ag = structure['antigen']
            ag['fragment_type'] = np.full_like(ag['aa'], int(Fragment.Antigen))
            ag['cdr_flag'] = np.zeros_like(ag['aa'])
            data_list.append(ag)

        chains = sorted({c for d in data_list for c in d['chain_id']})
        chain_map = {c: i for i, c in enumerate(chains)}
        for d in data_list:
            d['chain_nb'] = np.asarray([chain_map[c] for c in d['chain_id']],
                                       np.int64)

        def attr(d, name):
            if name in ('generate_flag', 'anchor_flag') and name not in d:
                return np.zeros(d['aa'].shape, bool)
            return d[name]

        out = {}
        for k in self.LIST_PROPS:
            out[k] = sum((list(attr(d, k)) for d in data_list), [])
        for k in self.TENSOR_PROPS:
            out[k] = np.concatenate([attr(d, k) for d in data_list], axis=0)
        return out


@register_transform('patch_around_anchor')
class PatchAroundAnchor:
    """Crop to CDR + nearest antibody context + epitope (ref patch.py:8-100).

    Recenters coordinates on the anchor centroid and records ``patch_idx``
    for pasting results back into the full complex.
    """

    def __init__(self, initial_patch_size=128, antigen_size=128,
                 remove_anchor=False, dist_cutoff=None,
                 crop_contiguous_antigen=False, contiguous_threshold=1e6,
                 contiguous_ratio=0.0):
        as_bool = lambda v: v if isinstance(v, bool) else str(v).lower() not in ('false', '0')
        self.initial_patch_size = int(initial_patch_size)
        self.antigen_size = int(antigen_size)
        self.remove_anchor = as_bool(remove_anchor)
        self.dist_cutoff = None if dist_cutoff is None else float(dist_cutoff)
        self.crop_contiguous_antigen = as_bool(crop_contiguous_antigen)
        self.contiguous_threshold = int(float(contiguous_threshold))
        self.contiguous_ratio = float(contiguous_ratio)

    @staticmethod
    def _center(data, origin):
        origin = origin.reshape(1, 1, 3)
        data['pos_heavyatom'] = ((data['pos_heavyatom'] - origin)
                                 * data['mask_heavyatom'][:, :, None])
        data['origin'] = origin.reshape(3)
        return data

    def __call__(self, data):
        anchor_flag = data['anchor_flag']
        anchor_points = data['pos_heavyatom'][anchor_flag, BBHeavyAtom.CA]
        antigen_mask = data['fragment_type'] == int(Fragment.Antigen)
        antibody_mask = ~antigen_mask

        if anchor_flag.sum() == 0:
            # Full-Fv generation without antigen: keep the whole antibody.
            patch = mask_select_data(data, antibody_mask)
            return self._center(
                patch, patch['pos_heavyatom'][:, BBHeavyAtom.CA].mean(axis=0))

        pos_alpha = data['pos_heavyatom'][:, BBHeavyAtom.CA]
        cdr_points = pos_alpha[data['generate_flag']]
        dist_anchor = np.linalg.norm(
            pos_alpha[:, None] - cdr_points[None, :], axis=-1).min(axis=1)
        k_ab = min(self.initial_patch_size, dist_anchor.shape[0])
        initial_patch_idx = np.argsort(dist_anchor)[:k_ab]

        dist_anchor_antigen = np.where(antibody_mask, np.inf, dist_anchor)
        min_dist = dist_anchor_antigen.min()
        if (self.dist_cutoff is not None and min_dist > 0
                and min_dist > self.dist_cutoff):
            raise DISTVIOLATION('Distance between anchor and antigen is too large')
        k_ag = min(self.antigen_size, int(antigen_mask.sum()))
        antigen_patch_idx = np.argsort(dist_anchor_antigen)[:k_ag]
        if self.crop_contiguous_antigen and antigen_patch_idx.shape[0] > 0:
            ratio, antigen_patch_idx = _contiguous_idx(
                antigen_patch_idx, self.contiguous_threshold)
            if ratio < self.contiguous_ratio:
                raise DISTVIOLATION(f'Antigen is not contiguous, keep ratio: {ratio}')

        patch_mask = data['generate_flag'].copy()
        if not self.remove_anchor:
            patch_mask |= anchor_flag
        patch_mask[initial_patch_idx] = True
        patch_mask[antigen_patch_idx] = True

        patch_idx = np.flatnonzero(patch_mask)
        patch = mask_select_data(data, patch_mask)
        patch = self._center(patch, anchor_points.mean(axis=0))
        patch['patch_idx'] = patch_idx
        return patch


def _contiguous_idx(idx, threshold=3):
    """Keep the largest contiguous run of sorted indices (ref patch.py:103)."""
    idx = np.sort(idx)
    contig = np.concatenate([[True], np.diff(idx) <= threshold])
    if contig.all():
        return 1.0, idx
    false_pos = np.flatnonzero(~contig)
    first_false, last_false = false_pos[0], false_pos[-1]
    keep = contig.copy()
    if len(idx) - 1 - last_false > first_false:
        keep[:last_false] = False
    else:
        keep[first_false:] = False
    ratio = round(keep.sum() / len(keep), 2)
    return ratio, idx[keep]


@register_transform('select_atom')
class SelectAtom:
    def __init__(self, resolution):
        assert resolution in ('full', 'backbone')
        self.resolution = resolution

    def __call__(self, data):
        n = None if self.resolution == 'full' else 5
        data['pos_atoms'] = data['pos_heavyatom'][:, :n]
        data['mask_atoms'] = data['mask_heavyatom'][:, :n]
        return data


@register_transform('remove_native')
class RemoveNative:
    """Wipe native sequence (-> UNK) and/or structure (-> 10A noise) of the
    generate region before inference (ref utils/inference.py:37-60)."""

    def __init__(self, remove_structure=True, remove_sequence=True):
        self.remove_structure = remove_structure
        self.remove_sequence = remove_sequence

    def __call__(self, data, rng):
        flag = data['generate_flag']
        if self.remove_sequence:
            data['aa'] = np.where(flag, np.full_like(data['aa'], AA_UNK), data['aa'])
        if self.remove_structure:
            noise = rng.normal(size=data['pos_heavyatom'].shape).astype(np.float32) * 10
            data['pos_heavyatom'] = np.where(flag[:, None, None], noise,
                                             data['pos_heavyatom'])
        return data


# --------------------------------------------------------------------------- #
# AbDesign extras: property labels, structure filters, hotspot patching
# --------------------------------------------------------------------------- #


@register_transform('aa_label')
class Label:
    """Hydropathy/charge labels on the generate region with random label
    dropout (classifier-free-style conditioning; AbDesign label.py:7-38)."""

    def __init__(self, hydropathy=False, charge=False, drop_prob=0.0):
        from ..constants import aa_hydropathy_table, aa_charge_table, Hydropathy, Charge
        self.hydropathy = hydropathy
        self.charge = charge
        self.drop_prob = drop_prob
        self._hyd_table = aa_hydropathy_table
        self._chg_table = aa_charge_table
        self._hyd_unknown = int(Hydropathy.unknown)
        self._chg_unknown = int(Charge.unknown)

    def __call__(self, data, rng):
        flags = data['generate_flag']
        aa = data['aa']
        hyd = np.full_like(aa, self._hyd_unknown)
        if self.hydropathy:
            lab = self._hyd_table[aa[flags]]
            if self.drop_prob > 0:
                lab = np.where(rng.random(lab.shape) < self.drop_prob,
                               self._hyd_unknown, lab)
            hyd[flags] = lab
        data['hydropathy'] = hyd

        chg = np.full_like(aa, self._chg_unknown)
        if self.charge:
            lab = self._chg_table[aa[flags]]
            if self.drop_prob > 0:
                lab = np.where(rng.random(lab.shape) < self.drop_prob,
                               self._chg_unknown, lab)
            chg[flags] = lab
        data['charge'] = chg
        return data


@register_transform('filter_structure')
class FilterStructure:
    """Exception-driven skipping of structures missing required chains
    (AbDesign filter_structure.py:9)."""

    def __init__(self, must_have_antigen=False, must_have_heavy=False,
                 must_have_light=False):
        self.must_have_antigen = must_have_antigen
        self.must_have_heavy = must_have_heavy
        self.must_have_light = must_have_light

    def __call__(self, structure):
        if self.must_have_antigen and structure.get('antigen') is None:
            raise DISTVIOLATION('missing antigen')
        if self.must_have_heavy and structure.get('heavy') is None:
            raise DISTVIOLATION('missing heavy chain')
        if self.must_have_light and structure.get('light') is None:
            raise DISTVIOLATION('missing light chain')
        return structure


@register_transform('patch_around_anchor_hotspot')
class PatchAroundAnchorHotspot(PatchAroundAnchor):
    """AbDesign patch variant: additionally labels the top-k antigen residues
    closest to the CDR as hotspots (AbDesign patch.py:60-100).

    Emits hotspot_label (2 hotspot / 1 not / 0 pad), hotspot_distance,
    antigen_hotspots, and to_hotspot_dist before cropping.
    """

    def __init__(self, max_nb_hotspots=1, max_distance=20, hotspot_cutoff=None,
                 **kw):
        super().__init__(**kw)
        self.max_nb_hotspots = int(max_nb_hotspots)
        self.max_distance = int(max_distance)
        self.hotspot_cutoff = hotspot_cutoff

    def __call__(self, data):
        antigen_mask = data['fragment_type'] == int(Fragment.Antigen)
        pos_alpha = data['pos_heavyatom'][:, BBHeavyAtom.CA]
        cdr_points = pos_alpha[data['generate_flag']]
        if antigen_mask.any() and len(cdr_points):
            dist_cdr = np.linalg.norm(
                pos_alpha[:, None] - cdr_points[None, :], axis=-1).min(axis=1)
            dist_cdr = np.where(antigen_mask, dist_cdr, np.inf)
            if (self.hotspot_cutoff is not None
                    and dist_cdr.min() > self.hotspot_cutoff):
                raise DISTVIOLATION('No interaction pairs within hotspot cutoff')
            k = max(1, self.max_nb_hotspots)
            k = min(k, int(antigen_mask.sum()))
            nearest = np.argsort(dist_cdr)[:k]

            hotspot_label = np.ones_like(data['aa'])
            hotspot_distance = np.ones_like(data['aa'])
            if self.max_nb_hotspots > 0:
                hotspot_label[nearest] = 2
                hotspot_distance[nearest] = np.clip(
                    np.floor(dist_cdr[nearest]).astype(np.int64), 1,
                    self.max_distance - 1)
            data['hotspot_label'] = hotspot_label
            data['hotspot_distance'] = hotspot_distance
            data['antigen_hotspots'] = hotspot_label.copy()
            to_dist = np.zeros(data['aa'].shape, np.float32)
            to_dist[nearest] = dist_cdr[nearest]
            data['to_hotspot_dist'] = to_dist
        else:
            data['hotspot_label'] = np.ones_like(data['aa'])
            data['hotspot_distance'] = np.ones_like(data['aa'])
        return super().__call__(data)

"""A dataset of user-provided PDBs in one directory (the port's own copy of
``ab_opt_tpu/data/custom.py``): each file preprocessed once into a pickle
of numpy arrays under ``structure_cache/`` beside the inputs.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from ._registry import register_dataset
from .structures import preprocess_antibody_structure


class CustomDataset:
    def __init__(self, structure_dir: str, transform=None, reset: bool = False,
                 heavy_id: str = 'H', light_id: str = 'L', seed: int = 0):
        self.structure_dir = structure_dir
        self.transform = transform
        self.cache_dir = os.path.join(structure_dir, 'structure_cache')
        os.makedirs(self.cache_dir, exist_ok=True)
        self.seed = seed
        self._rng = np.random.default_rng(seed)

        self.ids = []
        for fname in sorted(os.listdir(structure_dir)):
            if not fname.endswith('.pdb'):
                continue
            cache = os.path.join(self.cache_dir, fname + '.pkl')
            if reset or not os.path.exists(cache):
                parsed = preprocess_antibody_structure({
                    'id': fname,
                    'pdb_path': os.path.join(structure_dir, fname),
                    'heavy_id': heavy_id, 'light_id': light_id,
                })
                if parsed is None:
                    continue
                with open(cache, 'wb') as f:
                    pickle.dump(parsed, f)
            if os.path.exists(cache):
                self.ids.append(fname)

    def __len__(self):
        return len(self.ids)

    def get(self, index, salt: tuple = (0, 0)):
        """Deterministic fetch keyed by (seed, idx, salt); see
        TransformedDataset.get."""
        with open(os.path.join(self.cache_dir, self.ids[index] + '.pkl'), 'rb') as f:
            data = pickle.load(f)
        if self.transform is not None:
            rng = np.random.default_rng((self.seed, index) + tuple(salt))
            data = self.transform(data, rng=rng)
        return data

    def __getitem__(self, index):
        with open(os.path.join(self.cache_dir, self.ids[index] + '.pkl'), 'rb') as f:
            data = pickle.load(f)
        if self.transform is not None:
            data = self.transform(data, rng=self._rng)
        return data


@register_dataset('custom')
def build_custom_dataset(cfg, transform):
    return CustomDataset(structure_dir=cfg['structure_dir'], transform=transform,
                         reset=cfg.get('reset', False))


"""The host data layer (counterpart of ``ab_opt_tpu/data``): PDB IO,
antibody preprocessing, transforms and collation, all numpy, the transfer
of a batch to a device, the dataset registry with the SAbDab and custom
datasets, and the data loader."""
from .pdb import ParsingException, parse_pdb, pdb_chain_ids, save_pdb
from .structures import (
    aa_to_sequence,
    label_heavy_chain_cdr,
    label_light_chain_cdr,
    label_whole_chain_as_cdr,
    preprocess_antibody_structure,
)
from .transforms import (
    Compose,
    DISTVIOLATION,
    generate_mask_from_contig,
    generate_random_mask,
    get_transform,
    mask_select_data,
    register_transform,
)
from .collate import PaddingCollate, apply_patch_to_tensor, to_device_batch
from ._registry import get_dataset, register_dataset
from .loader import DataLoader, TransformedDataset, inf_iterator
from . import custom as _custom   # noqa: F401  (registers 'custom')
from . import sabdab as _sabdab   # noqa: F401  (registers 'sabdab')
from .sabdab import SAbDabDataset
from .custom import CustomDataset

__all__ = [k for k in dir() if not k.startswith('_')]

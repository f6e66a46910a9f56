"""The host data layer (counterpart of ``ab_opt_tpu/data``): PDB IO,
antibody preprocessing, transforms and collation, all numpy, and the
transfer of a batch to a device."""
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

__all__ = [k for k in dir() if not k.startswith('_')]

"""Rigid-frame / SO(3) geometry in PyTorch (counterpart of
``ab_opt_tpu/geometry``)."""
from .vec import (angstrom_to_nm, normalize_vector, pairwise_distances,
                  project_v2v, safe_norm)
from .so3 import (exp_skewsym, log_rotation, planar_apply_to_vector,
                  planar_compose, planar_rotation_to_so3vec, planar_to_matrix,
                  quaternion_1ijk_to_rotation_planar, quaternion_mul,
                  quaternion_to_rotation_matrix, quaternion_to_so3vec,
                  random_uniform_so3, rotation_to_so3vec, skewsym_to_so3vec,
                  so3vec_to_quaternion, so3vec_to_rotation,
                  so3vec_to_rotation_planar, so3vec_to_skewsym)
from .frames import (compose_rotation_and_translation, construct_3d_basis,
                     global_to_local, local_to_global)
from .dihedrals import (dihedral_from_four_points, get_backbone_dihedral_angles,
                        get_consecutive_flag, get_terminus_flag,
                        pairwise_dihedrals)
from .backbone import reconstruct_backbone, reconstruct_backbone_partially

__all__ = [k for k in dir() if not k.startswith('_')]

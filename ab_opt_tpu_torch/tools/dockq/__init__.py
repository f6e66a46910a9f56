from .dockq import (calc_dockq, capri_class, kabsch_rmsd, native_library,
                    plain_rmsd)

__all__ = ['calc_dockq', 'capri_class', 'kabsch_rmsd', 'native_library',
           'plain_rmsd']

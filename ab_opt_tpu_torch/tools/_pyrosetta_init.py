"""Shared lazy PyRosetta initialisation for the optional plug-ins."""
_INITIALIZED = False


def ensure_init():
    global _INITIALIZED
    if not _INITIALIZED:
        import pyrosetta
        pyrosetta.init('-mute all -ignore_unrecognized_res '
                       '-ignore_zero_occupancy false')
        _INITIALIZED = True

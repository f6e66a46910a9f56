"""The share of the query rows of K1's attention launches that hold a
residue: of a tile's ``k1_attn_qt`` rows, ``k1_attn_rows`` hold one (the
plan as the ``sample`` span records it, averaged over the launch's
tiles), so a launch over N trajectories of L residues and H heads covers
``N * H * L * qt / rows`` rows; weighted over the traced requests by
those rows and the reverse steps, %. None where the program records no
K1 plan."""
from harness.k1_spans import k1_requests


def read(view):
    held = launched = 0
    for a, steps in k1_requests():
        rows = a['N'] * a['heads'] * a['L'] * steps
        held += rows
        launched += rows * a['k1_attn_qt'] / a['k1_attn_rows']
    if not launched:
        return None
    return 100.0 * held / launched

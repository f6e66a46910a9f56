"""Scientific metrics: amino-acid recovery, CDR RMSDs, the consensus
ranking and the global-alignment similarity (the port's own copy of
``ab_opt_tpu/metrics.py``; numpy, host side)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def amino_acid_recovery(pred_aa, native_aa) -> float:
    """Fraction of positions where the designed sequence matches the native."""
    pred_aa = np.asarray(pred_aa)
    native_aa = np.asarray(native_aa)
    if pred_aa.size == 0:
        return float('nan')
    return float((pred_aa == native_aa).mean())


def ca_rmsd(pred_pos, native_pos) -> float:
    """Unaligned CA RMSD over the generated region (same frame by design)."""
    pred_pos = np.asarray(pred_pos, np.float64)
    native_pos = np.asarray(native_pos, np.float64)
    return float(np.sqrt(((pred_pos - native_pos) ** 2).sum(-1).mean()))


def pairwise_structure_rmsd(structures: np.ndarray) -> np.ndarray:
    """All-pairs unaligned RMSD (B, N, 3) -> (B, B)
    (ref design_for_testset.py:552-560)."""
    s = np.asarray(structures, np.float64)
    diff = s[:, None] - s[None, :]                        # (B, B, N, 3)
    return np.sqrt((diff ** 2).sum(-1).mean(-1))


def rank_commonness(structures: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k most 'consensus' structures: lowest mean RMSD to all
    other samples (ref design_for_testset.py:573-589)."""
    B = structures.shape[0]
    rmsd = pairwise_structure_rmsd(structures)
    score = rmsd.sum(axis=-1) / max(B - 1, 1)
    return np.argsort(score)[:k]


def average_pairwise_rmsd(structures: np.ndarray) -> float:
    """Mean inter-sample RMSD, a diversity measure (ref :566-570)."""
    B = structures.shape[0]
    rmsd = pairwise_structure_rmsd(structures)
    return float(rmsd.sum() / (B * max(B - 1, 1)))


# --------------------------------------------------------------------------- #
# Sequence alignment similarity (ref tools/eval/similarity.py)
# --------------------------------------------------------------------------- #

# BLOSUM62 substitution matrix over the 20 standard residues in our index
# order (A C D E F G H I K L M N P Q R S T V W Y).
_B62 = """
 4  0 -2 -1 -2  0 -2 -1 -1 -1 -1 -2 -1 -1 -1  1  0  0 -3 -2
 0  9 -3 -4 -2 -3 -3 -1 -3 -1 -1 -3 -3 -3 -3 -1 -1 -1 -2 -2
-2 -3  6  2 -3 -1 -1 -3 -1 -4 -3  1 -1  0 -2  0 -1 -3 -4 -3
-1 -4  2  5 -3 -2  0 -3  1 -3 -2  0 -1  2  0  0 -1 -2 -3 -2
-2 -2 -3 -3  6 -3 -1  0 -3  0  0 -3 -4 -3 -3 -2 -2 -1  1  3
 0 -3 -1 -2 -3  6 -2 -4 -2 -4 -3  0 -2 -2 -2  0 -2 -3 -2 -3
-2 -3 -1  0 -1 -2  8 -3 -1 -3 -2  1 -2  0  0 -1 -2 -3 -2  2
-1 -1 -3 -3  0 -4 -3  4 -3  2  1 -3 -3 -3 -3 -2 -1  3 -3 -1
-1 -3 -1  1 -3 -2 -1 -3  5 -2 -1  0 -1  1  2  0 -1 -2 -3 -2
-1 -1 -4 -3  0 -4 -3  2 -2  4  2 -3 -3 -2 -2 -2 -1  1 -2 -1
-1 -1 -3 -2  0 -3 -2  1 -1  2  5 -2 -2  0 -1 -1 -1  1 -1 -1
-2 -3  1  0 -3  0  1 -3  0 -3 -2  6 -2  0  0  1  0 -3 -4 -2
-1 -3 -1 -1 -4 -2 -2 -3 -1 -3 -2 -2  7 -1 -2 -1 -1 -2 -4 -3
-1 -3  0  2 -3 -2  0 -3  1 -2  0  0 -1  5  1  0 -1 -2 -2 -1
-1 -3 -2  0 -3 -2  0 -3  2 -2 -1  0 -2  1  5 -1 -1 -3 -3 -2
 1 -1  0  0 -2  0 -1 -2  0 -2 -1  1 -1  0 -1  4  1 -2 -3 -2
 0 -1 -1 -1 -2 -2 -2 -1 -1 -1 -1  0 -1 -1 -1  1  5  0 -2 -2
 0 -1 -3 -2 -1 -3 -3  3 -2  1  1 -3 -2 -2 -3 -2  0  4 -3 -1
-3 -2 -4 -3  1 -2 -2 -3 -3 -2 -1 -4 -4 -2 -3 -3 -2 -3 11  2
-2 -2 -3 -2  3 -3  2 -1 -2 -1 -1 -2 -3 -1 -2 -2 -2 -1  2  7
"""
BLOSUM62 = np.array([[int(x) for x in row.split()]
                     for row in _B62.strip().splitlines()])


def _gotoh_align(seq_a, seq_b, gap_open: float, gap_extend: float):
    """Affine-gap Gotoh DP with BLOSUM62 + greedy traceback.

    The shared core of the two public wrappers below (the same scoring the
    reference uses via Biopython globalds, similarity.py:59-96 / DockQ's
    needle-based fix_numbering.pl). Returns ``(pairs, score, leftover)``:
    ``pairs`` is the matched index pairs [(i, j), ...] ascending, ``score``
    the alignment score, ``leftover`` the residues left unconsumed when the
    traceback hit a sequence edge (counted as aligned-but-unmatched by the
    identity wrapper).
    """
    a = np.asarray(seq_a, np.int64)
    b = np.asarray(seq_b, np.int64)
    n, m = len(a), len(b)
    if n == 0 or m == 0:
        return [], 0.0, n + m
    NEG = -1e9
    M = np.full((n + 1, m + 1), NEG)
    X = np.full((n + 1, m + 1), NEG)   # gap in b
    Y = np.full((n + 1, m + 1), NEG)   # gap in a
    M[0, 0] = 0.0
    for i in range(1, n + 1):
        X[i, 0] = gap_open + (i - 1) * gap_extend
    for j in range(1, m + 1):
        Y[0, j] = gap_open + (j - 1) * gap_extend
    for i in range(1, n + 1):
        s_row = BLOSUM62[a[i - 1]]
        for j in range(1, m + 1):
            X[i, j] = max(M[i - 1, j] + gap_open, X[i - 1, j] + gap_extend)
            Y[i, j] = max(M[i, j - 1] + gap_open, Y[i, j - 1] + gap_extend)
            best_prev = max(M[i - 1, j - 1], X[i - 1, j - 1], Y[i - 1, j - 1])
            M[i, j] = best_prev + s_row[b[j - 1]]
    # Traceback (choose best end state greedily).
    i, j = n, m
    score = float(max(M[i, j], X[i, j], Y[i, j]))
    pairs = []
    while i > 0 and j > 0:
        best = max(M[i, j], X[i, j], Y[i, j])
        if best == M[i, j]:
            pairs.append((i - 1, j - 1))
            i, j = i - 1, j - 1
        elif best == X[i, j]:
            i -= 1
        else:
            j -= 1
    pairs.reverse()
    return pairs, score, i + j


def global_align_pairs(seq_a, seq_b, gap_open: float = -10.0,
                       gap_extend: float = -0.5):
    """Matched index pairs [(i, j), ...] and score of the global alignment
    of two aa-index sequences (see :func:`_gotoh_align`)."""
    pairs, score, _ = _gotoh_align(seq_a, seq_b, gap_open, gap_extend)
    return pairs, score


def global_align_identity(seq_a, seq_b, gap_open: float = -10.0,
                          gap_extend: float = -0.5) -> float:
    """Sequence identity in [0, 1] over the global alignment (ref
    similarity.py:59-96 uses Biopython globalds with BLOSUM62, -10/-0.5)."""
    a = np.asarray(seq_a, np.int64)
    b = np.asarray(seq_b, np.int64)
    pairs, _, leftover = _gotoh_align(a, b, gap_open, gap_extend)
    ident = sum(int(a[i] == b[j]) for i, j in pairs)
    return ident / max(len(pairs) + leftover, 1)

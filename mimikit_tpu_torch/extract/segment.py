"""Segmentation helpers (counterpart of ``mimikit_tpu/extract/segment.py``):
the dynamic time warping that ``models/nnn.py`` matches prompts with
(``:216-250``).  The rest of the JAX module is not ported yet."""
from __future__ import annotations

import numpy as np

__all__ = ["dtw"]


def dtw(C: np.ndarray, subseq: bool = False):
    """Dynamic time warping over a cost matrix; returns (D, path).

    ``subseq=True`` lets the match start and end anywhere along the second
    axis.  The backtrack takes ``min`` over ``(D, i, j)`` tuples, so on a
    tie of costs the smaller index wins, as in the JAX package."""
    N, M = C.shape
    D = np.full((N + 1, M + 1), np.inf)
    if subseq:
        D[0, :] = 0.0
    else:
        D[0, 0] = 0.0
    for i in range(1, N + 1):
        for j in range(1, M + 1):
            D[i, j] = C[i - 1, j - 1] + min(D[i - 1, j - 1], D[i - 1, j], D[i, j - 1])
    # backtrack from the best end position
    j = int(np.argmin(D[N])) if subseq else M
    i = N
    path = [(i - 1, j - 1)]
    while i > 1 or (not subseq and j > 1):
        moves = [
            (D[i - 1, j - 1], i - 1, j - 1),
            (D[i - 1, j], i - 1, j),
            (D[i, j - 1], i, j - 1),
        ]
        _, i, j = min(moves)
        if i == 0 or j == 0:
            break
        path.append((i - 1, j - 1))
    return D[1:, 1:], np.asarray(path[::-1])

"""Nearest-Next-Neighbor: a generator without a network (counterpart of
``mimikit_tpu/models/nnn.py``).  The prompt's frames are matched into a
corpus by subsequence DTW over cosine distances, then the corpus frames
after the match are played one a step."""
from __future__ import annotations

import numpy as np

from ..extract.segment import dtw

__all__ = ["optimal_path", "NearestNextNeighbor"]


def cosine_distances(X, Y) -> np.ndarray:
    """1 - the cosine similarity of each row of X with each row of Y, clipped
    to [0, 2]; a zero row has similarity 0.  scikit-learn's
    ``pairwise_distances(metric="cosine")`` for two distinct arrays, in the
    same dtype (float32 where both are, else float64) and order."""
    X, Y = np.asarray(X), np.asarray(Y)
    dtype = np.float32 if X.dtype == Y.dtype == np.float32 else np.float64
    X, Y = X.astype(dtype), Y.astype(dtype)

    def normalize(a):
        norms = np.sqrt(np.einsum("ij,ij->i", a, a))
        norms[norms == 0.0] = 1.0
        return a / norms[:, None]

    S = normalize(X) @ normalize(Y).T
    S *= -1
    S += 1
    return np.clip(S, 0, 2, out=S)


def optimal_path(x, y):
    """The subsequence DTW path of |x|'s frames through |y|'s."""
    C = cosine_distances(np.abs(x), np.abs(y))
    return dtw(C, subseq=True)[1]


class NearestNextNeighbor:
    def __init__(self, feature, snd, path_length: int = 16):
        self.feature = feature
        self.snd = np.asarray(feature(snd[:]) if callable(feature) else snd)
        self._t = -100
        self._starts = None
        self.shift = path_length
        self.output_length = lambda x: 1

    def predict_start_frame(self, X):
        path = optimal_path(X, self.snd)
        return int(path[-1, -1]) + 1

    def generate_step(self, inputs, *, t: int = 0, **parameters):
        """The start frames predicted where ``inputs`` are new (t is not the
        step after the last), then the next corpus frame of each stream."""
        if t != self._t + 1:
            self._starts = [self.predict_start_frame(np.asarray(x)) for x in inputs[0]]
            self._t = t - 1
        output = np.stack([self.snd[i : i + 1] for i in self._starts])
        self._starts = [x + 1 for x in self._starts]
        self._t += 1
        return output

    # the ARM surface GenerateLoopV2 and EnsembleGenerator call
    def before_generate(self, prompts, batch_index):
        self._t = -100

    def after_generate(self, final_outputs, batch_index):
        self._t = -100

    @property
    def generate_params(self):
        return set()

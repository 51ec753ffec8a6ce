"""MIR toolbox (counterpart of ``mimikit_tpu/extract``): subsequence DTW
(``segment.dtw``) and the neighbor scores (``from_neighbors``).  Clustering,
segmentation and samplify are not ported yet."""
from .segment import *
from .from_neighbors import *

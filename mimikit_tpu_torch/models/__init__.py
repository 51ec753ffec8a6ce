"""Generation over several models (counterpart of ``mimikit_tpu/models``):
``EnsembleGenerator`` chains checkpoints across sample rates, the
``NearestNextNeighbor`` generator, and the event patterns that schedule
them."""
from .ensemble_generator import *
from .nnn import *
from .patterns import *

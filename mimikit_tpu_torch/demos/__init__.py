"""The recipes of ``mimikit_tpu/demos`` on the port: each module's
``demo()`` runs the JAX recipe's workflow with the same defaults, on the
card unless the caller passes ``device="cpu"``.  Ported: ``srnn`` (the main
path's training recipe), ``serving``, the spectral recipes ``seq2seq`` and
``freqnet``, and the ensemble recipes ``ensemble_generator`` and
``checkpoint_k_bests``."""
from . import checkpoint_k_bests, ensemble_generator, freqnet, seq2seq, serving, srnn

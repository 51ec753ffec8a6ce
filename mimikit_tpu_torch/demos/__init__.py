"""The recipes of ``mimikit_tpu/demos`` on the port: each module's
``demo()`` runs the JAX recipe's workflow with the same defaults, on the
card unless the caller passes ``device="cpu"``.  Ported: ``srnn`` (the main
path's training recipe), ``serving``, and the spectral recipes ``seq2seq``
and ``freqnet``."""
from . import freqnet, seq2seq, serving, srnn

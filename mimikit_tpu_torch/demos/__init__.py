"""The recipes of ``mimikit_tpu/demos`` on the port: each module's
``demo()`` runs the JAX recipe's workflow with the same defaults, on the
card unless the caller passes ``device="cpu"``.  Ported: ``srnn`` (the main
path's training recipe) and ``serving``."""
from . import serving, srnn

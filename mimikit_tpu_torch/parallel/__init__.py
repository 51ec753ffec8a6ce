"""Multi-device serving (counterpart of ``mimikit_tpu/parallel``): the
stream batch of any network's decode sharded across devices.  The mesh
module (``parallel/mesh.py``: data- and model-parallel training) is not
ported."""
from .serving import *

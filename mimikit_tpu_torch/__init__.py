"""mimikit_tpu_torch — the PyTorch/CUDA port of mimikit_tpu.

A second package beside the JAX one (``mimikit_tpu``, the reference).  It
imports ``torch`` and never ``jax`` nor anything of ``mimikit_tpu``, keeps
the JAX package's module layout and flat ``mmk.<Name>`` namespace, and runs
its hot paths through kernels written by hand for NVIDIA Hopper
(``csrc/``).  It trains mu-law SampleRNN (``DatasetConfig.create``,
``TrainARMLoop``, ``Checkpoint``; the LSTM tiers through hand-written forward
and backward kernels), monitors the training (``GenerateLoopV2`` through a
``GenerateCallback``, the ``AudioLogger``'s wav files, the ``LossLogger``)
and serves SampleRNN, WaveNet, SimpleTransformer and
JukeBox (``generate``, ``stream``, ``stream_tokens`` and ``stream_audio``; the
transformer's window re-feed and its ``MMK_DECODE_KV=1`` KV-ring stream;
JukeBox's tier pyramid with its window carried across stream chunks), each
through hand-written decode kernels.  ``ops.mulaw`` is the mu-law pair as
one Triton kernel.

Entry points run on the card (``cuda``) unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

from .config import *
from .utils import *
from .data import *
from .features import *
from .io_spec import *
from .modules import *
from .networks import *
from .loops import *
from .ops import *
from .weights import *
from .optim import *
from .checkpoint import *

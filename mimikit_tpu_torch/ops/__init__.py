from .samplernn_decode import *
from .fused_lstm import *
from .wavenet_decode import *
from .transformer_decode import *
from .transformer_kv import *
from .jukebox_decode import *
from .mulaw import *

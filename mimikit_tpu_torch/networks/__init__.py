from .arm import *
from .sample_rnn import *
from .wavenet import *
from .transformers import *
from .s2s_lstm import *
from .tied_autoencoder import *

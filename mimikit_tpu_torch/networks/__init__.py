from .arm import *
from .sample_rnn import *

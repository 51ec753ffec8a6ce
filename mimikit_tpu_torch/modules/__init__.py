from .activations import *
from .heads import *
from .io import *
from .resamplers import *
from .rnn import *
from .targets import *

from .activations import *
from .heads import *
from .io import *
from .loss_functions import *
from .misc import *
from .resamplers import *
from .rnn import *
from .targets import *

from .batch import *
from .samplers import *
from .store import *

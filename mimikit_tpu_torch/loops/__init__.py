from .streaming import *
from .logger import *
from .callbacks import *
from .generate import *
from .device_loader import *
from .train_loops import *

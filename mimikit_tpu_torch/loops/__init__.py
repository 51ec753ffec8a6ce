from .streaming import *

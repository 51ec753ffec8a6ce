from .samplernn_decode import *

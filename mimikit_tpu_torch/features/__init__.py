from .item_spec import *
from .functionals import *
from .extractor import *
from .dataset import *

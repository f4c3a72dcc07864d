from . import device, host, params
from .params import P, get_primitive_root_of_unity

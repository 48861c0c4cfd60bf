from .lib import get_lib

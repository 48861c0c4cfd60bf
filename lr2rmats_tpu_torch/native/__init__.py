from .lib import get_lib, have_native

"""``gluon.nn``: the neural-network layers of the PyTorch port."""
from .activations import *  # noqa: F401,F403
from .activations import __all__ as _a
from .basic_layers import *  # noqa: F401,F403
from .basic_layers import __all__ as _b

__all__ = list(_a) + list(_b)

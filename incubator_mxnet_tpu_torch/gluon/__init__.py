"""Gluon layers and losses of the PyTorch port."""
from . import loss, nn

__all__ = ["loss", "nn"]

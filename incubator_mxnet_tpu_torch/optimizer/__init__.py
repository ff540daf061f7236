"""Optimizer update rules of the PyTorch port."""
from . import cores

__all__ = ["cores"]

"""Optimizers of the PyTorch port: the update cores, the eager
optimizers and their whole-tree ``FusedUpdater``."""
from . import cores
from .optimizer import (Adam, Optimizer, Updater, create, get_updater,
                        register)

__all__ = ["cores", "Optimizer", "Adam", "Updater", "create", "register",
           "get_updater"]

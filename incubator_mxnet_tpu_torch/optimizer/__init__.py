"""Optimizers of the PyTorch port: the update cores, every eager optimizer
of the JAX package and their whole-tree ``FusedUpdater``."""
from . import cores
from .optimizer import (SGD, NAG, Adam, Adamax, Nadam, AdaGrad, RMSProp,
                        AdaDelta, Ftrl, FTML, Signum, SignSGD, LAMB, LARS,
                        AdamW, GroupAdaGrad, SGLD, DCASGD, Test, Optimizer,
                        Updater, create, get_updater, register)
from .fused import FusedUpdater, functional_twin

__all__ = ["cores", "Optimizer", "SGD", "NAG", "Adam", "Adamax", "Nadam",
           "AdaGrad", "RMSProp", "AdaDelta", "Ftrl", "FTML", "Signum",
           "SignSGD", "LAMB", "LARS", "AdamW", "GroupAdaGrad", "SGLD",
           "DCASGD", "Test", "Updater", "create", "register", "get_updater",
           "FusedUpdater", "functional_twin"]

"""Gluon: the define-by-run front end of the PyTorch port (counterpart of
``incubator_mxnet_tpu/gluon/``): parameters, blocks, layers, losses and
the ``Trainer``."""
from .parameter import Constant, Parameter, ParameterDict
from .block import Block, HybridBlock
from . import loss, nn
from .trainer import Trainer

__all__ = ["Parameter", "Constant", "ParameterDict", "Block", "HybridBlock",
           "Trainer", "loss", "nn"]

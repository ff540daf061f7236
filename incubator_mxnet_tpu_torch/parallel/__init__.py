"""Training entry points of the PyTorch port: the one-device mesh, the
functional optimizers, ``SPMDTrainer`` and ``CompiledLoop``."""
from . import optim
from .loop import CompiledLoop
from .mesh import Mesh, make_mesh
from .spmd import SPMDTrainer

__all__ = ["Mesh", "make_mesh", "SPMDTrainer", "CompiledLoop", "optim"]

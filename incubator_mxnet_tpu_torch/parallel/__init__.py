"""Training entry points of the PyTorch port: the one-device mesh, the
functional optimizers and ``SPMDTrainer``."""
from . import optim
from .mesh import Mesh, make_mesh
from .spmd import SPMDTrainer

__all__ = ["Mesh", "make_mesh", "SPMDTrainer", "optim"]

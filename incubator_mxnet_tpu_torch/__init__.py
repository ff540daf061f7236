"""incubator_mxnet_tpu_torch — the PyTorch and CUDA port of
``incubator_mxnet_tpu``.

The port keeps the JAX package's module layout and names; inside, it is
plain PyTorch (``nn.Module``s and functions on tensors) with hand-written
CUDA kernels for Hopper (``kernels/csrc``).  Entry points run on
``cuda:0`` unless the caller asks for the CPU (``device="cpu"``, or a
``with mx.cpu():`` scope); with no GPU and no explicit CPU they raise
:class:`MXNetError`.

Ported so far: generation serving of the GPT models (``models``,
``serving``) behind an HTTP front (``serving.server``, the
``mxtpu-serve-torch`` command in ``_cli``) and a fleet of such replicas
behind a router, with their telemetry, fault, lifecycle, SLO and health
planes, speculative decoding; one BERT pretraining step
(``parallel.SPMDTrainer``); and the imperative training surface that
MXNet users write — ``nd`` arrays, ``autograd``, ``gluon`` parameters,
blocks, layers, losses and ``Trainer`` with every optimizer and
``lr_scheduler`` — with the kernels they run (``kernels``),
``checkpoint`` to resume a run, and the compiled k-step loop
(``parallel.CompiledLoop``, ``io.DevicePrefetcher``) with the training
health plane (``health``) and the MFU collector (``telemetry``)."""
from .base import MXNetError
from .context import Context, cpu, current_context, default_device, gpu
from . import ndarray as nd
from . import autograd, initializer as init, optimizer, random
from . import gluon

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "default_device", "nd", "autograd", "init", "optimizer",
           "random", "gluon"]

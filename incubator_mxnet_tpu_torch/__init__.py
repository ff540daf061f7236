"""incubator_mxnet_tpu_torch — the PyTorch and CUDA port of
``incubator_mxnet_tpu``.

The port keeps the JAX package's module layout and names; inside, it is
plain PyTorch (``nn.Module``s and functions on tensors) with hand-written
CUDA kernels for Hopper (``kernels/csrc``).  Entry points run on
``cuda:0`` unless the caller passes ``device="cpu"``; with no GPU and no
explicit CPU they raise :class:`MXNetError`.

Ported so far: generation serving of the GPT models (``models``,
``serving``) behind an HTTP front (``serving.server``, the
``mxtpu-serve-torch`` command in ``_cli``) with its telemetry, fault,
lifecycle, SLO and health planes, speculative decoding, and one BERT
pretraining step
(``models.bert``, ``gluon.loss``, ``optimizer``, ``parallel``), with the
seven attention kernels they run (``kernels.flash_attention``)."""
from .base import MXNetError
from .context import cpu, default_device, gpu

__all__ = ["MXNetError", "cpu", "gpu", "default_device"]

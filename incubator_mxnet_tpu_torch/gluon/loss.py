"""Loss layers of the PyTorch port (counterpart of
``incubator_mxnet_tpu/gluon/loss.py``): the :class:`Loss` base with MXNet's
weighting and batch-axis mean, and :class:`SoftmaxCrossEntropyLoss`, the
loss of the BERT pretraining step.  The other losses are not ported yet."""
from __future__ import annotations

import torch

from ..base import MXNetError
from .nn import Block

__all__ = ["Loss", "SoftmaxCrossEntropyLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


class Loss(Block):
    """A loss block: ``weight`` rescales, and :meth:`_mean_all_but_batch`
    averages every axis but ``batch_axis``."""

    _alias = "loss"

    def __init__(self, weight, batch_axis):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def _mean_all_but_batch(self, loss):
        axes = tuple(i for i in range(loss.dim()) if i != self._batch_axis)
        return loss.mean(dim=axes) if axes else loss


class SoftmaxCrossEntropyLoss(Loss):
    """``-log_softmax(pred)[label]`` along ``axis`` per sample, then the
    weighting and the mean over every axis but the batch axis.  Labels are
    class indices, which may arrive as floats; they are cast to int64 and
    clipped into range as MXNet's ``pick`` clips them.  Dense labels
    (``sparse_label=False``) and ``from_logits`` are not ported."""

    _alias = "softmaxcrossentropyloss"

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        if not sparse_label or from_logits:
            raise MXNetError("SoftmaxCrossEntropyLoss: dense labels and "
                             "from_logits are not ported")
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        pred = torch.log_softmax(pred, dim=self._axis)
        idx = label.long().clamp(0, pred.shape[self._axis] - 1)
        loss = -torch.gather(pred, self._axis, idx.unsqueeze(self._axis))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)

"""Loss layers of the PyTorch port (counterpart of
``incubator_mxnet_tpu/gluon/loss.py``): every loss of the reference but
``CTCLoss`` (ROADMAP Queue A item 15), each a ``HybridBlock`` over
tensors with the reference's ``weight`` / ``sample_weight`` weighting
and its mean over every axis but ``batch_axis``."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "PoissonNLLLoss",
           "CosineEmbeddingLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _softrelu(x):
    """MXNet's ``softrelu``: log(1 + exp(x))."""
    return F.softplus(x)


class Loss(HybridBlock):
    """A loss block: ``weight`` rescales, and :meth:`_mean_all_but_batch`
    averages every axis but ``batch_axis``."""

    def __init__(self, weight, batch_axis, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._weight = weight
        self._batch_axis = batch_axis

    def _mean_all_but_batch(self, loss):
        axes = tuple(i for i in range(loss.dim()) if i != self._batch_axis)
        return loss.mean(dim=axes) if axes else loss

    def __repr__(self):
        return (f"{type(self).__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")


class L2Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(label.reshape(pred.shape) - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return self._mean_all_but_batch(loss)


class L1Loss(Loss):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy on logits (stable log-sum-exp form) or, with
    ``from_sigmoid``, on probabilities."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = torch.relu(pred) - pred * label \
                    + _softrelu(-torch.abs(pred))
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = torch.relu(pred) - pred * label + log_weight * (
                    _softrelu(-torch.abs(pred)) + torch.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(torch.log(pred + eps) * label
                         + torch.log(1. - pred + eps) * (1. - label))
            else:
                loss = -(torch.log(pred + eps) * label * pos_weight
                         + torch.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """``-log_softmax(pred)`` picked at ``label`` along ``axis`` (class
    indices, which may arrive as floats, clipped into range as MXNet's
    ``pick`` clips them), or summed against dense ``label`` rows
    (``sparse_label=False``); then the weighting and the mean over every
    axis but the batch axis."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = torch.log_softmax(pred, dim=self._axis)
        if self._sparse_label:
            idx = label.long().clamp(0, pred.shape[self._axis] - 1)
            loss = -torch.gather(pred, self._axis, idx.unsqueeze(self._axis))
        else:
            loss = -torch.sum(pred * label.reshape(pred.shape),
                              dim=self._axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = torch.log_softmax(pred, dim=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


class HuberLoss(Loss):
    def __init__(self, rho=1.0, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(loss))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.relu(self._margin - pred * label.reshape(pred.shape))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(torch.relu(
            self._margin - pred * label.reshape(pred.shape)))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


class LogisticLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise MXNetError(f"bad label_format {label_format}")
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.relu(pred) - pred * label \
            + _softrelu(-torch.abs(pred))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


class TripletLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = positive.reshape(pred.shape)
        negative = negative.reshape(pred.shape)
        d = torch.square(positive - pred) - torch.square(negative - pred)
        loss = d.sum(dim=self._batch_axis + 1) if pred.dim() > 1 else d
        loss = torch.relu(loss + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = target.reshape(pred.shape)
        if self._from_logits:
            loss = torch.exp(pred) - target * pred
        else:
            loss = pred - target * torch.log(pred + epsilon)
        if self._compute_full:
            # Stirling's approximation of log(target!)
            stirling = (target * torch.log(target + 1e-12) - target
                        + 0.5 * torch.log(2 * math.pi * (target + 1e-12)))
            stirling = torch.where(target <= 1, torch.zeros_like(stirling),
                                   stirling)
            loss = loss + stirling
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean()


class CosineEmbeddingLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        input1 = input1.reshape(input2.shape)
        cos = (torch.sum(input1 * input2, dim=-1)
               / (torch.sqrt(torch.sum(input1 * input1, dim=-1))
                  * torch.sqrt(torch.sum(input2 * input2, dim=-1)) + 1e-12))
        label = label.reshape(cos.shape)
        loss = torch.where(label == 1, 1.0 - cos,
                           torch.relu(cos - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)

"""``mx.io`` of the PyTorch port: only the training loop's device
prefetch is ported (:class:`DevicePrefetcher`); the data iterators and
RecordIO are ROADMAP Queue A item 17."""
from .prefetch import DevicePrefetcher

__all__ = ["DevicePrefetcher"]

"""Generation serving of the PyTorch port: the paged KV-cache pool, the
sampling plane, the generation engine, the continuous batcher with its
fault domains (``lifecycle``), SLO accounting (``slo``) and metrics, and
the HTTP front (``server.ModelServer``)."""
from .batcher import ContinuousBatcher, QueueFullError
from .engine import GenerationEngine, derive_prefill_buckets
from .kvcache import NULL_BLOCK, BlockPool, blocks_for
from .lifecycle import (BreakerOpen, Cancelled, CircuitBreaker,
                        DeadlineExceeded, Draining, RequestAborted,
                        Watchdog)
from .sampling import MASK_OFF, SamplingParams
from .server import ModelServer

__all__ = ["BlockPool", "blocks_for", "NULL_BLOCK", "SamplingParams",
           "MASK_OFF", "GenerationEngine", "derive_prefill_buckets",
           "ContinuousBatcher", "QueueFullError", "Cancelled",
           "RequestAborted", "DeadlineExceeded", "BreakerOpen", "Draining",
           "CircuitBreaker", "Watchdog", "ModelServer"]

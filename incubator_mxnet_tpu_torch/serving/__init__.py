"""Serving of the PyTorch port: the one-shot engine
(``InferenceEngine``, batch-size buckets) behind its dynamic batcher, the
paged KV-cache pool, the sampling plane, the generation engine, the
continuous batcher with its fault domains (``lifecycle``), SLO accounting (``slo``) and metrics, the
HTTP front (``server.ModelServer``), and the fleet above it: the router
(``router.Router``) and the supervisor (``supervisor.Supervisor``), which
run no model and never touch the card."""
from .batcher import ContinuousBatcher, DynamicBatcher, QueueFullError
from .engine import (GenerationEngine, InferenceEngine, derive_buckets,
                     derive_prefill_buckets)
from .kvcache import NULL_BLOCK, BlockPool, blocks_for
from .lifecycle import (BreakerOpen, Cancelled, CircuitBreaker,
                        DeadlineExceeded, Draining, RequestAborted,
                        Watchdog)
from .sampling import MASK_OFF, SamplingParams
from .server import ModelServer
from .router import NoReplicaAvailable, Replica, Router, UpstreamError
from .supervisor import (AutoscalePolicy, FlapBreaker, ScaleAction,
                         ScaleSignals, Supervisor, scale_decision)

__all__ = ["BlockPool", "blocks_for", "NULL_BLOCK", "SamplingParams",
           "MASK_OFF", "InferenceEngine", "derive_buckets",
           "DynamicBatcher", "GenerationEngine", "derive_prefill_buckets",
           "ContinuousBatcher", "QueueFullError", "Cancelled",
           "RequestAborted", "DeadlineExceeded", "BreakerOpen", "Draining",
           "CircuitBreaker", "Watchdog", "ModelServer", "Router", "Replica",
           "UpstreamError", "NoReplicaAvailable", "Supervisor",
           "AutoscalePolicy", "ScaleSignals", "ScaleAction",
           "scale_decision", "FlapBreaker"]

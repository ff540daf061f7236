"""Serving metrics of the port, registered on the shared telemetry
registry at import (the series of
``incubator_mxnet_tpu/serving/metrics.py`` that the port's serving path,
router, supervisor and autoscaler emit, same names and help).  Counters
and gauges are labeled by ``model`` (the router's by ``replica``);
histograms are registry-wide.  ``mxtpu_kernel_launches`` is the port's
own: the launches of each hand-written CUDA kernel in this process,
refreshed at scrape (:func:`refresh_kernel_launches`)."""
from __future__ import annotations

from .. import telemetry as _telemetry

# counters -----------------------------------------------------------------
REQUESTS = _telemetry.registry.counter(
    "mxtpu_serve_requests",
    "inference requests accepted into a DynamicBatcher queue")
BATCHES = _telemetry.registry.counter(
    "mxtpu_serve_batches",
    "coalesced batch dispatches (one compiled forward per batch)")
REJECTED = _telemetry.registry.counter(
    "mxtpu_serve_rejected",
    "requests rejected with QueueFullError (backpressure)")
FALLBACKS = _telemetry.registry.counter(
    "mxtpu_serve_fallbacks",
    "batched dispatches that failed after retries and fell back to "
    "single-request execution")
DEADLINE_EXCEEDED = _telemetry.registry.counter(
    "mxtpu_serve_deadline_exceeded",
    "requests shed because their end-to-end deadline expired "
    "(stage=admission|queue|wait|decode)")
GENERATE_TOKENS = _telemetry.registry.counter(
    "mxtpu_generate_tokens",
    "tokens emitted by the continuous-batching generation path")
CANCELLED = _telemetry.registry.counter(
    "mxtpu_serve_cancelled",
    "generation requests cancelled mid-decode (client disconnect); the "
    "slot frees on the next step boundary")
WATCHDOG_RESTARTS = _telemetry.registry.counter(
    "mxtpu_serve_watchdog_restarts",
    "batcher workers restarted by the serving watchdog (dead or hung)")
BREAKER_TRIPS = _telemetry.registry.counter(
    "mxtpu_serve_breaker_trips",
    "per-model circuit breaker CLOSED/HALF_OPEN -> OPEN transitions")
SLO_BAD = _telemetry.registry.counter(
    "mxtpu_slo_bad_requests",
    "requests that burned error budget (any failure surfaced to the "
    "caller: backpressure, breaker, deadline, abort, dispatch error)")
PREFIX_CACHE_HITS = _telemetry.registry.counter(
    "mxtpu_prefix_cache_hits",
    "KV blocks reused from the prefix cache instead of being "
    "re-prefilled (one increment per shared block)")
PREFIX_CACHE_EVICTIONS = _telemetry.registry.counter(
    "mxtpu_prefix_cache_evictions",
    "idle cached KV blocks evicted (LRU) to satisfy new allocations")
SPEC_DISPATCHES = _telemetry.registry.counter(
    "mxtpu_spec_verify_dispatches",
    "speculative-decoding verify dispatches (one k+1-wide target "
    "forward scoring all drafted positions at once)")
SPEC_DRAFT_TOKENS = _telemetry.registry.counter(
    "mxtpu_spec_draft_tokens",
    "tokens proposed by the draft model, per target model")
SPEC_ACCEPTED_TOKENS = _telemetry.registry.counter(
    "mxtpu_spec_accepted_tokens",
    "drafted tokens the target model accepted and emitted (excludes "
    "the guaranteed bonus token per dispatch)")
NONFINITE_GENERATIONS = _telemetry.registry.counter(
    "mxtpu_health_nonfinite_generations",
    "decode steps whose logits contained a non-finite value for at "
    "least one live slot (health plane, MXNET_HEALTH_PLANE=1)")

# sampling plane (serving/sampling.py; docs/serving.md "Sampling") ----------
SAMPLED_REQUESTS = _telemetry.registry.counter(
    "mxtpu_sample_requests",
    "generation requests admitted, by mode=greedy|sampled "
    "(sampled: temperature > 0)")
SAMPLE_TOKENS = _telemetry.registry.counter(
    "mxtpu_sample_tokens",
    "tokens emitted by stochastically sampled (temperature > 0) "
    "requests, per model")
SAMPLE_CONSTRAINED = _telemetry.registry.counter(
    "mxtpu_sample_constrained_requests",
    "generation requests decoded under a constrained-output grammar "
    "mask (json_mode), per model")
SAMPLE_STOP_HITS = _telemetry.registry.counter(
    "mxtpu_sample_stop_hits",
    "generation requests finished by a multi-token stop sequence at "
    "an emit boundary, per model")
SAMPLE_STOP_TRIMMED = _telemetry.registry.counter(
    "mxtpu_sample_stop_trimmed_tokens",
    "over-generated burst-tail tokens discarded host-side past a stop "
    "sequence (their K/V writes were already null-block-redirected)")

# router (serving/router.py; labeled by replica where it matters) ----------
ROUTER_REQUESTS = _telemetry.registry.counter(
    "mxtpu_router_requests",
    "client requests accepted by the mxtpu-router front tier")
ROUTER_RETRIES = _telemetry.registry.counter(
    "mxtpu_router_retries",
    "upstream attempts beyond the first (connect error / 503 / 429 "
    "re-routed under the per-request retry budget)")
ROUTER_FAILOVERS = _telemetry.registry.counter(
    "mxtpu_router_failovers",
    "requests that ultimately succeeded on a different replica than "
    "the first one tried")
ROUTER_EJECTIONS = _telemetry.registry.counter(
    "mxtpu_router_ejections",
    "replica ejections (health-loop breaker CLOSED/HALF_OPEN -> OPEN)")
ROUTER_AFFINITY = _telemetry.registry.counter(
    "mxtpu_router_affinity_routed",
    "generation requests routed to their rendezvous-hash prefix owner")
ROUTER_SPILLS = _telemetry.registry.counter(
    "mxtpu_router_spills",
    "generation requests spilled off their prefix owner because it was "
    "overloaded, draining, or ejected")
ROUTER_STREAM_ERRORS = _telemetry.registry.counter(
    "mxtpu_router_stream_errors",
    "streams terminated with an SSE error event after a mid-stream "
    "replica death (tokens already on the wire - no silent failover)")
ROUTER_REPLICA_STATE = _telemetry.registry.gauge(
    "mxtpu_router_replica_state",
    "per-replica router view (0 READY, 1 UNREADY, 2 DRAINING, "
    "3 EJECTED, 4 DOWN)")
ROUTER_REPLICAS_ELIGIBLE = _telemetry.registry.gauge(
    "mxtpu_router_replicas_eligible",
    "replicas currently eligible for new work")
ROUTER_INFLIGHT = _telemetry.registry.gauge(
    "mxtpu_router_inflight",
    "client requests in flight through the router, per replica")
ROUTER_INCIDENTS = _telemetry.registry.counter(
    "mxtpu_router_incidents",
    "correlated incident bundles written (ejection / "
    "failover-exhaustion / drain-timeout), by reason")
ROUTER_FEDERATION_STALE = _telemetry.registry.gauge(
    "mxtpu_router_federation_stale",
    "replicas whose cached metrics snapshot has aged past the "
    "staleness horizon and is excluded from fleet totals")
ROUTER_TRACE_FANOUT = _telemetry.registry.counter(
    "mxtpu_router_trace_fanout",
    "replica /trace fetches made while stitching fleet traces")
ROUTER_MEMBERSHIP = _telemetry.registry.counter(
    "mxtpu_router_membership_changes",
    "fleet membership changes (POST/DELETE /admin/replicas), by "
    "action=join|leave")

# supervisor + autoscaler (serving/supervisor.py; control-plane series,
# rendered once on the router /metrics — docs/observability.md) -----------
SUPERVISE_SPAWNS = _telemetry.registry.counter(
    "mxtpu_supervise_spawns",
    "replica processes spawned by mxtpu-supervise (first launches and "
    "restarts alike)")
SUPERVISE_RESTARTS = _telemetry.registry.counter(
    "mxtpu_supervise_restarts",
    "replica restarts after a detected crash or hang (exit, /healthz "
    "timeout), per replica slot")
SUPERVISE_QUARANTINES = _telemetry.registry.counter(
    "mxtpu_supervise_quarantines",
    "replica slots quarantined by the flap breaker "
    "(MXNET_SUPERVISE_MAX_RESTARTS within the window)")
SUPERVISE_REPLICAS = _telemetry.registry.gauge(
    "mxtpu_supervise_replicas",
    "supervised replica processes currently alive")
AUTOSCALE_EVENTS = _telemetry.registry.counter(
    "mxtpu_autoscale_events",
    "executed scale actions, by action=up|down (scale-down always "
    "routes through /admin/drain)")
AUTOSCALE_DECISIONS = _telemetry.registry.counter(
    "mxtpu_autoscale_decisions",
    "autoscale policy evaluations, by action=up|down|hold")
AUTOSCALE_TARGET = _telemetry.registry.gauge(
    "mxtpu_autoscale_target_replicas",
    "fleet size the autoscaler is currently steering toward")
AUTOSCALE_BURN = _telemetry.registry.gauge(
    "mxtpu_autoscale_burn_rate",
    "worst-model fleet SLO burn rate the last policy evaluation saw")
AUTOSCALE_QUEUE = _telemetry.registry.gauge(
    "mxtpu_autoscale_queue_depth",
    "fleet-summed serve queue depth the last policy evaluation saw")
AUTOSCALE_KV = _telemetry.registry.gauge(
    "mxtpu_autoscale_kv_utilization",
    "worst-replica KV-cache utilization the last policy evaluation saw")

# histograms ---------------------------------------------------------------
BATCH_SIZE = _telemetry.registry.histogram(
    "mxtpu_serve_batch_size",
    "rows per coalesced dispatch (before bucket padding)")
QUEUE_WAIT = _telemetry.registry.histogram(
    "mxtpu_serve_queue_wait_seconds",
    "seconds a request waited in the queue before its batch dispatched")
LATENCY = _telemetry.registry.histogram(
    "mxtpu_serve_latency_seconds",
    "end-to-end seconds from submit to scattered result")
TOKEN_LATENCY = _telemetry.registry.histogram(
    "mxtpu_generate_token_seconds",
    "seconds between consecutive emitted tokens of one generation "
    "request (first sample: submit -> first token)")
DECODE_STEP = _telemetry.registry.histogram(
    "mxtpu_generate_decode_step_seconds",
    "seconds per continuous-batching decode dispatch (all live slots "
    "advance one token)")
DECODE_BURST_TOKENS = _telemetry.registry.histogram(
    "mxtpu_decode_burst_tokens",
    "tokens emitted per scanned decode-burst dispatch, summed across "
    "live slots (ceiling is scan_steps x slots; a thin tail means "
    "in-program termination is cutting bursts short)")
SPEC_STEP = _telemetry.registry.histogram(
    "mxtpu_spec_step_seconds",
    "seconds per speculative step (k draft dispatches plus one verify; "
    "compare with mxtpu_generate_decode_step_seconds for the draft "
    "overhead per accepted-token burst)")
ROUTER_UPSTREAM = _telemetry.registry.histogram(
    "mxtpu_router_upstream_seconds",
    "seconds per upstream attempt (router -> replica), successful or "
    "not")

# gauges -------------------------------------------------------------------
QUEUE_DEPTH = _telemetry.registry.gauge(
    "mxtpu_serve_queue_depth",
    "requests currently queued, per model")
SLOTS_IN_USE = _telemetry.registry.gauge(
    "mxtpu_serve_cache_slots_in_use",
    "KV-cache slots occupied by live generation requests, per model")
KV_BLOCKS_TOTAL = _telemetry.registry.gauge(
    "mxtpu_kv_blocks_total",
    "allocatable KV-cache blocks in the paged BlockPool, per model")
KV_BLOCKS_IN_USE = _telemetry.registry.gauge(
    "mxtpu_kv_blocks_in_use",
    "KV-cache blocks held by live slots or pinned in the prefix "
    "cache with a nonzero refcount, per model")
MODELS_LOADED = _telemetry.registry.gauge(
    "mxtpu_serve_models_loaded",
    "models registered on the ModelServer")
BREAKER_STATE = _telemetry.registry.gauge(
    "mxtpu_serve_breaker_state",
    "per-model circuit breaker state (0 CLOSED, 1 HALF_OPEN, 2 OPEN)")
MODEL_STATE = _telemetry.registry.gauge(
    "mxtpu_serve_model_state",
    "per-model serving state (0 SERVING, 1 STARTING, 2 DEGRADED, "
    "3 UNHEALTHY, 4 DRAINING)")
SPEC_TOKENS_PER_DISPATCH = _telemetry.registry.gauge(
    "mxtpu_spec_accepted_tokens_per_dispatch",
    "tokens emitted per verify dispatch, cumulative per model "
    "(1.0 would mean the draft never helps; k+1 is the ceiling)")
SPEC_ACCEPT_RATE = _telemetry.registry.gauge(
    "mxtpu_spec_accept_rate",
    "fraction of drafted tokens the target accepted, cumulative per "
    "model and by mode=greedy|sampled (sampled: any live slot decoding "
    "at temperature > 0; tune MXNET_SPEC_K down when this drops)")
HEALTH_LOGIT_MAX = _telemetry.registry.gauge(
    "mxtpu_health_logit_max",
    "max final-position logit across live slots in the most recent "
    "decode dispatch (health plane; drifting up signals divergence)")
HEALTH_DECODE_ENTROPY = _telemetry.registry.gauge(
    "mxtpu_health_decode_entropy",
    "mean final-position softmax entropy (nats) across live slots in "
    "the most recent decode dispatch (health plane; near-zero = "
    "degenerate repetition, near log(vocab) = noise)")
DISPATCHES_PER_TOKEN = _telemetry.registry.gauge(
    "mxtpu_dispatches_per_token",
    "target-model dispatches per emitted token, cumulative per model "
    "(per-slot normalized: exactly 1.0 for per-step decode, <= "
    "1/scan_steps at steady state on the scanned burst path, and "
    "1/(accepted burst) when speculation amortizes the verify "
    "dispatch)")


# SLO plane (serving/slo.py; docs/observability.md) -------------------------
SLO_AVAILABILITY = _telemetry.registry.gauge(
    "mxtpu_slo_availability",
    "rolling-window availability SLI, per model")
SLO_P99 = _telemetry.registry.gauge(
    "mxtpu_slo_p99_seconds",
    "rolling-window p99 end-to-end latency SLI, per model")
SLO_BURN = _telemetry.registry.gauge(
    "mxtpu_slo_burn_rate",
    "error-budget burn rate (1.0 = spending exactly the budget the "
    "objective allows), per model")
SLO_BUDGET = _telemetry.registry.gauge(
    "mxtpu_slo_error_budget_remaining",
    "fraction of the error budget left in the rolling window "
    "(0 = exhausted -> readiness blocker), per model")

# the port's CUDA kernels --------------------------------------------------
KERNEL_LAUNCHES = _telemetry.registry.gauge(
    "mxtpu_kernel_launches",
    "launches of each hand-written CUDA kernel in this process (CUDA "
    "graph replays count the launches they hold), by kernel")


def refresh_kernel_launches() -> None:
    """Copy the kernel wrappers' launch counters into
    ``mxtpu_kernel_launches``."""
    from ..kernels.flash_attention import launch_counts
    for name, n in dict(launch_counts).items():
        KERNEL_LAUNCHES.set(n, kernel=name)

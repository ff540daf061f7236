"""Registry hygiene for port test modules that create metrics lazily
(the health plane's ``mxtpu_health_*`` gauges, the MFU collector's
series): the telemetry registry is process-wide, and a later test file
on the same xdist worker compares the series ``/metrics`` serves with
the JAX package's.

:func:`registry_hygiene` (module scope) imports the port's training
modules first, so every metric a module creates at import is registered
before it looks, and at the module's end it removes the metrics the
module's tests registered.  Those are all get-or-create by name at their
use, so removing them is safe.  A test module takes the fixture by
importing it."""
import importlib

import pytest

_MODULES = ("incubator_mxnet_tpu_torch.telemetry",
            "incubator_mxnet_tpu_torch.telemetry_ring",
            "incubator_mxnet_tpu_torch.health",
            "incubator_mxnet_tpu_torch.checkpoint",
            "incubator_mxnet_tpu_torch.convert",
            "incubator_mxnet_tpu_torch.gluon",
            "incubator_mxnet_tpu_torch.optimizer.fused",
            "incubator_mxnet_tpu_torch.parallel.loop",
            "incubator_mxnet_tpu_torch.io.prefetch")


@pytest.fixture(scope="module", autouse=True)
def registry_hygiene():
    for name in _MODULES:
        importlib.import_module(name)
    from incubator_mxnet_tpu_torch import telemetry
    registry = telemetry.registry
    before = set(registry._metrics)
    yield
    with registry._lock:
        for name in set(registry._metrics) - before:
            del registry._metrics[name]

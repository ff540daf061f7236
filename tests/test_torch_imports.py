"""The port stands alone: importing every module of
``incubator_mxnet_tpu_torch`` (in a fresh interpreter) pulls in neither
``jax`` nor the JAX package, ``chip_smoke.py`` imports neither, and an
entry point called without ``device`` on a host without a GPU raises
instead of running on the CPU (the serving models, BERT, the one-device
mesh, the one-shot engine, the device prefetcher and the compiled
loop).  The fleet's control plane (``serving.router``,
``serving.supervisor``) imports and builds its objects without touching
CUDA: no call reaches ``torch.cuda``'s lazy initialisation."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "incubator_mxnet_tpu")

_PROBE = r"""
import importlib, json, pkgutil, sys
import incubator_mxnet_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny
from incubator_mxnet_tpu_torch.models.bert import bert_tiny
from incubator_mxnet_tpu_torch.parallel import make_mesh
from incubator_mxnet_tpu_torch import default_device
from incubator_mxnet_tpu_torch.serving import InferenceEngine
from incubator_mxnet_tpu_torch.io import DevicePrefetcher
from incubator_mxnet_tpu_torch.parallel.loop import CompiledLoop
raised = []
for fn in (default_device, lambda: gpt_tiny(dropout=0.0),
           lambda: bert_tiny(dropout=0.0), lambda: make_mesh({"data": 1}),
           lambda: InferenceEngine(lambda *a: a[0], ("data",),
                                   lambda: ((), ()), buckets=(1,)),
           lambda: DevicePrefetcher([]),
           lambda: CompiledLoop(bert_tiny(dropout=0.0, device="cpu"),
                                lambda *a: a[0], "sgd",
                                mesh=make_mesh({"data": 1}))):
    try:
        fn()
        raised.append(False)
    except MXNetError:
        raised.append(True)
print(json.dumps({"modules": mods, "loaded": sorted(sys.modules),
                  "raised": raised}))
"""


@pytest.fixture(scope="module")
def probe():
    # an empty CUDA_VISIBLE_DEVICES hides any GPU: a CPU-only host
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_neither_jax_nor_the_jax_package(probe):
    for mod in ("serving.engine", "kernels.flash_attention", "models.bert",
                "gluon.loss", "optimizer.cores", "parallel.optim",
                "parallel.mesh", "parallel.spmd", "telemetry",
                "telemetry_ring", "telemetry_device", "telemetry_http",
                "http_util", "fault", "health", "_cli", "serving.server",
                "serving.lifecycle", "serving.slo", "serving.metrics",
                "serving.router", "serving.supervisor", "serving.batcher",
                "cuda_graphs", "lr_scheduler", "checkpoint", "random",
                "ndarray.optimizer_ops", "optimizer.optimizer",
                "optimizer.fused", "parallel.loop", "io", "io.prefetch"):
        assert "incubator_mxnet_tpu_torch." + mod in probe["modules"]
    bad = [m for m in probe["loaded"]
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_entry_points_without_device_raise_on_a_cpu_only_host(probe):
    assert probe["raised"] == [True] * 7


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert "incubator_mxnet_tpu_torch" in {n.split(".")[0] for n in names}
    assert [n for n in names if n.split(".")[0] in FORBIDDEN] == []


_CONTROL_PLANE = r"""
import json, sys, torch
calls = []
real = torch.cuda._lazy_init
def spy():
    calls.append(1)
    return real()
torch.cuda._lazy_init = spy
from incubator_mxnet_tpu_torch._cli import router_main, supervise_main
from incubator_mxnet_tpu_torch.serving.router import Router
from incubator_mxnet_tpu_torch.serving.supervisor import (Supervisor,
                                                          scale_decision,
                                                          ScaleSignals)
r = Router(["127.0.0.1:9"], port=0)
s = Supervisor([sys.executable, "-c", "pass", "{port}"], autoscale=False)
scale_decision(ScaleSignals(replicas=1))
r.render_fleet_metrics()
print(json.dumps({"lazy_init_calls": len(calls),
                  "initialized": torch.cuda.is_initialized()}))
"""


def test_router_and_supervisor_never_touch_cuda():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env = {k: v for k, v in env.items() if not k.startswith("MXNET_")}
    out = subprocess.run([sys.executable, "-c", _CONTROL_PLANE], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"lazy_init_calls": 0, "initialized": False}


@pytest.mark.parametrize("name", ["lr_scheduler.py", "checkpoint.py",
                                  "ndarray/optimizer_ops.py",
                                  "optimizer/optimizer.py",
                                  "optimizer/fused.py", "random.py"])
def test_copied_modules_import_only_the_port(name):
    """``lr_scheduler.py`` and ``checkpoint.py`` (and the optimizer
    modules) are the port's own copies: every import is the standard
    library, numpy, torch or the port itself (relative), never the JAX
    package."""
    tree = ast.parse((ROOT / "incubator_mxnet_tpu_torch" / name).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & set(FORBIDDEN), roots
    assert roots <= {"__future__", "base64", "json", "math", "os", "pickle",
                     "re", "threading", "typing", "numpy", "torch"}, roots

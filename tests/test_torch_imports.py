"""The port stands alone: importing every module of
``incubator_mxnet_tpu_torch`` (in a fresh interpreter) pulls in neither
``jax`` nor the JAX package, ``chip_smoke.py`` imports neither, and an
entry point called without ``device`` on a host without a GPU raises
instead of running on the CPU (the serving models, BERT and the
one-device mesh)."""
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
raised = []
for fn in (default_device, lambda: gpt_tiny(dropout=0.0),
           lambda: bert_tiny(dropout=0.0), lambda: make_mesh({"data": 1})):
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
                "serving.lifecycle", "serving.slo", "serving.metrics"):
        assert "incubator_mxnet_tpu_torch." + mod in probe["modules"]
    bad = [m for m in probe["loaded"]
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_entry_points_without_device_raise_on_a_cpu_only_host(probe):
    assert probe["raised"] == [True, True, True, True]


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

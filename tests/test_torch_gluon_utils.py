"""``gluon/utils.py`` of the port against the JAX package's, on the CPU:
``split_data``, ``split_and_load`` (one context), ``clip_global_norm``,
``check_sha1``, ``download`` and ``shape_is_known``.

The JAX side runs in a child interpreter with every ``MXNET_*`` variable
unset and writes its results to files in ``tmp_path``.  ``download``
fetches only from a file in ``tmp_path`` (a path and a ``file://`` URL)
and from an HTTP server on ``localhost`` that serves ``tmp_path``, which
the test starts and stops.  Arrays: bit for bit (slices, placements) and
within 1e-6 relative (the clipped arrays and the norm, fp32); every other
result equal."""
import functools
import hashlib
import http.server
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.gluon import utils as gutils

ROOT = Path(__file__).resolve().parents[1]

SHAPES = [None, (), (3, 0), (2, 3), (0,), (4, -1), (2, None), (1, 1, 5)]
SPLITS = [((6, 4), 3, 0, True), ((6, 4), 4, 1, True), ((7, 2), 3, 0, False),
          ((5, 3), 2, 0, False)]
CLIPS = [1.0, 5.0, 100.0]

_CHILD = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import json, os, sys
import numpy as np
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.gluon import utils

tmp, url = sys.argv[1], sys.argv[2]
spec = json.loads(open(os.path.join(tmp, "spec.json")).read())
res, arrays = {}, {}
res["known"] = [utils.shape_is_known(None if s is None else tuple(s))
                for s in spec["shapes"]]
for i, (shape, n, axis, even) in enumerate(spec["splits"]):
    x = mx.nd.array(np.arange(np.prod(shape), dtype=np.float32)
                    .reshape(shape))
    for j, part in enumerate(utils.split_data(x, n, axis, even)):
        arrays["split%d/%d" % (i, j)] = part.asnumpy()
try:
    utils.split_data(mx.nd.ones((5, 2)), 2)
    res["uneven"] = None
except Exception as e:
    res["uneven"] = type(e).__name__
loaded = utils.split_and_load(np.arange(6.0).reshape(3, 2), [mx.cpu()])
arrays["loaded"] = loaded[0].asnumpy()
res["loaded_n"] = len(loaded)
for i, m in enumerate(spec["clips"]):
    xs = [mx.nd.array(np.asarray(a, np.float32)) for a in spec["clip_in"]]
    res["norm%d" % i] = float(utils.clip_global_norm(xs, m))
    for j, a in enumerate(xs):
        arrays["clip%d/%d" % (i, j)] = a.asnumpy()
src = os.path.join(tmp, "blob.bin")
sha = spec["sha"]
res["sha_ok"] = utils.check_sha1(src, sha)
res["sha_bad"] = utils.check_sha1(src, "0" * 40)
dst = os.path.join(tmp, "jax_dl")
os.makedirs(dst, exist_ok=True)
got = []
for u in (src, "file://" + src, url + "/blob.bin"):
    p = utils.download(u, path=os.path.join(dst, "f%d.bin" % len(got)),
                       sha1_hash=sha)
    got.append(open(p, "rb").read() == open(src, "rb").read())
res["downloads"] = got
res["into_dir"] = os.path.basename(utils.download(url + "/blob.bin",
                                                  path=dst))
try:
    utils.download(url + "/missing.bin", path=os.path.join(dst, "m.bin"),
                   retries=1)
    res["missing"] = None
except Exception as e:
    res["missing"] = type(e).__name__
res["missing_left"] = os.path.exists(os.path.join(dst, "m.bin"))
try:
    utils.download(src, path=os.path.join(dst, "bad.bin"),
                   sha1_hash="0" * 40)
    res["bad_sha"] = None
except Exception as e:
    res["bad_sha"] = type(e).__name__
res["bad_left"] = os.path.exists(os.path.join(dst, "bad.bin"))
np.savez(os.path.join(tmp, "jax.npz"), **arrays)
json.dump(res, open(os.path.join(tmp, "jax.json"), "w"))
print("ok")
"""


class _Quiet(http.server.SimpleHTTPRequestHandler):
    def log_message(self, *args):
        pass


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """An HTTP server on localhost serving a directory under tmp_path."""
    root = tmp_path_factory.mktemp("served")
    blob = np.random.RandomState(5).bytes(70000)
    (root / "blob.bin").write_bytes(blob)
    handler = functools.partial(_Quiet, directory=str(root))
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield root, f"http://127.0.0.1:{httpd.server_address[1]}", \
            hashlib.sha1(blob).hexdigest()
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def _clip_inputs():
    rng = np.random.RandomState(8)
    return [rng.randn(3, 4).tolist(), (rng.randn(5) * 3).tolist()]


@pytest.fixture(scope="module")
def ref(server):
    root, url, sha = server
    spec = {"shapes": [None if s is None else list(s) for s in SHAPES],
            "splits": [[list(a), n, ax, ev] for a, n, ax, ev in SPLITS],
            "clips": CLIPS, "clip_in": _clip_inputs(), "sha": sha}
    (root / "spec.json").write_text(json.dumps(spec))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(root), url],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(root / "jax.npz") as z:
        arrays = dict(z)
    return arrays, json.loads((root / "jax.json").read_text())


def test_shape_is_known_matches_jax(ref):
    _, res = ref
    assert [gutils.shape_is_known(s) for s in SHAPES] == res["known"]


@pytest.mark.parametrize("i", range(len(SPLITS)))
def test_split_data_matches_jax(ref, i):
    arrays, _ = ref
    shape, n, axis, even = SPLITS[i]
    with mx.cpu():
        x = mx.nd.array(np.arange(np.prod(shape), dtype=np.float32)
                        .reshape(shape))
        parts = gutils.split_data(x, n, axis, even)
    want = sorted(k for k in arrays if k.startswith(f"split{i}/"))
    assert len(parts) == len(want)
    for j, part in enumerate(parts):
        np.testing.assert_array_equal(part.asnumpy(),
                                      arrays[f"split{i}/{j}"])


def test_split_refusals_and_split_and_load_match_jax(ref):
    arrays, res = ref
    with mx.cpu():
        with pytest.raises(MXNetError, match="evenly split"):
            gutils.split_data(mx.nd.ones((5, 2)), 2)
        loaded = gutils.split_and_load(np.arange(6.0).reshape(3, 2),
                                       [mx.cpu()])
        two = gutils.split_and_load(np.arange(8.0).reshape(4, 2),
                                    [mx.cpu(), mx.cpu()])
    assert res["uneven"] == "MXNetError"
    assert len(loaded) == res["loaded_n"] == 1
    assert loaded[0].context == mx.cpu()
    np.testing.assert_array_equal(loaded[0].asnumpy(), arrays["loaded"])
    assert [a.shape for a in two] == [(2, 2), (2, 2)]


@pytest.mark.parametrize("i", range(len(CLIPS)))
def test_clip_global_norm_matches_jax(ref, i):
    """The norm returned and the arrays scaled in place (or left, below
    ``max_norm``) equal JAX's."""
    arrays, res = ref
    with mx.cpu():
        xs = [mx.nd.array(np.asarray(a, np.float32))
              for a in _clip_inputs()]
        norm = gutils.clip_global_norm(xs, CLIPS[i])
    np.testing.assert_allclose(norm, res[f"norm{i}"], rtol=1e-6)
    for j, a in enumerate(xs):
        np.testing.assert_allclose(a.asnumpy(), arrays[f"clip{i}/{j}"],
                                   rtol=1e-6, atol=1e-7)
    with pytest.raises(MXNetError, match="no arrays"):
        gutils.clip_global_norm([], 1.0)


def test_check_sha1_and_download_match_jax(ref, server, tmp_path):
    """``check_sha1``; ``download`` from a path, a ``file://`` URL and the
    local HTTP server, into a file and into a directory; a 404 and a
    hash mismatch raise and leave no file; an existing good file is
    kept."""
    root, url, sha = server
    _, res = ref
    src = str(root / "blob.bin")
    assert gutils.check_sha1(src, sha) is res["sha_ok"] is True
    assert gutils.check_sha1(src, "0" * 40) is res["sha_bad"] is False
    got = []
    for u in (src, "file://" + src, url + "/blob.bin"):
        p = gutils.download(u, path=str(tmp_path / f"f{len(got)}.bin"),
                            sha1_hash=sha)
        got.append(Path(p).read_bytes() == Path(src).read_bytes())
    assert got == res["downloads"] == [True, True, True]
    into = gutils.download(url + "/blob.bin", path=str(tmp_path))
    assert os.path.basename(into) == res["into_dir"] == "blob.bin"
    with pytest.raises(MXNetError, match="download failed"):
        gutils.download(url + "/missing.bin", path=str(tmp_path / "m.bin"),
                        retries=1)
    assert res["missing"] == "MXNetError"
    assert not (tmp_path / "m.bin").exists() and not res["missing_left"]
    with pytest.raises(MXNetError, match="sha1 mismatch"):
        gutils.download(src, path=str(tmp_path / "bad.bin"),
                        sha1_hash="0" * 40)
    assert res["bad_sha"] == "MXNetError"
    assert not (tmp_path / "bad.bin").exists() and not res["bad_left"]
    keep = tmp_path / "f0.bin"
    stamp = keep.stat().st_mtime_ns
    gutils.download(src, path=str(keep), sha1_hash=sha)
    assert keep.stat().st_mtime_ns == stamp
    assert not any(p.name.endswith(".part") for p in tmp_path.iterdir())

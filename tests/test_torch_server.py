"""The port's HTTP front (``incubator_mxnet_tpu_torch.serving.ModelServer``)
against the JAX package's ``ModelServer``, on the same weights and the
same requests, fp32 on the CPU at ``gpt_tiny`` width (2 layers of 64,
vocab 512, 4 slots, ``max_len`` 64, paged, the health plane on).

Compared: the sync ``:generate`` bodies (same keys; tokens exact, greedy
and seeded sampled; logprobs within 1e-5; the ``n = 2`` candidates; a
stop sequence trimmed), the SSE event sequences with their tokens and the
``done`` payload's keys, the ``X-Request-Id`` echo, a 400 with
``request_id`` on a malformed body, the key sets of ``/v1/models``
stats, ``/slo`` and ``/health`` (``decode_health`` with ``step /
logit_max / entropy_mean / finite``), the generation series on
``/metrics``, and ``/programs`` (captured == expected for both).  The
JAX server runs once per module in a child interpreter with every
``MXNET_*`` variable unset but ``MXNET_HEALTH_PLANE``; its weights
(``Normal(0.02)`` from a seed) and its HTTP answers cross through files
in ``tmp_path``.  Tokens with the health plane on equal tokens with it
off."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from incubator_mxnet_tpu_torch import telemetry
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny
from incubator_mxnet_tpu_torch.serving import (ContinuousBatcher,
                                               GenerationEngine,
                                               ModelServer)
from incubator_mxnet_tpu_torch.serving import slo as tslo

ROOT = Path(__file__).resolve().parents[1]
ENGINE = dict(max_slots=4, max_len=64)
TOL = dict(rtol=1e-5, atol=1e-5)
# (name, request id, body): sync requests first, then the SSE ones
REQUESTS = [
    ("greedy", "req-greedy", {"tokens": [3, 7, 11, 2],
                              "max_new_tokens": 12}),
    ("sampled", "req-sampled", {"tokens": [5, 300, 9], "max_new_tokens": 10,
                                "temperature": 0.9, "top_k": 40, "seed": 7,
                                "logprobs": 3}),
    ("n2", "req-n2", {"tokens": [4, 9, 16], "max_new_tokens": 8,
                      "temperature": 0.9, "seed": 99, "n": 2}),
    ("plain_for_stop", "req-ps", {"tokens": [8, 120, 33],
                                  "max_new_tokens": 16, "temperature": 0.8,
                                  "seed": 11}),
    ("sse_greedy", "req-sse", {"tokens": [1, 2, 3], "max_new_tokens": 9,
                               "stream": True}),
    ("sse_sampled", "req-sse2", {"tokens": [6, 6, 6, 6, 6],
                                 "max_new_tokens": 7, "temperature": 0.7,
                                 "seed": 3, "logprobs": 2,
                                 "stream": True}),
]
GETS = ["/v1/models", "/slo", "/health", "/metrics", "/programs",
        "/readyz", "/healthz"]
# the generation series of /metrics (router and supervisor series are not
# ported yet)
SERIES = ("mxtpu_generate", "mxtpu_serve", "mxtpu_dispatches_per_token",
          "mxtpu_decode", "mxtpu_kv", "mxtpu_spec", "mxtpu_sample",
          "mxtpu_slo", "mxtpu_health", "mxtpu_prefix")

# the HTTP client both sides run: sync bodies, SSE frames, headers
_CLIENT = r'''
import json, urllib.error, urllib.request


def post(port, name, rid, body, raw=None):
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/gpt:generate", data=data,
        headers={"Content-Type": "application/json",
                 "x-request-id": rid})
    try:
        resp = urllib.request.urlopen(req, timeout=120)
    except urllib.error.HTTPError as e:
        return {"name": name, "status": e.code,
                "request_id": e.headers.get("X-Request-Id"),
                "body": json.loads(e.read().decode())}
    out = {"name": name, "status": resp.status,
           "request_id": resp.headers.get("X-Request-Id"),
           "ctype": resp.headers.get("Content-Type")}
    text = resp.read().decode()
    if out["ctype"].startswith("text/event-stream"):
        frames = []
        for block in text.strip().split("\n\n"):
            ev, data = None, None
            for line in block.splitlines():
                if line.startswith("event: "):
                    ev = line[len("event: "):]
                elif line.startswith("data: "):
                    data = json.loads(line[len("data: "):])
            frames.append([ev, data])
        out["frames"] = frames
    else:
        out["body"] = json.loads(text)
    return out


def get(port, path):
    try:
        resp = urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                      timeout=60)
        status, text = resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        status, text = e.code, e.read().decode()
    if path == "/metrics":
        return {"status": status, "series": sorted(
            line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE "))}
    return {"status": status, "body": json.loads(text)}


def stop_of(tokens):
    """The first 2-token window from index 3 on that did not occur
    before: a stop sequence the seeded run meets first there."""
    for i in range(3, len(tokens) - 1):
        w = tokens[i:i + 2]
        if all(tokens[j:j + 2] != w for j in range(i)):
            return w
    raise AssertionError(tokens)


def drive(port, requests, gets):
    out = {}
    for name, rid, body in requests:
        out[name] = post(port, name, rid, body)
    base = out["plain_for_stop"]["body"]["tokens"]
    body = dict(requests[3][2], stop=[stop_of(base)])
    out["stopped"] = post(port, "stopped", "req-stop", body)
    out["bad"] = post(port, "bad", "bad-1", None, raw=b"{not json")
    out["gets"] = {p: get(port, p) for p in gets}
    return out
'''

_CHILD = r'''
import jax
jax.config.update("jax_platforms", "cpu")
import json, sys
import numpy as np
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.models.gpt import gpt_tiny
from incubator_mxnet_tpu.serving import GenerationEngine, ModelServer
params_path, out_path, requests, gets, engine_kw = sys.argv[1:6]
exec(sys.argv[6])
mx.random.seed(0)
net = gpt_tiny(dropout=0.0)
net.initialize(init=mx.init.Normal(0.02))
net(mx.nd.array(np.zeros((1, 2), np.int32)))
np.savez(params_path, **{k[len(net.prefix):]: v.data().asnumpy()
                         for k, v in net.collect_params().items()})
srv = ModelServer(port=0, host="127.0.0.1")
srv.add_model("gpt", GenerationEngine(net, name="gpt", **eval(engine_kw)),
              warmup=True)
srv.start()
try:
    out = drive(srv.port, eval(requests), eval(gets))
finally:
    srv.stop()
with open(out_path, "w") as f:
    json.dump(out, f)
'''

_ns = {}
exec(_CLIENT, _ns)
drive = _ns["drive"]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX server's answers, and the weights behind them."""
    d = tmp_path_factory.mktemp("server_ref")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env.update(JAX_PLATFORMS="cpu", MXNET_HEALTH_PLANE="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [x for x in [os.environ.get("PYTHONPATH")]
                                  if x]))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(d / "params.npz"),
         str(d / "answers.json"), repr(REQUESTS), repr(GETS), repr(ENGINE),
         _CLIENT], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(d / "params.npz") as z:
        params = dict(z)
    with open(d / "answers.json") as f:
        return params, json.load(f)


def _net(params):
    return load_jax_params(gpt_tiny(dropout=0.0, device="cpu"), params)


@pytest.fixture(scope="module")
def port_answers(ref):
    """The port server's answers to the same requests (health plane on,
    fresh SLO windows and metrics)."""
    params, _ = ref
    mp = pytest.MonkeyPatch()
    mp.setenv("MXNET_HEALTH_PLANE", "1")
    telemetry.reset()
    tslo.tracker.reset()
    try:
        eng = GenerationEngine(_net(params), name="gpt", **ENGINE)
        srv = ModelServer(port=0, host="127.0.0.1")
        srv.add_model("gpt", eng, warmup=True)
        srv.start()
        try:
            return drive(srv.port, REQUESTS, GETS)
        finally:
            srv.stop()
    finally:
        mp.undo()


def _close_lp(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["token_ids"] == w["token_ids"]
        np.testing.assert_allclose(g["logprobs"], w["logprobs"], **TOL)


@pytest.mark.parametrize("name", ["greedy", "sampled", "n2",
                                  "plain_for_stop", "stopped"])
def test_sync_generate_bodies_equal_jax(ref, port_answers, name):
    want, got = ref[1][name], port_answers[name]
    assert got["status"] == want["status"] == 200
    assert got["request_id"] == want["request_id"]
    g, w = got["body"], want["body"]
    assert sorted(g) == sorted(w)
    for k in ("tokens", "count", "accepted_tokens", "draft_tokens",
              "request_id", "seed"):
        assert g.get(k) == w.get(k), k
    if "logprobs" in w:
        _close_lp(g["logprobs"], w["logprobs"])
    if "candidates" in w:
        assert len(g["candidates"]) == len(w["candidates"]) == 2
        for gc, wc in zip(g["candidates"], w["candidates"]):
            assert gc == wc
        assert g["candidates"][0]["tokens"] != g["candidates"][1]["tokens"]
    if name == "stopped":
        base = port_answers["plain_for_stop"]["body"]["tokens"]
        assert len(g["tokens"]) < len(base)
        assert g["tokens"] == base[:len(g["tokens"])]


@pytest.mark.parametrize("name", ["sse_greedy", "sse_sampled"])
def test_sse_streams_equal_jax(ref, port_answers, name):
    want, got = ref[1][name], port_answers[name]
    assert got["status"] == want["status"] == 200
    assert got["ctype"] == want["ctype"] == "text/event-stream"
    assert got["request_id"] == want["request_id"]
    assert [ev for ev, _ in got["frames"]] \
        == [ev for ev, _ in want["frames"]]
    assert want["frames"][-1][0] == "done"
    for (_, g), (_, w) in zip(got["frames"][:-1], want["frames"][:-1]):
        assert sorted(g) == sorted(w)
        assert (g["token"], g["index"]) == (w["token"], w["index"])
        if "logprobs" in w:
            _close_lp([g["logprobs"]], [w["logprobs"]])
    g, w = got["frames"][-1][1], want["frames"][-1][1]
    assert sorted(g) == sorted(w)
    assert g["tokens"] == w["tokens"] and g["request_id"] == w["request_id"]


def test_malformed_body_is_400_with_request_id(ref, port_answers):
    want, got = ref[1]["bad"], port_answers["bad"]
    assert got["status"] == want["status"] == 400
    assert got["request_id"] == want["request_id"] == "bad-1"
    assert sorted(got["body"]) == sorted(want["body"])
    assert got["body"]["request_id"] == "bad-1"


def _keys(d):
    return sorted(d) if isinstance(d, dict) else d


def test_models_slo_health_key_sets_equal_jax(ref, port_answers):
    want, got = ref[1]["gets"], port_answers["gets"]
    w = want["/v1/models"]["body"]["models"]["gpt"]
    g = got["/v1/models"]["body"]["models"]["gpt"]
    assert _keys(g) == _keys(w)
    assert g["slots_in_use"] == 0 and g["kind"] == "generation"
    assert _keys(g["decode_health"]) == _keys(w["decode_health"]) \
        == ["entropy_mean", "finite", "logit_max", "step"]
    w, g = want["/slo"]["body"], got["/slo"]["body"]
    assert _keys(g) == _keys(w)
    assert _keys(g["objectives"]) == _keys(w["objectives"])
    assert _keys(g["models"]["gpt"]) == _keys(w["models"]["gpt"])
    w, g = want["/health"]["body"], got["/health"]["body"]
    assert _keys(g) == _keys(w)
    assert _keys(g["models"]["gpt"]) == _keys(w["models"]["gpt"])
    assert _keys(g["models"]["gpt"]["decode_health"]) \
        == ["entropy_mean", "finite", "logit_max", "step"]
    assert g["enabled"] is w["enabled"] is True
    for path in ("/readyz", "/healthz"):
        assert got[path]["status"] == want[path]["status"] == 200
        assert got[path]["body"] == want[path]["body"]


def test_metrics_series_and_programs_equal_jax(ref, port_answers):
    want, got = ref[1]["gets"], port_answers["gets"]

    def gen(series):
        return sorted(s for s in series if s.startswith(SERIES))
    assert gen(got["/metrics"]["series"]) == gen(want["/metrics"]["series"])
    assert "mxtpu_generate_tokens" in got["/metrics"]["series"]
    for side in (want, got):
        eng = side["/programs"]["body"]["engines"]["gpt"]
        assert eng["compiled_programs"] == eng["expected_programs"] == 10
    sites = [sorted(s for s in side["/programs"]["body"]["sites"]
                    if s.startswith("serving:gpt:"))
             for side in (want, got)]
    assert sites[0] == sites[1]


def test_health_plane_does_not_change_tokens(ref, monkeypatch):
    """The same requests through a batcher with the plane on and off:
    the same tokens, and decode_health only with the plane on."""
    params, _ = ref
    net = _net(params)
    from incubator_mxnet_tpu_torch.serving import SamplingParams
    reqs = [([3, 7, 11, 2], 12, None),
            ([5, 300, 9], 10, SamplingParams(temperature=0.9, top_k=40,
                                             seed=7))]
    outs = {}
    for plane in ("0", "1"):
        monkeypatch.setenv("MXNET_HEALTH_PLANE", plane)
        bat = ContinuousBatcher(GenerationEngine(net, name="h", **ENGINE))
        try:
            hs = [bat.submit_async(p, n, sampling=sp) for p, n, sp in reqs]
            outs[plane] = [h.result(60) for h in hs]
            assert ("decode_health" in bat.stats()) == (plane == "1")
        finally:
            bat.close()
    assert outs["0"] == outs["1"]
    assert outs["1"][0] == ref[1]["greedy"]["body"]["tokens"]

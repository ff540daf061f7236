"""Console entry point of the port: ``mxtpu-serve-torch`` (counterpart of
``incubator_mxnet_tpu/_cli.py``'s ``serve_main``, generation models
only)."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

_PROG = "mxtpu-serve-torch"


def _load_generation_engine(name, cfg_path, device, max_slots=None,
                            max_len=None, paged=None, block_size=None,
                            scan_steps=None):
    """Build a :class:`~.serving.GenerationEngine` on ``device`` from a
    ``--gen-model`` JSON config: architecture kwargs of
    :class:`~.models.gpt.GPTModel` (``vocab_size``, ``units``,
    ``hidden_size``, ``num_layers``, ``num_heads``, ``max_length``) and
    the optional engine knobs ``max_slots``, ``max_len``, ``paged``,
    ``block_size``, ``scan_steps``, ``logprobs_topn`` and — for a draft —
    ``spec_k``.

    The weights are ``Normal(0.02)`` drawn by the port's initializer from
    seed 0, exactly as ``chip_smoke.py``'s ``build_served`` draws them
    (so a 6-layer config of the same width holds the first 6 cells of the
    12-layer model's draw).  A config with ``"params"`` raises
    :class:`MXNetError`: reading the reference's parameter files is not
    ported yet (ROADMAP Queue A items 7-8), and a server must not quietly
    serve random weights in place of a checkpoint."""
    from .base import MXNetError
    from . import initializer as init
    from .models.gpt import GPTModel
    from .serving import GenerationEngine

    with open(cfg_path) as f:
        cfg = dict(json.load(f))
    if "vocab_size" not in cfg:
        raise MXNetError(f"{cfg_path}: a generation config needs at least "
                         '{"vocab_size": N}')
    if "params" in cfg:
        raise MXNetError(
            f"{cfg_path}: \"params\" weights files cannot be read by the "
            "PyTorch port yet (ROADMAP Queue A items 7-8); refusing to "
            "serve random weights in their place")
    cfg_slots = cfg.pop("max_slots", None)
    cfg_len = cfg.pop("max_len", None)
    cfg_paged = cfg.pop("paged", None)
    cfg_bs = cfg.pop("block_size", None)
    cfg_spec_k = cfg.pop("spec_k", None)        # draft configs only
    cfg_scan = cfg.pop("scan_steps", None)
    cfg_lp = cfg.pop("logprobs_topn", None)
    max_slots = cfg_slots if max_slots is None else max_slots
    max_len = cfg_len if max_len is None else max_len
    paged = cfg_paged if paged is None else paged
    block_size = cfg_bs if block_size is None else block_size
    scan_steps = cfg_scan if scan_steps is None else scan_steps
    cfg.setdefault("dropout", 0.0)              # serving never trains
    net = GPTModel(device=device, **cfg)
    net.initialize(init.Normal(0.02), seed=0)
    engine = GenerationEngine(net, name=name, max_slots=max_slots,
                              max_len=max_len, paged=paged,
                              block_size=block_size, scan_steps=scan_steps,
                              logprobs_topn=cfg_lp)
    return engine, cfg_spec_k


def _parser():
    ap = argparse.ArgumentParser(
        prog=_PROG,
        description="serve GPT generation models over HTTP with "
                    "continuous batching (the PyTorch port, on a CUDA "
                    "card unless --device cpu)")
    ap.add_argument("--gen-model", action="append", default=[],
                    metavar="NAME=CONFIG.json", required=True,
                    help="register a generation model from a JSON config "
                         "(architecture kwargs and engine knobs); "
                         "repeatable")
    ap.add_argument("--gen-draft", action="append", default=[],
                    metavar="NAME=CONFIG.json",
                    help="attach a draft model to generation model NAME "
                         "for speculative decoding (k from the config's "
                         "'spec_k' or MXNET_SPEC_K, default 4); "
                         "repeatable")
    ap.add_argument("--gen-slots", type=int, default=None,
                    help="KV-cache slots per model (default config or "
                         "MXNET_GEN_MAX_SLOTS or 8)")
    ap.add_argument("--gen-max-len", type=int, default=None,
                    help="KV-cache sequence capacity (default config or "
                         "MXNET_GEN_MAX_LEN or the model's max_length)")
    ap.add_argument("--gen-paged", type=int, choices=(0, 1), default=None,
                    help="paged KV cache: 1 on (default), 0 dense (also "
                         "MXNET_KV_PAGED)")
    ap.add_argument("--gen-block-size", type=int, default=None,
                    help="tokens per paged KV block (default "
                         "MXNET_KV_BLOCK_SIZE or 16)")
    ap.add_argument("--gen-scan-steps", type=int, default=None,
                    help="decode steps per burst program, 0 disables it "
                         "(default config or MXNET_DECODE_SCAN_STEPS or 8)")
    ap.add_argument("--port", type=int, default=None,
                    help="HTTP port (default MXNET_SERVE_PORT or 8080; 0 "
                         "picks an ephemeral port)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--queue", type=int, default=None,
                    help="bounded queue size before backpressure "
                         "(default MXNET_SERVE_QUEUE or 128)")
    ap.add_argument("--warmup", action="store_true",
                    help="capture every model's programs before the "
                         "model takes traffic, one model after another "
                         "while the port is not yet bound (without it the "
                         "capture runs in the background and /readyz "
                         "answers 503 until it is done: the port has no "
                         "lazy compile path)")
    ap.add_argument("--preload", action="store_true",
                    help="capture every model's whole program set before "
                         "binding the port")
    ap.add_argument("--device", default="cuda:0",
                    help="where the models run (default cuda:0; 'cpu' "
                         "runs the kernels' plain versions)")
    return ap


def serve_main(argv=None):
    """``mxtpu-serve-torch`` — serve GPT generation models::

        mxtpu-serve-torch --gen-model gpt=/models/gpt2.json \\
                          [--gen-draft gpt=/models/gpt2-6l.json] \\
                          [--port N] [--host H] [--queue N] [--warmup]
                          [--preload] [--gen-slots N] [--gen-max-len N]
                          [--gen-paged 0|1] [--gen-block-size N]
                          [--gen-scan-steps N] [--device cuda:0|cpu]

    Each ``--gen-model NAME=CONFIG.json`` serves ``/v1/models/NAME:
    generate`` behind continuous batching (see
    :func:`_load_generation_engine` for the config and the weights);
    ``--gen-draft NAME=CONFIG.json`` attaches a draft for speculative
    decoding, with the target's slot and sequence geometry.  Serves the
    routes of :class:`~.serving.ModelServer` until SIGTERM/SIGINT, then
    drains: ``/readyz`` answers 503, in-flight requests finish (within
    ``MXNET_DRAIN_SECONDS``), the port closes, exit code 0.  Without a
    CUDA card and without ``--device cpu`` it exits non-zero with the
    :class:`MXNetError` that says so."""
    ns = _parser().parse_args(argv)
    from .base import MXNetError
    try:
        srv = _build_server(ns)
    except MXNetError as e:
        sys.stderr.write(f"{_PROG}: MXNetError: {e}\n")
        sys.exit(1)
    from .serving import lifecycle
    sys.exit(lifecycle.run_until_shutdown(srv))


def _build_server(ns):
    """Load every model of ``ns`` onto its device, register it, warm it
    as ``ns`` asks, and start the HTTP front."""
    from .base import MXNetError
    from .context import resolve_device
    from .serving import ModelServer

    device = resolve_device(ns.device)
    drafts = {}
    for spec in ns.gen_draft:
        name, _, cfg_path = spec.partition("=")
        if not name or not cfg_path:
            raise MXNetError(f"--gen-draft wants NAME=CONFIG.json, got "
                             f"{spec!r}")
        drafts[name] = cfg_path
    models = []
    for spec in ns.gen_model:
        name, _, cfg_path = spec.partition("=")
        if not name or not cfg_path:
            raise MXNetError(f"--gen-model wants NAME=CONFIG.json, got "
                             f"{spec!r}")
        models.append((name, cfg_path))
    missing = sorted(set(drafts) - {n for n, _ in models})
    if missing:
        raise MXNetError(f"--gen-draft {missing}: no matching --gen-model")
    batcher_kw = {} if ns.queue is None else {"queue_size": ns.queue}
    srv = ModelServer(port=ns.port, host=ns.host, **batcher_kw)
    for name, cfg_path in models:
        engine, _ = _load_generation_engine(
            name, cfg_path, device, max_slots=ns.gen_slots,
            max_len=ns.gen_max_len,
            paged=None if ns.gen_paged is None else bool(ns.gen_paged),
            block_size=ns.gen_block_size, scan_steps=ns.gen_scan_steps)
        if name in drafts:
            # the draft mirrors the target's slot and sequence geometry,
            # so its cache rolls back in lock-step with the target's
            draft, spec_k = _load_generation_engine(
                name + "-draft", drafts[name], device,
                max_slots=engine.max_slots, max_len=engine.max_len,
                paged=engine.paged,
                block_size=engine.block_size if engine.paged else None)
            engine.attach_draft(draft, spec_k=spec_k)
            sys.stderr.write(f"{_PROG}: attached draft to {name} from "
                             f"{drafts[name]} (spec_k {engine.spec_k})\n")
        srv.add_model(name, engine, warmup=True,
                      async_warmup=not (ns.warmup or ns.preload))
        kv = (f"paged blocks={engine.num_blocks - 1}x{engine.block_size}"
              if engine.paged else "dense")
        sys.stderr.write(
            f"{_PROG}: loaded generation model {name} from {cfg_path} on "
            f"{device} (slots {engine.max_slots}, max_len "
            f"{engine.max_len}, kv {kv}, prefill buckets "
            f"{list(engine.prefill_buckets)})\n")
    if ns.preload:
        t0 = time.time()
        srv.preload()
        sys.stderr.write(f"{_PROG}: preload done in "
                         f"{time.time() - t0:.1f}s\n")
    srv.start()
    sys.stderr.write(f"{_PROG}: listening on http://{ns.host}:{srv.port} "
                     f"(pid {os.getpid()}; /v1/models, /healthz, /readyz, "
                     "/metrics)\n")
    sys.stderr.flush()
    return srv


if __name__ == "__main__":
    serve_main()

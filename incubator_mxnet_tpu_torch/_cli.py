"""Console entry points of the port (counterparts of
``incubator_mxnet_tpu/_cli.py``'s):

* ``mxtpu-serve-torch`` (:func:`serve_main`) — one replica serving
  generation models;
* ``mxtpu-router-torch`` (:func:`router_main`) — the front tier over
  replicas;
* ``mxtpu-supervise-torch`` (:func:`supervise_main`) — replicas
  supervised behind an embedded router;
* ``mxtpu-stats-torch`` (:func:`stats_main`) — a script run under
  telemetry, or a running server's or fleet's views."""
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

    A config's ``"params"`` names a weights file in the reference's
    ``save_parameters`` format (either package writes it; resolved
    relative to the config), loaded with ``load_parameters``; a missing
    file raises :class:`MXNetError` rather than serving random weights
    in its place.  Without ``"params"`` the weights are ``Normal(0.02)``
    drawn by the port's initializer from seed 0, exactly as
    ``chip_smoke.py``'s ``build_served`` draws them (so a 6-layer config
    of the same width holds the first 6 cells of the 12-layer model's
    draw)."""
    from .base import MXNetError
    from . import initializer as init
    from .models.gpt import GPTModel
    from .serving import GenerationEngine

    with open(cfg_path) as f:
        cfg = dict(json.load(f))
    if "vocab_size" not in cfg:
        raise MXNetError(f"{cfg_path}: a generation config needs at least "
                         '{"vocab_size": N}')
    params = cfg.pop("params", None)
    if params is not None:
        params = os.path.join(os.path.dirname(os.path.abspath(cfg_path)),
                              params)
        if not os.path.isfile(params):
            raise MXNetError(f"{cfg_path}: the params file {params} does "
                             "not exist; refusing to serve random weights "
                             "in its place")
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
    if params is None:
        net.initialize(init.Normal(0.02), seed=0)
    else:
        net.load_parameters(params)
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


def stats_main(argv=None):
    """``mxtpu-stats-torch`` — run a script under the port's telemetry and
    print the metrics afterwards, or read a running server or fleet::

        mxtpu-stats-torch [--format prometheus|json] [--out PATH]
                          [--serve [--port N]] [--slo]
                          [--flight-dump PATH] script.py [args...]
        mxtpu-stats-torch --fleet URL [--slo] [--out PATH]
        mxtpu-stats-torch --fleet URL --memory | --programs | --health |
                          --profile SECS

    With ``--fleet`` no script runs: URL is a ``mxtpu-router-torch`` (or
    one ``mxtpu-serve-torch`` replica) and the command prints its
    ``/metrics`` (federated over the fleet behind a router), its merged
    ``/slo`` (``--slo``), ``/memory``, ``/programs``, ``/health``, or
    triggers a profile capture (``POST /debug/profile``, fanned out to
    every replica behind a router) and prints the artifact paths
    (``--profile SECONDS``).

    Otherwise the script runs in this process as ``__main__`` with the
    telemetry collector started; the dump goes to ``--out`` (or stdout)
    when it finishes, also when it raises.  ``--serve`` runs the live
    exporter (``/metrics``, ``/metrics.json``, ``/healthz``, ``/trace``,
    ``/slo``, ``/flight``) on ``--port`` (default 9100) meanwhile."""
    ap = argparse.ArgumentParser(
        prog="mxtpu-stats-torch",
        description="run a python script with the port's telemetry "
                    "collection and print the metrics dump, or read a "
                    "running server's or fleet's views")
    ap.add_argument("--format", choices=("prometheus", "json"),
                    default="prometheus")
    ap.add_argument("--out", default=None,
                    help="write the dump here instead of stdout")
    ap.add_argument("--serve", action="store_true",
                    help="serve live /metrics, /healthz and /trace over "
                         "HTTP while the script runs")
    ap.add_argument("--port", type=int, default=9100,
                    help="HTTP exporter port for --serve (default 9100; "
                         "0 picks an ephemeral port)")
    ap.add_argument("--slo", action="store_true",
                    help="also print the per-model SLO state after the "
                         "script (with --fleet: the merged /slo)")
    ap.add_argument("--flight-dump", metavar="PATH", default=None,
                    help="write a flight-recorder postmortem JSON to PATH "
                         "after the script")
    ap.add_argument("--fleet", metavar="URL", default=None,
                    help="read a running mxtpu-router-torch (or replica) "
                         "at URL instead of running a script")
    ap.add_argument("--memory", action="store_true",
                    help="with --fleet: GET /memory (per-owner device "
                         "bytes)")
    ap.add_argument("--programs", action="store_true",
                    help="with --fleet: GET /programs (dispatch ledger, "
                         "expected against captured programs)")
    ap.add_argument("--health", action="store_true",
                    help="with --fleet: GET /health (health-plane report; "
                         "worst-replica rollup behind a router)")
    ap.add_argument("--profile", metavar="SECONDS", type=float,
                    default=None,
                    help="with --fleet: POST /debug/profile?seconds= and "
                         "print the artifact paths")
    ap.add_argument("script", nargs="?", default=None,
                    help="python script to run")
    ap.add_argument("args", nargs=argparse.REMAINDER,
                    help="arguments passed to the script")
    ns = ap.parse_args(argv)

    if ns.fleet:
        sys.exit(_fleet_stats(ns))
    if ns.memory or ns.programs or ns.health or ns.profile is not None:
        ap.error("--memory/--programs/--health/--profile need --fleet "
                 "URL (they query a running server)")
    if ns.script is None:
        ap.error("a script is required unless --fleet URL is given")

    from . import telemetry
    telemetry.start()
    if ns.serve:
        from . import telemetry_http
        srv = telemetry_http.start_server(ns.port)
        sys.stderr.write(
            f"mxtpu-stats-torch: serving /metrics /healthz /trace on "
            f"http://0.0.0.0:{srv.server_address[1]}\n")

    import runpy
    sys.argv = [ns.script] + ns.args
    status = 0
    try:
        runpy.run_path(ns.script, run_name="__main__")
    except SystemExit as e:
        status = e.code if isinstance(e.code, int) else (
            0 if e.code is None else 1)
    except BaseException:
        import traceback
        traceback.print_exc()
        status = 1

    if ns.format == "prometheus":
        text = telemetry.render_prometheus()
    else:
        text = json.dumps(telemetry.snapshot(), indent=2, default=str) + "\n"
    if ns.out:
        with open(ns.out, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    if ns.slo:
        from . import telemetry_http
        sys.stdout.write(json.dumps(telemetry_http.slo_body(), indent=2,
                                    default=str) + "\n")
    if ns.flight_dump:
        from . import telemetry_ring
        path = telemetry_ring.recorder.dump("cli", path=ns.flight_dump)
        sys.stderr.write(f"mxtpu-stats-torch: flight dump -> {path}\n")
    sys.exit(status)


def _fleet_stats(ns) -> int:
    """``mxtpu-stats-torch --fleet URL``: print the server's or router's
    ``/metrics`` (``--slo``/``--memory``/``--programs``/``--health`` pick
    the JSON views; ``--profile SECONDS`` triggers a capture).  Returns
    the exit code: 1 when the server cannot be read or answers an
    error."""
    from urllib.error import HTTPError, URLError
    from urllib.request import Request, urlopen

    base = ns.fleet.rstrip("/")
    if "://" not in base:
        base = "http://" + base
    timeout = 10.0
    req = None
    if ns.profile is not None:
        # the capture blocks server-side for the window plus profiler
        # start-up and the trace's export; the router's fan-out waits as
        # long for each replica, and answers a little after
        from .serving.router import profile_timeout
        path = f"/debug/profile?seconds={ns.profile}"
        timeout = profile_timeout(ns.profile) + 10.0
        req = Request(base + path, data=b"{}", method="POST",
                      headers={"Content-Type": "application/json"})
    elif ns.memory:
        path = "/memory"
    elif ns.programs:
        path = "/programs"
    elif ns.health:
        path = "/health"
    elif ns.slo:
        path = "/slo"
    else:
        path = "/metrics"
    try:
        with urlopen(req or (base + path), timeout=timeout) as resp:
            text = resp.read().decode("utf-8", "replace")
    except HTTPError as e:
        sys.stderr.write(f"mxtpu-stats-torch: --fleet {base}{path}: HTTP "
                         f"{e.code}: "
                         f"{e.read().decode('utf-8', 'replace')}\n")
        return 1
    except (URLError, OSError) as e:
        sys.stderr.write(f"mxtpu-stats-torch: --fleet {base}{path}: {e}\n")
        return 1
    if not text.endswith("\n"):
        text += "\n"
    if ns.out:
        with open(ns.out, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0


#: why ``mxtpu-supervise-torch --compile-cache`` is refused
_NO_COMPILE_CACHE = (
    "--compile-cache is refused: the PyTorch port has no XLA compile "
    "cache. Its CUDA kernels are built once per checkout into "
    "build/kernels/ (keyed by a hash of their sources) and every replica "
    "of the checkout shares them; its CUDA graphs are captured in each "
    "replica's own process and cannot be cached")


def supervise_main(argv=None):
    """``mxtpu-supervise-torch`` — a self-healing fleet: supervise
    ``mxtpu-serve-torch`` replica processes behind an embedded router,
    with crash and hang detection, restart with backoff, flap quarantine
    and signal-driven autoscaling::

        mxtpu-supervise-torch --replicas 2 --min-replicas 1 \\
                              --max-replicas 4 [--router-port N]
                              [--log-dir DIR] [--no-autoscale]
                              [--autoscale-interval F]
                              -- --gen-model g=/models/gpt.json

    Everything after ``--`` is passed to each replica's
    ``mxtpu-serve-torch`` (``--device`` included; not ``--port`` or
    ``--host``: the supervisor gives each slot a port on 127.0.0.1).
    ``--command`` replaces the replica command with a shell-split
    template whose ``{port}`` receives the slot's port.
    ``--compile-cache`` is refused (see ``_NO_COMPILE_CACHE``).  Knobs
    default from ``MXNET_SUPERVISE_*`` / ``MXNET_AUTOSCALE_*``.  SIGTERM
    or SIGINT drains the router and stops every replica; exit code 0."""
    import shlex

    argv = list(sys.argv[1:] if argv is None else argv)
    serve_args: list = []
    if "--" in argv:
        split = argv.index("--")
        argv, serve_args = argv[:split], argv[split + 1:]

    ap = argparse.ArgumentParser(
        prog="mxtpu-supervise-torch",
        description="supervise and autoscale a fleet of mxtpu-serve-torch "
                    "replicas behind an embedded router")
    ap.add_argument("--replicas", type=int, default=1,
                    help="initial fleet size (default 1; raised to "
                         "--min-replicas if smaller)")
    ap.add_argument("--min-replicas", type=int, default=None,
                    help="autoscale floor (default "
                         "MXNET_AUTOSCALE_MIN_REPLICAS or 1)")
    ap.add_argument("--max-replicas", type=int, default=None,
                    help="autoscale ceiling (default "
                         "MXNET_AUTOSCALE_MAX_REPLICAS or 4)")
    ap.add_argument("--router-port", type=int, default=0,
                    help="router listen port (default 0: ephemeral)")
    ap.add_argument("--compile-cache", metavar="DIR", default=None,
                    help="refused by the PyTorch port: kernels build once "
                         "per checkout and CUDA graphs are per process")
    ap.add_argument("--log-dir", metavar="DIR", default=None,
                    help="per-replica stdout/stderr logs land here "
                         "(default: discarded)")
    ap.add_argument("--no-autoscale", action="store_true",
                    help="supervise a fixed-size fleet (restarts and "
                         "quarantine only)")
    ap.add_argument("--autoscale-interval", type=float, default=None,
                    help="seconds between policy evaluations (default "
                         "MXNET_AUTOSCALE_INTERVAL_SECONDS or 10)")
    ap.add_argument("--command", default=None,
                    help="replica command template with a {port} "
                         "placeholder (shell-split; replaces the default "
                         "mxtpu-serve-torch invocation)")
    ns = ap.parse_args(argv)
    if ns.compile_cache is not None:
        ap.error(_NO_COMPILE_CACHE)
    if ns.command is not None and serve_args:
        ap.error("--command and '-- <mxtpu-serve-torch args>' are "
                 "exclusive")
    if ns.command is None and not serve_args:
        ap.error("replica command missing: pass '-- <mxtpu-serve-torch "
                 "args>' or --command 'prog --port {port}'")

    from .base import MXNetError
    from .serving import AutoscalePolicy, Supervisor, lifecycle

    if ns.command is not None:
        command = shlex.split(ns.command)
    else:
        # re-enter this interpreter's serve_main, so the fleet runs from
        # a source checkout without installed console scripts
        command = [sys.executable, "-c",
                   "from incubator_mxnet_tpu_torch._cli import serve_main; "
                   "serve_main()"] + serve_args \
            + ["--host", "127.0.0.1", "--port", "{port}"]
    try:
        policy = AutoscalePolicy(min_replicas=ns.min_replicas,
                                 max_replicas=ns.max_replicas)
        sup = Supervisor(command, replicas=ns.replicas, policy=policy,
                         autoscale=not ns.no_autoscale,
                         router_port=ns.router_port, log_dir=ns.log_dir,
                         autoscale_interval_seconds=ns.autoscale_interval)
        sup.start()
    except MXNetError as e:
        sys.stderr.write(f"mxtpu-supervise-torch: MXNetError: {e}\n")
        sys.exit(1)
    sys.stderr.write(
        f"mxtpu-supervise-torch: router on http://0.0.0.0:"
        f"{sup.router.port} over {sup.alive_count()} replica(s) (pid "
        f"{os.getpid()}); autoscale "
        f"{'off' if ns.no_autoscale else 'on'} "
        f"[{policy.min_replicas}, {policy.max_replicas}]\n")
    sys.stderr.flush()
    sys.exit(lifecycle.run_until_shutdown(sup))


def router_main(argv=None):
    """``mxtpu-router-torch`` — the fault-tolerant front tier over a fleet
    of ``mxtpu-serve-torch`` (or ``mxtpu-serve``) replicas::

        mxtpu-router-torch --replica 127.0.0.1:8080 \\
                           --replica 127.0.0.1:8081 [--port N]
                           [--retries N] [--health-interval F]
                           [--no-affinity] [--spill-margin N]
                           [--upstream-timeout F]

    Spreads ``POST /v1/models/<name>:generate`` (and any other verb) over
    the replicas with health-aware balancing, breaker ejection, retry
    with failover (honouring ``Retry-After``), SSE passthrough,
    prefix-affine routing, drains and federated views
    (:class:`~.serving.Router`).  Knobs default from
    ``MXNET_ROUTER_*``.  SIGTERM drains it; exit code 0."""
    ap = argparse.ArgumentParser(
        prog="mxtpu-router-torch",
        description="route :generate over mxtpu-serve-torch replicas with "
                    "failover, drains and prefix-affine balancing")
    ap.add_argument("--replica", action="append", default=[],
                    metavar="HOST:PORT",
                    help="a replica (repeatable; also accepts a "
                         "comma-separated list)")
    ap.add_argument("--port", type=int, default=None,
                    help="listen port (default MXNET_ROUTER_PORT or "
                         "8081; 0 picks an ephemeral port)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--retries", type=int, default=None,
                    help="upstream attempts beyond the first per request "
                         "(default MXNET_ROUTER_RETRIES or 2)")
    ap.add_argument("--health-interval", type=float, default=None,
                    help="seconds between /readyz and /slo polls (default "
                         "MXNET_ROUTER_HEALTH_INTERVAL_SECONDS or 0.5)")
    ap.add_argument("--no-affinity", action="store_true",
                    help="disable prefix-affine routing for :generate")
    ap.add_argument("--spill-margin", type=int, default=None,
                    help="inflight excess over the fleet minimum at which "
                         "an affinity owner spills (default "
                         "MXNET_ROUTER_SPILL_MARGIN or 8)")
    ap.add_argument("--upstream-timeout", type=float, default=None,
                    help="per-attempt upstream timeout in seconds (default "
                         "MXNET_ROUTER_UPSTREAM_TIMEOUT_SECONDS or 10)")
    ns = ap.parse_args(argv)
    replicas = [r for spec in ns.replica
                for r in spec.split(",") if r.strip()]
    if not replicas:
        ap.error("at least one --replica HOST:PORT is required")

    from .base import MXNetError
    from .serving import Router, lifecycle

    try:
        router = Router(replicas, port=ns.port, host=ns.host,
                        retries=ns.retries,
                        health_interval=ns.health_interval,
                        affinity=False if ns.no_affinity else None,
                        spill_margin=ns.spill_margin,
                        upstream_timeout=ns.upstream_timeout)
        router.start()
    except MXNetError as e:
        ap.error(str(e))
    sys.stderr.write(
        f"mxtpu-router-torch: listening on http://{ns.host}:{router.port} "
        f"over {len(router.replicas)} replica(s) "
        f"({', '.join(r.id for r in router.replicas)})\n")
    sys.stderr.flush()
    sys.exit(lifecycle.run_until_shutdown(router))


if __name__ == "__main__":
    serve_main()

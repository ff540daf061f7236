#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root, with one CUDA card visible::

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --kernels  # build and check the kernels only
    python3 chip_smoke.py --windows  # measure the serving windows only
    python3 chip_smoke.py --serve REF.json  # the HTTP phase only

Phases, each of which raises (exit code 1) on any failure:

1. device: assert CUDA, print the card's name and power limit, switch
   TF32 off so every fp32 product is a true fp32 product;
2. build: compile the CUDA kernels from ``incubator_mxnet_tpu_torch/
   kernels/csrc`` with ``nvcc`` (one process per source, in parallel) and
   print the build time and ``ptxas`` register/spill lines;
3. kernels: hold K1 flash_fwd, K2 paged_decode, K3 decode, K4 paged_verify
   and K5 verify against their plain PyTorch versions on the card at the
   serving path's shapes (12 heads of 64; K4/K5 at Q = 1, 5 and 9 query
   rows, rows running past T, and at Q = 5 with rows straddling a 64-key
   chunk edge), max abs error within ``KERNEL_TOL``; K2 == K3 and K4 == K5
   bit for bit on the same live K/V, every K4 row j against K2 at
   ``positions + j`` (within ``KERNEL_TOL``, and whether bit for bit);
   K1's logsumexp output, K6 flash_bwd_dq and K7 flash_bwd_dkv against the
   plain forward-with-lse and backward at the training path's attention
   shape (BERT-large: B = 32, 16 heads of 64, T = 128), with a ragged key
   mask at T = 512 (B = 8) and causal at a ragged T, within ``KERNEL_TOL``
   (relative where a value exceeds 1); time each kernel, its plain version
   and, where one PyTorch call computes the same function, that call (for
   K6 and K7 together the efficient-attention backward, which computes
   dq, dk and dv in one call; for K1 at the training shape the
   efficient-attention op with its logsumexp), with CUDA events, beside
   the least time the card could take (the bound; K1's, K6's and K7's for
   3xTF32 on the tensor cores). A kernel's and a library call's time is
   the card's, from a replayed CUDA graph of the calls; the eager time
   per call, host work included, is printed beside it; the plain versions
   are timed eagerly. Also print the kernel names the profiler gives
   SDPA's forward and the library backward, and K2's and K4/K5's split
   counts and scratch bytes.  K8 multi_tensor_adam (the whole-tree Adam
   update) must equal its plain version (the per-leaf loop) bit for bit
   over BERT-large's 399 leaf shapes, with every gradient stage off and
   on; it is timed against its bound (28 bytes per parameter) and
   against ``torch.optim.Adam(fused=True, capturable=True)`` over the
   same leaves;
4. path: ``gpt2_124m`` at full width with random ``Normal(0.02)`` weights
   from a seed, served by the default paged ``GenerationEngine`` behind a
   ``ContinuousBatcher``: 8 staggered requests, two sharing a 64-token
   prefix; then a dense (``paged=False``) engine on one request.  Each
   engine's warmup captures its closed program set as CUDA graphs
   ("programs:" lines: expected and captured programs, capture time,
   graph-pool bytes; every program must be captured).  The launch
   counters are zeroed just before each of the two runs and read just
   after: the paged run must launch K1 and K2 and not K3, the dense run
   K1 and K3 and not K2.  Each request must equal its solo run, a short
   request must equal the full-prefix ``net.generate`` oracle (or differ
   only where the oracle's top-2 logit gap is below ``LOGIT_GAP_TOL``),
   and a dense (``paged=False``) engine must give the same tokens.  Then,
   on the paged and the dense engine, ``GRAPH_STEPS`` scripted steps with
   sampling parameters and block tables changed between steps must give
   the same tokens bit for bit, and the same launch counts, through the
   graphs as through the bodies run eagerly ("graphs:" lines); and one
   request of each feature is served and checked: JSON mode, ``n = 2``,
   a stop sequence and logprobs ("features:" lines);
5. speculative path: the same target with a 6-layer draft of its width
   (DistilGPT-2's shape: the target's embeddings, first 6 cells and
   ``ln_f``) attached, ``spec_k`` 4, serving the same 8 requests behind a
   ``ContinuousBatcher``; then a dense target with a dense draft over its
   own net on one request.  Each run in its own launch-count window: the
   paged run must launch K1, K2 (the draft's bursts) and K4 and not K5,
   the dense run K1, K3 and K5 and not K4.  Every request must equal the
   plain path's tokens (or first differ where the plain path's top-2
   logit gap is below ``LOGIT_GAP_TOL``), and the two runs together must
   have slot-steps that accepted all ``spec_k`` draft tokens and
   slot-steps that rolled back.  Then the paged spec engine's graphs
   against its eager bodies, as in phase 4.  Then, in a child process
   (``--windows``, so that the profiler runs where no batcher thread
   has), the serving windows of a fresh plain engine and spec engine
   (burst, decode, prefill of 1024 and 64 tokens, spec step, the draft's
   burst, verify): wall, device time, host launches and idle share
   ("windows:" lines, ``profile_window``);
   then, in another child process (``--serve``, ``faulthandler`` on), the
   HTTP path ("serve:" lines): ``mxtpu-serve-torch`` started as a further
   child on a free local port, serving two ``gpt2_124m`` models from
   configs (``Normal(0.02)`` weights from seed 0, the path's weights):
   ``plain`` (paged) and ``spec`` (with a 6-layer draft, ``spec_k`` 4),
   captured in the background while ``/readyz`` answers 503; the path's 8
   requests sent by 8 concurrent SSE clients to ``plain`` (tokens equal
   the path's under the near-tie rule; time to first token and the gap
   between tokens, p50 and p99, and tokens/s, measured at the client;
   K1 and K2 must launch and K4 not, read from the server's
   ``mxtpu_kernel_launches`` before and after), then as 8 sync requests
   to ``spec`` (tokens equal the plain path's; K4 must launch); then
   ``/programs`` (every engine captured == expected), ``/memory``
   (owners ``kv:plain``, ``params:plain``), ``/metrics`` (the generation
   series), ``/v1/models`` (no slot held), a flood past ``--queue``
   (some 429s with ``Retry-After``), and SIGTERM with a stream in flight
   (``/readyz`` 503 draining, the stream finishes, exit 0 with "drained,
   exiting", the port closed);
6. training path: BERT-large (``bert_large``: 24 layers of 1024 units,
   16 heads of 64, FFN 4096, vocab 30522) at full width and depth with
   random ``Normal(0.02)`` weights from the seed, ``BERTForPretrain`` +
   ``BERTPretrainLoss`` + Adam (lr 1e-4) through ``SPMDTrainer`` on a
   ``{"data": 1}`` mesh, fp32, on one fixed batch (B = 32, T = 128) drawn
   as ``bench.py`` draws it.  The step is one CUDA graph: 3 steps through
   it (the first eager on a side stream, then captured, then replays)
   must equal 3 steps of a second trainer over a copy of the same
   weights that runs the step body eagerly, bit for bit in every loss
   and parameter.  Then 5 timed graph steps in their own launch-count
   window, which must launch K1, K6 and K7 exactly 24 times per step, K8
   once per step and no serving kernel, and one profiled step (host
   launches at most 8: the batch copies, the graph launch, the loss
   copy; idle share); every loss finite and the loss after the steps
   below the first.  Then one full-width
   ``TransformerEncoderCell`` (B = 32, T = 128, ragged valid lengths)
   must give the same input and parameter gradients through the kernels
   as through the plain attention on the card, within ``CELL_TOL`` of
   each gradient's largest value.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``."""
import argparse
import copy
import faulthandler
import importlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))

SEED = 0
KERNEL_TOL = 1e-4       # kernel vs plain, both fp32: summation order only
LOGIT_GAP_TOL = 1e-3    # a greedy near-tie the two attention paths may split
CELL_TOL = 1e-4         # cell gradients, kernels vs plain attention, relative
                        # to each gradient's largest value
LOGPROB_TOL = 1e-3      # served logprobs vs the full-prefix forward: K1/K2
                        # against cuBLAS attention, in fp32
GRAPH_STEPS = 16        # scripted steps of the graph-against-eager check
TRAIN_B, TRAIN_T = 32, 128
TRAIN_CHECK, TRAIN_STEPS = 3, 5   # graph-vs-eager steps, timed steps
BERT_HEADS, BERT_LAYERS, BERT_VOCAB = 16, 24, 30522
# NVIDIA H100 SXM data sheet: HBM3 rate, fp32 (non-tensor-core) peak and
# the dense TF32 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
HEADS, HEAD_DIM = 12, 64
# the timed decode and verify slots' positions, and a verify case whose
# rows straddle the 64-key chunk edges (60 + 0..4 crosses 63/64)
DECODE_POSITIONS = (0, 15, 16, 500, 1023, 1, 77, 256)
STRADDLE_POSITIONS = (60, 59, 61, 0, 1020, 63, 124, 200)
SOURCES = "incubator_mxnet_tpu_torch/kernels/csrc/"
CARD = None             # the card's name and power limit, set by main()
TPU_KERNELS = "incubator_mxnet_tpu/kernels/flash_attention.py:"


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes, flops, flop_per_s=FP32_FLOP_PER_S):
    """(least time in ms, what bounds it) at the card's published peaks:
    ``flops`` at ``flop_per_s`` (fp32 on the CUDA cores by default)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flop_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, arg_sets, reps):
    """Mean ms per call of ``fn`` over ``reps`` rounds of ``arg_sets``
    (distinct inputs, so the 50 MB L2 cache holds no previous call's
    data), timed with CUDA events after one warm round."""
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for a in arg_sets:
            fn(*a)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(arg_sets))


def k1_bounds(nbytes, flops):
    """The bound of K1, K6 and K7 for the arithmetic they do, 3xTF32
    (three TF32 tensor-core products per fp32 product): max(bytes / 3.35 TB/s,
    3 * FLOP / 495 TFLOP/s); and, for comparison with earlier rows, the
    fp32 CUDA-core bound max(bytes / 3.35 TB/s, FLOP / 67 TFLOP/s)."""
    return (bound_ms(nbytes, 3 * flops, TF32_FLOP_PER_S),
            bound_ms(nbytes, flops)[0])


def device_kernel_names(fn, *args):
    """The CUDA kernels one call of ``fn(*args)`` launches, by the
    profiler's names (empty if the profiler traced no device activity)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn(*args)
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def device_ms(fn, arg_sets, reps):
    """Mean ms per call of ``fn`` over ``arg_sets`` as the card runs it:
    one round of calls, after a warm round, captured in a CUDA graph and
    replayed ``reps`` times between CUDA events, so the host's work per
    call (a wrapper's checks and its ``ctypes`` call) is not timed.  A
    kernel wrapper's launches are captured as they are: a decode call's
    two launches, scratch allocation included."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in arg_sets:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for a in arg_sets:
            fn(*a)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(arg_sets))


def pct(values, q):
    """The ``q``-th percentile of ``values`` by nearest rank (the
    telemetry histograms' rule)."""
    data = sorted(values)
    return data[min(len(data) - 1,
                    max(0, int(round(q / 100 * (len(data) - 1)))))]


def max_err(a, b):
    torch.cuda.synchronize()
    return float((a.float() - b.float()).abs().max())


def check_close(what, got, want, tol=KERNEL_TOL):
    """Max abs error of ``got`` against ``want``; fails past ``tol`` times
    the larger of 1 and ``want``'s largest magnitude."""
    e = max_err(got, want)
    lim = tol * max(1.0, float(want.abs().max()))
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(e <= lim, f"{what}: error {e} > {lim}")
    return e


# ------------------------------------------------------------ phase 3
def check_k1(fa, dev, rng):
    """K1 flash_fwd: causal prefill at T in {8, 100, 1024} (buckets and a
    ragged length), plus a key-bias case whose batch row 1 is masked
    everywhere.  Timed at T = 1024, the largest bucket."""
    H, D = HEADS, HEAD_DIM
    scale = 1.0 / math.sqrt(D)

    def rand(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)

    err = 0.0
    cases = [(1, T, None) for T in (8, 100, 1024)]
    mask = (rng.rand(2, 100) > 0.3).astype(np.float32)
    mask[1] = 0.0
    cases.append((2, 100, torch.from_numpy(mask).to(dev)))
    for B, T, m in cases:
        q, k, v = rand(B, H, T, D), rand(B, H, T, D), rand(B, H, T, D)
        got = fa.flash_attention(q, k, v, scale=scale, causal=True, mask=m)
        want = fa._plain_flash_attention(q, k, v, scale, True, m)
        e = max_err(got, want)
        check(bool(torch.isfinite(got).all()), f"K1 T={T}: non-finite output")
        print(f"K1 flash_fwd B={B} H={H} T={T} D={D} causal "
              f"bias={m is not None}: max_abs_err {e:.3e} "
              f"(tol {KERNEL_TOL})", flush=True)
        check(e <= KERNEL_TOL, f"K1 T={T}: error {e} > {KERNEL_TOL}")
        err = max(err, e)

    B, T = 1, 1024
    sets = [tuple(rand(B, H, T, D) for _ in range(3)) for _ in range(8)]

    def k1(q, k, v):
        return fa.flash_attention(q, k, v, scale=scale, causal=True)
    ms, eager = device_ms(k1, sets, 20), time_ms(k1, sets, 20)
    plain = time_ms(lambda q, k, v: fa._plain_flash_attention(
        q, k, v, scale, True), sets, 5)
    lib = device_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale), sets, 20)
    names = device_kernel_names(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale), *sets[0])
    print(f"K1 library: scaled_dot_product_attention (fp32, causal) runs "
          f"{names or 'no traced kernel'}", flush=True)
    pairs = B * H * T * (T + 1) // 2          # causal (query, key) pairs
    (bnd, by), old = k1_bounds(4 * B * H * T * D * 4, 4 * D * pairs)
    print(f"K1 bound B={B} H={H} T={T} D={D} causal: {bnd:.4f} ms by {by} "
          f"(3xTF32 at 495 TFLOP/s); the fp32 CUDA-core bound of earlier "
          f"rows {old:.4f} ms", flush=True)
    return {"name": "flash_fwd", "source": SOURCES + "flash_fwd.cu",
            "replaces": TPU_KERNELS + "68", "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib, "eager_ms": eager,
            "shape": f"B={B} H={H} T={T} D={D} causal"}


def decode_inputs(dev, rng, copies, rows=1, positions=DECODE_POSITIONS):
    """The serving path's decode shapes: 8 slots, 12 heads of 64, blocks
    of 16, 64 blocks per slot (max_len 1024) in a pool of 1 + 8 * 64,
    tables shuffled, holding the blocks up to each slot's position plus
    ``rows - 1`` (a verify's last row) and padded with the null block 0.
    ``copies`` pools (one per layer, as the engine holds them)."""
    S, H, D, bs, MB = 8, HEADS, HEAD_DIM, 16, 64
    NB = 1 + S * MB
    positions = np.array(positions, np.int32)
    perm = rng.permutation(np.arange(1, NB)).astype(np.int32)
    tables = np.zeros((S, MB), np.int32)
    used = 0
    for s in range(S):
        live = min(MB, (int(positions[s]) + rows - 1) // bs + 1)
        tables[s, :live] = perm[used:used + live]
        used += live
    sets = []
    for _ in range(copies):
        kp = torch.randn(NB, H, bs, D, device=dev)
        vp = torch.randn(NB, H, bs, D, device=dev)
        q = torch.randn(S, H, D, device=dev)
        sets.append((q, kp, vp))
    return (sets, torch.from_numpy(tables).to(dev),
            torch.from_numpy(positions).to(dev), positions, tables)


def dense_view(pages, tables):
    """A pool's blocks as each slot's dense (S, H, T, D) cache."""
    S, MB = tables.shape
    _, H, bs, D = pages.shape
    return pages[tables.long()].permute(0, 2, 1, 3, 4) \
        .reshape(S, H, MB * bs, D).contiguous()


def check_k2_k3(fa, dev, rng):
    sets, tables, pos, pos_h, tables_h = decode_inputs(dev, rng, 12)
    S, MB = tables.shape
    _, H, bs, D = sets[0][1].shape
    T = MB * bs
    scale = 1.0 / math.sqrt(D)
    live = int((pos_h.astype(np.int64) + 1).sum())
    # bytes: live K and V once, q in, o out, positions, live table entries
    nbytes = (2 * H * live * D + 2 * S * H * D + S
              + int((pos_h // bs + 1).sum())) * 4
    bnd, by = bound_ms(nbytes, 4 * H * live * D)
    part = fa._decode_scratch_shape(S, H, T, D)
    print(f"K2 split: {part[2]} chunks of {fa._DECODE_CHUNK} keys "
          f"(grid {H} x {S} x {part[2]}, "
          f"{int(((pos_h // fa._DECODE_CHUNK) + 1).sum()) * H} live blocks), "
          f"scratch {tuple(part)} fp32 = {4 * math.prod(part)} bytes",
          flush=True)

    dsets = [(q, dense_view(kp, tables), dense_view(vp, tables))
             for q, kp, vp in sets]
    q, kp, vp = sets[0]
    got2 = fa.paged_decode_attention(q, kp, vp, tables, pos, scale=scale)
    e2 = max_err(got2, fa._plain_paged_decode_attention(
        q, kp, vp, tables, pos, scale))
    qd, kd, vd = dsets[0]
    got3 = fa.decode_attention(qd, kd, vd, pos, scale=scale)
    e3 = max_err(got3, fa._plain_decode_attention(qd, kd, vd, pos, scale))
    same = bool(torch.equal(got2, got3))
    print(f"K2 paged_decode S={S} H={H} bs={bs} MB={MB} D={D} positions "
          f"{pos_h.tolist()}: max_abs_err {e2:.3e} (tol {KERNEL_TOL})",
          flush=True)
    print(f"K3 decode S={S} H={H} T={T} D={D}: max_abs_err {e3:.3e} "
          f"(tol {KERNEL_TOL}); bitwise equal to K2: {same}", flush=True)
    check(e2 <= KERNEL_TOL, f"K2: error {e2} > {KERNEL_TOL}")
    check(e3 <= KERNEL_TOL, f"K3: error {e3} > {KERNEL_TOL}")
    check(same, "K2 and K3 disagree on the same live K/V")

    def k2_call(q, kp, vp):
        return fa.paged_decode_attention(q, kp, vp, tables, pos, scale=scale)

    def k3_call(q, k, v):
        return fa.decode_attention(q, k, v, pos, scale=scale)
    k2, k2_eager = device_ms(k2_call, sets, 50), time_ms(k2_call, sets, 50)
    k2_plain = time_ms(lambda q, kp, vp: fa._plain_paged_decode_attention(
        q, kp, vp, tables, pos, scale), sets, 5)
    k3, k3_eager = device_ms(k3_call, dsets, 50), time_ms(k3_call, dsets, 50)
    k3_plain = time_ms(lambda q, k, v: fa._plain_decode_attention(
        q, k, v, pos, scale), dsets, 5)
    keep = (torch.arange(T, device=dev)[None, :] <= pos.long()[:, None])
    keep = keep[:, None, None, :]
    k3_lib = device_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=keep, scale=scale), dsets, 50)
    shape = f"S={S} H={H} D={D} positions {pos_h.tolist()}"
    return [
        {"name": "paged_decode", "source": SOURCES + "paged_decode.cu",
         "replaces": TPU_KERNELS + "689", "max_abs_err": e2, "ms": k2,
         "plain_ms": k2_plain, "bound_ms": bnd, "bound_by": by,
         "library_ms": None, "eager_ms": k2_eager,
         "shape": shape + f" bs={bs} MB={MB}"},
        {"name": "decode", "source": SOURCES + "decode.cu",
         "replaces": TPU_KERNELS + "552", "max_abs_err": e3, "ms": k3,
         "plain_ms": k3_plain, "bound_ms": bnd, "bound_by": by,
         "library_ms": k3_lib, "eager_ms": k3_eager, "shape": shape + f" T={T}"}]


def check_k4_k5(fa, dev, rng):
    """K4 paged_verify and K5 verify at the decode shapes with Q = 1, 5
    and 9 query rows (the slot at 1023 runs past T = 1024), and at Q = 5
    with rows straddling the 64-key chunk edges (a slot at 60); every row
    against K2 at its own position.  Timed at Q = 5, the verify of
    ``spec_k`` 4."""
    sets, tables, pos, pos_h, _ = decode_inputs(dev, rng, 12, rows=9)
    S, MB = tables.shape
    _, H, bs, D = sets[0][1].shape
    T = MB * bs
    scale = 1.0 / math.sqrt(D)
    _, kp, vp = sets[0]
    e4 = e5 = 0.0
    straddle = decode_inputs(dev, np.random.RandomState(SEED + 1), 1, rows=5,
                             positions=STRADDLE_POSITIONS)
    cases = [(Q, kp, vp, tables, pos, pos_h) for Q in (1, 5, 9)]
    cases.append((5, *straddle[0][0][1:], *straddle[1:4]))
    for Q, kp_c, vp_c, tab_c, pos_c, ph in cases:
        kd, vd = dense_view(kp_c, tab_c), dense_view(vp_c, tab_c)
        q = torch.randn(S, H, Q, D, device=dev)
        got4 = fa.paged_verify_decode_attention(q, kp_c, vp_c, tab_c, pos_c,
                                                scale=scale)
        got5 = fa.verify_decode_attention(q, kd, vd, pos_c, scale=scale)
        err4 = max_err(got4, fa._plain_paged_verify_decode_attention(
            q, kp_c, vp_c, tab_c, pos_c, scale))
        err5 = max_err(got5, fa._plain_verify_decode_attention(
            q, kd, vd, pos_c, scale))
        same = bool(torch.equal(got4, got5))
        print(f"K4 paged_verify S={S} H={H} Q={Q} bs={bs} MB={MB} D={D} "
              f"positions {ph.tolist()}: max_abs_err {err4:.3e}; K5 verify "
              f"T={T}: max_abs_err {err5:.3e} (tol {KERNEL_TOL}); bitwise "
              f"equal: {same}", flush=True)
        check(bool(torch.isfinite(got4).all()), f"K4 Q={Q}: non-finite")
        check(err4 <= KERNEL_TOL, f"K4 Q={Q}: error {err4} > {KERNEL_TOL}")
        check(err5 <= KERNEL_TOL, f"K5 Q={Q}: error {err5} > {KERNEL_TOL}")
        check(same, f"K4 and K5 disagree on the same live K/V at Q={Q}")
        e4, e5 = max(e4, err4), max(e5, err5)
        # row j against K2 at positions[s] + j
        errs, equal = [], []
        for j in range(Q):
            k2 = fa.paged_decode_attention(q[:, :, j].contiguous(), kp_c,
                                           vp_c, tab_c, pos_c + j,
                                           scale=scale)
            errs.append(max_err(got4[:, :, j], k2))
            equal.append(bool(torch.equal(got4[:, :, j], k2)))
        print(f"K4 rows 0..{Q - 1} against K2 at positions + j: max_abs_err "
              f"{max(errs):.3e} (tol {KERNEL_TOL}); bitwise equal per row: "
              f"{equal}", flush=True)
        check(max(errs) <= KERNEL_TOL,
              f"K4 at Q={Q} differs from K2 by {max(errs)}")

    Q = 5
    vsets = [(torch.randn(S, H, Q, D, device=dev), kp, vp)
             for _, kp, vp in sets]
    dsets = [(q, dense_view(kp, tables), dense_view(vp, tables))
             for q, kp, vp in vsets]
    # the keys a (slot, head) must read, and the live (row, key) pairs
    heads = np.minimum(pos_h.astype(np.int64)[:, None] + np.arange(Q), T - 1)
    live = heads[:, -1] + 1
    pairs = int((heads + 1).sum())
    nbytes = (2 * H * int(live.sum()) * D + 2 * S * H * Q * D + S
              + int(-(-live // bs).sum())) * 4
    bnd, by = bound_ms(nbytes, 4 * H * pairs * D)
    part = fa._verify_scratch_shape(S, H, Q, T, D)
    print(f"K4/K5 split: {part[3]} chunks of {fa._DECODE_CHUNK} keys "
          f"(grid {H} x {S} x {part[3]}, "
          f"{int((heads[:, -1] // fa._DECODE_CHUNK + 1).sum()) * H} live "
          f"blocks; merge grid {H} x {S} x {Q}), scratch {tuple(part)} fp32 "
          f"= {4 * math.prod(part)} bytes", flush=True)

    def k4_call(q, kp, vp):
        return fa.paged_verify_decode_attention(q, kp, vp, tables, pos,
                                                scale=scale)

    def k5_call(q, k, v):
        return fa.verify_decode_attention(q, k, v, pos, scale=scale)
    k4, k4_eager = device_ms(k4_call, vsets, 50), time_ms(k4_call, vsets, 50)
    k4_plain = time_ms(lambda q, kp, vp:
                       fa._plain_paged_verify_decode_attention(
                           q, kp, vp, tables, pos, scale), vsets, 5)
    k5, k5_eager = device_ms(k5_call, dsets, 50), time_ms(k5_call, dsets, 50)
    k5_plain = time_ms(lambda q, k, v: fa._plain_verify_decode_attention(
        q, k, v, pos, scale), dsets, 5)
    keep = torch.arange(T, device=dev)[None, None, :] \
        <= (pos.long()[:, None] + torch.arange(Q, device=dev))[:, :, None]
    keep = keep[:, None]                                   # (S, 1, Q, T)
    k5_lib = device_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, attn_mask=keep, scale=scale), dsets, 50)
    shape = f"S={S} H={H} Q={Q} D={D} positions {pos_h.tolist()}"
    return [
        {"name": "paged_verify", "source": SOURCES + "paged_verify.cu",
         "replaces": TPU_KERNELS + "962", "max_abs_err": e4, "ms": k4,
         "plain_ms": k4_plain, "bound_ms": bnd, "bound_by": by,
         "library_ms": None, "eager_ms": k4_eager,
         "shape": shape + f" bs={bs} MB={MB}"},
        {"name": "verify", "source": SOURCES + "verify.cu",
         "replaces": TPU_KERNELS + "841", "max_abs_err": e5, "ms": k5,
         "plain_ms": k5_plain, "bound_ms": bnd, "bound_by": by,
         "library_ms": k5_lib, "eager_ms": k5_eager, "shape": shape + f" T={T}"}]


def library_bwd(fa, sets, B, H, T, D, scale):
    """PyTorch's one backward call for K6 and K7's function: the
    efficient-attention backward (dq, dk and dv together) on its own
    forward's saved out, logsumexp and seeds, over ``sets`` reshaped to
    (B, H, T, D), timed on the card as the kernels are (``device_ms``).
    Prints the kernels it launches and its largest gradient error
    against the plain backward on the first set.  Returns (ms, what)."""
    fwd = torch.ops.aten._scaled_dot_product_efficient_attention
    bwd = torch.ops.aten._scaled_dot_product_efficient_attention_backward
    saved = []
    for q, k, v, g, *_ in sets:
        xs = [x.reshape(B, H, T, D) for x in (q, k, v)]
        o, lse, seed, offset = fwd(*xs, None, True, scale=scale)
        saved.append((g.reshape(B, H, T, D), *xs, o, lse, seed, offset))

    def call(g, q, k, v, o, lse, seed, offset):
        return bwd(g, q, k, v, None, o, lse, seed, offset, 0.0,
                   [True, True, True, False], False, scale=scale)
    ms = device_ms(call, saved, 20)
    what = "aten._scaled_dot_product_efficient_attention_backward"
    print(f"K6/K7 library: {what} runs "
          f"{device_kernel_names(call, *saved[0]) or 'no traced kernel'}",
          flush=True)
    q, k, v, g, lse, dd = sets[0]
    want = fa._plain_flash_bwd_dd(q, k, v, None, g, lse, dd, scale, False, H)
    err = max(max_err(a.reshape(b.shape), b)
              for a, b in zip(call(*saved[0])[:3], want[:3]))
    print(f"K6/K7 library: max abs error of its dq, dk, dv against the "
          f"plain backward {err:.3e}", flush=True)
    return ms, what


def check_k6_k7(fa, dev, rng):
    """K1 with lse, K6 flash_bwd_dq and K7 flash_bwd_dkv against the plain
    forward-with-lse and backward on the same inputs: BERT-large's
    attention (B=32, H=16, T=128, D=64, dense, no mask), a ragged key mask
    at T=512 (B=8) and causal at T=300 with a mask.  Also K1's lse through
    the public ``flash_attention_lse``.  Timed at the first shape, the
    training path's."""
    H, D = BERT_HEADS, HEAD_DIM
    scale = 1.0 / math.sqrt(D)
    f32 = torch.float32

    def rand(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)

    def key_mask(B, T):
        m = np.ones((B, T), np.float32)
        for b in range(B):
            m[b, rng.randint(1, T + 1):] = 0.0      # ragged valid length
        return torch.from_numpy(m).to(dev)

    e_lse = e6 = e7 = 0.0
    for B, T, causal, masked in ((TRAIN_B, TRAIN_T, False, False),
                                 (8, 512, False, True), (2, 300, True, True)):
        q, k, v, g = (rand(B * H, T, D) for _ in range(4))
        mask = key_mask(B, T) if masked else None
        bias = fa._key_bias(mask, B, T, dev)
        out, lse = fa._flash_fwd_cuda(q, k, v, bias, scale, causal, H,
                                      with_lse=True)
        pout, plse = fa._plain_attention_lse(q, k, v, scale, causal,
                                             fa._per_head(bias, H))
        e_out = check_close(f"K1 T={T} out", out, pout)
        el = check_close(f"K1 T={T} lse", lse, plse)
        dd = fa._bwd_dd(out, g)
        dq, dk, dv, dbs = fa._flash_bwd_cuda(q, k, v, bias, g, lse, dd,
                                             scale, causal, H)
        pdq, pdk, pdv, pdbs = fa._plain_flash_bwd_dd(q, k, v, bias, g, plse,
                                                     fa._bwd_dd(pout, g),
                                                     scale, causal, H)
        ea = check_close(f"K6 T={T} dq", dq, pdq)
        eb = max(check_close(f"K7 T={T} dk", dk, pdk),
                 check_close(f"K7 T={T} dv", dv, pdv),
                 check_close(f"K7 T={T} dbias rows", dbs, pdbs))
        print(f"K1+lse / K6 / K7 B={B} H={H} T={T} D={D} causal={causal} "
              f"mask={masked}: max_abs_err out {e_out:.3e} lse {el:.3e} "
              f"dq {ea:.3e} dk/dv/dbs {eb:.3e} (tol {KERNEL_TOL}, relative "
              f"past 1)", flush=True)
        e_lse, e6, e7 = max(e_lse, el), max(e6, ea), max(e7, eb)
    # the public entry: (B, H, T, D) with a (B, T) mask
    B, T = 4, 200
    q, k, v = (rand(B, H, T, D) for _ in range(3))
    mask = key_mask(B, T)
    out, lse = fa.flash_attention_lse(q, k, v, mask=mask)
    pout, plse = fa._plain_attention_lse(
        *(x.reshape(B * H, T, D) for x in (q, k, v)), scale, False,
        fa._per_head(fa._key_bias(mask, B, T, dev), H))
    el = check_close("flash_attention_lse lse", lse.reshape(B * H, T), plse)
    check_close("flash_attention_lse out", out.reshape(B * H, T, D), pout)
    print(f"flash_attention_lse B={B} H={H} T={T}: lse max_abs_err "
          f"{el:.3e}", flush=True)
    e_lse = max(e_lse, el)

    # timing at the training path's shape, 8 rotating input sets
    B, T = TRAIN_B, TRAIN_T
    BH = B * H
    sets = []
    for _ in range(8):
        q, k, v, g = (torch.randn(BH, T, D, device=dev) for _ in range(4))
        out, lse = fa._flash_fwd_cuda(q, k, v, None, scale, False, H,
                                      with_lse=True)
        sets.append((q, k, v, g, lse, fa._bwd_dd(out, g)))
    outs = [torch.empty(BH, T, D, device=dev) for _ in range(2)]
    dbs = torch.empty(BH, T, device=dev, dtype=f32)
    args = (BH, H, T, D, float(scale), 0)
    def k6_call(q, k, v, g, lse, dd):
        fa._launch("flash_bwd_dq", q, k, v, None, g, lse, dd, outs[0], *args)

    def k7_call(q, k, v, g, lse, dd):
        fa._launch("flash_bwd_dkv", q, k, v, None, g, lse, dd, outs[0],
                   outs[1], dbs, *args)
    k6, k6_eager = device_ms(k6_call, sets, 20), time_ms(k6_call, sets, 20)
    k7, k7_eager = device_ms(k7_call, sets, 20), time_ms(k7_call, sets, 20)
    plain = time_ms(lambda q, k, v, g, lse, dd: fa._plain_flash_bwd_dd(
        q, k, v, None, g, lse, dd, scale, False, H), sets, 5)
    k1_lse = device_ms(lambda q, k, v, *_: fa._flash_fwd_cuda(
        q, k, v, None, scale, False, H, with_lse=True), sets, 20)
    k1 = device_ms(lambda q, k, v, *_: fa._flash_fwd_cuda(
        q, k, v, None, scale, False, H), sets, 20)

    lib_bwd, lib_what = library_bwd(fa, sets, B, H, T, D, scale)
    n = BH * T
    (bnd6, by6), old6 = k1_bounds((5 * n * D + 2 * n) * 4, 6 * BH * T * T * D)
    (bnd7, by7), old7 = k1_bounds((6 * n * D + 3 * n) * 4, 8 * BH * T * T * D)
    (bnd1, _), old1 = k1_bounds((4 * n * D + n) * 4, 4 * BH * T * T * D)
    # the library yardstick: PyTorch's efficient-attention op with its
    # logsumexp (the same two outputs), else SDPA's forward alone
    shaped = [tuple(x.reshape(B, H, T, D) for x in st[:3]) for st in sets]
    eff = getattr(torch.ops.aten, "_scaled_dot_product_efficient_attention",
                  None)
    lib1, lib1_what = None, ""
    if eff is not None:
        try:
            eff(*shaped[0], None, True, scale=scale)
            lib1 = device_ms(lambda q, k, v: eff(q, k, v, None, True,
                                                 scale=scale), shaped, 20)
            lib1_what = "aten._scaled_dot_product_efficient_attention " \
                "with compute_log_sumexp=True"
        except RuntimeError as e:       # the op refuses these inputs
            print(f"K1 train library: efficient attention refused: {e}",
                  flush=True)
    sdpa1 = device_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, scale=scale), shaped, 20)
    if lib1 is None:
        lib1, lib1_what = sdpa1, "scaled_dot_product_attention (no lse)"
    print(f"time: K1 flash_fwd at the training shape (B={B} H={H} T={T} "
          f"D={D}, dense): {k1:.4f} ms without lse, {k1_lse:.4f} ms with "
          f"lse, bound {bnd1:.4f} ms (3xTF32; fp32 CUDA-core bound "
          f"{old1:.4f} ms); library {lib1:.4f} ms ({lib1_what}), SDPA's "
          f"forward {sdpa1:.4f} ms", flush=True)
    print(f"time: K6 + K7 at the training shape: {k6:.4f} + {k7:.4f} = "
          f"{k6 + k7:.4f} ms on the card, against the library backward's "
          f"{lib_bwd:.4f} ms ({lib_what}: dq, dk and dv in one call; each "
          f"row's library_ms is that whole backward); bounds K6 {bnd6:.4f} "
          f"ms by {by6}, K7 {bnd7:.4f} ms by {by7} (3xTF32; fp32 CUDA-core "
          f"bounds {old6:.4f} and {old7:.4f} ms)", flush=True)
    shape = f"B={B} H={H} T={T} D={D} dense"
    return e_lse, [
        {"name": "flash_bwd_dq", "source": SOURCES + "flash_bwd_dq.cu",
         "replaces": TPU_KERNELS + "184", "max_abs_err": e6, "ms": k6,
         "plain_ms": plain, "bound_ms": bnd6, "bound_by": by6,
         "library_ms": lib_bwd, "eager_ms": k6_eager, "shape": shape},
        {"name": "flash_bwd_dkv", "source": SOURCES + "flash_bwd_dkv.cu",
         "replaces": TPU_KERNELS + "227", "max_abs_err": e7, "ms": k7,
         "plain_ms": plain, "bound_ms": bnd7, "bound_by": by7,
         "library_ms": lib_bwd, "eager_ms": k7_eager, "shape": shape}]


def bert_large_shapes():
    """The 399 leaf shapes of BERT-large with the pretraining heads."""
    from incubator_mxnet_tpu_torch.models import bert as bert_mod
    net = bert_mod.BERTForPretrain(bert_mod.bert_large(dropout=0.0),
                                   vocab_size=BERT_VOCAB)
    shapes = [tuple(p.shape) for p in net.parameters()]
    del net
    torch.cuda.empty_cache()
    return shapes


def check_k8(fa, dev):
    """K8 multi_tensor_adam against its plain version (the per-leaf
    ``cores.prep_grad`` + ``cores.adam`` loop) over BERT-large's 399 leaf
    shapes, bit for bit, with every gradient stage off (the training
    path's) and on; then its time on the card against the bound (28 bytes
    per parameter) and against ``torch.optim.Adam(fused=True)`` over the
    same leaves (a yardstick only: its bias correction and wd differ)."""
    from incubator_mxnet_tpu_torch.optimizer import fused
    from incubator_mxnet_tpu_torch.parallel import optim as fopt
    shapes = bert_large_shapes()
    n = sum(math.prod(s) for s in shapes)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def leaves(scale):
        return [torch.randn(s, device=dev, generator=gen) * scale
                for s in shapes]

    w, g, m = leaves(0.02), leaves(1e-3), leaves(1e-4)
    v = [x * x for x in leaves(1e-3)]
    lr_t = fopt.bias_corrected_lr(1e-4, 0.9, 0.999, torch.tensor(
        3, dtype=torch.int32, device=dev))
    err = 0.0
    for stages in ((1.0, None, 0.0), (0.25, 0.004, 0.02)):
        got = [[x.clone() for x in xs] for xs in (w, m, v)]
        want = [[x.clone() for x in xs] for xs in (w, m, v)]
        fused.adam_update(got[0], g, got[1], got[2], lr_t, 0.9, 0.999, 1e-8,
                          *stages)
        fused._plain_adam_update(want[0], g, want[1], want[2], lr_t, 0.9,
                                 0.999, 1e-8, *stages)
        torch.cuda.synchronize()
        for what, a, b in zip("wmv", got, want):
            for i, (x, y) in enumerate(zip(a, b)):
                err = max(err, max_err(x, y))
                check(torch.equal(x, y), f"K8 {what} of leaf {i} "
                      f"{tuple(x.shape)} differs from the plain version "
                      f"(stages {stages})")
        del got, want
    print(f"K8 multi_tensor_adam over {len(shapes)} leaves ({n} "
          f"parameters): bit for bit the plain version, stages off and on "
          f"(max_abs_err {err})", flush=True)

    def k8():
        fused.adam_update(w, g, m, v, lr_t, 0.9, 0.999, 1e-8)

    k8_ms, k8_eager = device_ms(k8, [()], 20), time_ms(k8, [()], 20)
    plain = time_ms(lambda: fused._plain_adam_update(
        w, g, m, v, lr_t, 0.9, 0.999, 1e-8, 1.0, None, 0.0), [()], 3)
    ps = [torch.nn.Parameter(x.clone()) for x in w]
    for p, x in zip(ps, g):
        p.grad = x
    lib = torch.optim.Adam(ps, lr=1e-4, fused=True, capturable=True)
    lib_ms = device_ms(lib.step, [()], 20)
    del ps, lib
    torch.cuda.empty_cache()
    bnd, by = bound_ms(28 * n, 12 * n)
    print(f"time: K8 multi_tensor_adam, {len(shapes)} leaves, {n} "
          f"parameters: {k8_ms:.4f} ms on the card ({k8_eager:.4f} ms per "
          f"eager call), bound {bnd:.4f} ms by {by} (28 bytes per "
          f"parameter at 3.35 TB/s), plain {plain:.4f} ms, "
          f"torch.optim.Adam(fused=True, capturable=True) {lib_ms:.4f} ms "
          f"[{CARD}]", flush=True)
    return {"name": "multi_tensor_adam",
            "source": SOURCES + "multi_tensor_adam.cu",
            "replaces": "incubator_mxnet_tpu/parallel/optim.py:124",
            "max_abs_err": err, "ms": k8_ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms,
            "eager_ms": k8_eager,
            "shape": f"BERT-large + heads, {len(shapes)} leaves, {n} "
                     "parameters"}


# ------------------------------------------------------------ phase 4
# The served model, engine and requests; tools/torch_profile_serving.py
# measures the same set-up through these two functions.
LENGTHS = [5, 100, 700, 17, 264, 350, 40, 130]


def build_served(seed=SEED):
    """``gpt2_124m`` at full width on ``cuda:0`` with ``Normal(0.02)``
    weights from ``seed``, behind a default (paged) ``GenerationEngine``
    that has been warmed.  Returns ``(net, engine)``."""
    from incubator_mxnet_tpu_torch import initializer as init
    from incubator_mxnet_tpu_torch.models.gpt import gpt2_124m
    from incubator_mxnet_tpu_torch.serving import GenerationEngine
    t0 = time.perf_counter()
    net = gpt2_124m(dropout=0.0)
    net.initialize(init.Normal(0.02), seed=seed)
    n_params = sum(p.numel() for p in net.parameters())
    print(f"path: gpt2_124m on {net.device}, {n_params} parameters, "
          f"Normal(0.02) seed {seed}, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    eng = GenerationEngine(net)
    check(eng.paged and eng.max_slots == 8 and eng.max_len == 1024
          and eng.scan_steps == 8 and eng.block_size == 16,
          f"engine defaults changed: {eng!r}")
    t0 = time.perf_counter()
    n_warm = eng.warmup()
    torch.cuda.synchronize()
    print(f"path: engine {eng!r}; warmup of {n_warm} programs "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return net, eng


def served_requests(vocab, seed=SEED):
    """8 prompts of ``LENGTHS`` tokens, the second and fifth sharing a
    64-token prefix, and budgets of 32 to 64 new tokens."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, 64).tolist()
    prompts = []
    for i, n in enumerate(LENGTHS):
        p = rng.randint(0, vocab, n).tolist()
        if i in (1, 4):
            p = prefix + p[64:]
        prompts.append(p)
    return prompts, rng.randint(32, 65, len(prompts)).tolist()


def same_or_near_tie(net, prompt, want, got, what):
    """Check that ``got`` equals ``want`` (both continuations of
    ``prompt``) or first differs at a token where ``want``'s top-2 logit
    gap, from a full-prefix forward, is below ``LOGIT_GAP_TOL``: a greedy
    near-tie that two attention paths may split.  Returns the index of
    the first difference, or None."""
    check(len(got) == len(want), f"{what}: {len(got)} tokens, expected "
          f"{len(want)}")
    for i, (a, b) in enumerate(zip(want, got)):
        if a == b:
            continue
        with torch.no_grad():
            lg = net(torch.tensor([list(prompt) + list(want[:i])],
                                  device=net.device))
        top2 = torch.topk(lg[0, -1], 2).values
        gap = float(top2[0] - top2[1])
        print(f"{what}: differs at token {i}: top-2 logit gap {gap:.3e} "
              f"(tol {LOGIT_GAP_TOL})", flush=True)
        check(gap < LOGIT_GAP_TOL, f"{what}: {got} != {want}")
        return i
    return None


def drive_path(fa):
    """The paged main path (8 batched requests), then the dense engine on
    one request, each in its own launch-count window; then both engines'
    graphs against their eager bodies, and the request features.
    Returns the two windows' counts, the served net and engine, and the
    requests with their plain paged outputs."""
    from incubator_mxnet_tpu_torch.serving import (ContinuousBatcher,
                                                   GenerationEngine)
    net, eng = build_served()
    prompts, budgets = served_requests(net._vocab_size)

    # time every engine dispatch on the host clock: each returns host
    # values, so each call ends synchronised with the card
    log = {"prefill": [], "decode": [], "decode_burst": []}

    def timed(kind, fn):
        def call(*a, **kw):
            hits = eng.pool.hits
            t = time.perf_counter()
            out = fn(*a, **kw)
            dt = time.perf_counter() - t
            info = None
            if kind == "prefill":
                n = len(a[0])
                shared = (eng.pool.hits - hits) * eng.block_size
                info = (eng.prefill_bucket_for(n - shared), shared > 0,
                        tuple(int(x) for x in a[0]))
            log[kind].append((dt, info))
            return out
        return call

    for kind in log:
        setattr(eng, kind, timed(kind, getattr(eng, kind)))
    hits0 = eng.pool.hits
    dense = GenerationEngine(net, name="dense", paged=False)
    dense.warmup()
    program_line("plain", eng, CARD)
    program_line("plain", dense, CARD)

    from incubator_mxnet_tpu_torch import telemetry
    telemetry.reset()
    fa.reset_launch_counts()                 # --- the paged main path
    t0 = time.perf_counter()
    bat = ContinuousBatcher(eng)
    try:
        reqs = []
        for p, b in zip(prompts, budgets):
            reqs.append(bat.submit_async(p, max_new_tokens=b))
            time.sleep(0.03)
        outs = [r.result(timeout=300) for r in reqs]
        wall = time.perf_counter() - t0
        stats = bat.stats()
    finally:
        bat.close()
    torch.cuda.synchronize()
    counts = dict(fa.launch_counts)          # --- end of the paged path
    ttft = [(r.t_first - r.t_submit) * 1e3 for r in reqs]
    gap = telemetry.registry.get("mxtpu_generate_token_seconds").stats()
    for kind in log:
        delattr(eng, kind)
    fa.reset_launch_counts()                 # --- the dense path
    dense_out = dense.generate(prompts[0], budgets[0])
    torch.cuda.synchronize()
    dense_counts = dict(fa.launch_counts)    # --- end of the dense path

    n_tok = sum(len(o) for o in outs)
    print(f"path: {len(reqs)} requests, prompts {LENGTHS}, budgets "
          f"{budgets}: {n_tok} tokens in {wall:.3f} s = "
          f"{n_tok / wall:.1f} tokens/s; {stats['decode_steps']} steps, "
          f"{stats['decode_burst_dispatches']} bursts, prefix hits "
          f"{eng.pool.hits - hits0}", flush=True)
    print(f"path: time to first token p50 {pct(ttft, 50):.2f} ms, p99 "
          f"{pct(ttft, 99):.2f} ms (batcher clock, submit to emit); "
          f"per-token gap p50 {gap['p50'] * 1e3:.3f} ms, p99 "
          f"{gap['p99'] * 1e3:.3f} ms (mxtpu_generate_token_seconds: a "
          f"burst's gap spread over its tokens) [{CARD}]", flush=True)
    by_bucket = {}
    for dt, (bucket, hit, _) in log["prefill"]:
        by_bucket.setdefault((bucket, hit), []).append(dt * 1e3)
    for (bucket, hit), v in sorted(by_bucket.items()):
        print(f"path: prefill bucket {bucket} ({'prefix hit' if hit else 'miss'}"
              f"): {len(v)} calls, mean {np.mean(v):.2f} ms", flush=True)
    for kind, per in (("decode", 1), ("decode_burst", eng.scan_steps)):
        v = [dt * 1e3 for dt, _ in log[kind]]
        if v:
            print(f"path: {kind}: {len(v)} calls, mean {np.mean(v):.2f} ms "
                  f"per call, {np.mean(v) / per:.2f} ms per step of 8 "
                  f"slots", flush=True)
    print(f"path: launches on the paged path {counts}; on the dense path "
          f"{dense_counts}", flush=True)
    for name, want in (("flash_fwd", True), ("paged_decode", True),
                       ("decode", False)):
        check((counts[name] > 0) == want, f"paged path: kernel {name} "
              f"launched {counts[name]} times")
    for name, want in (("flash_fwd", True), ("paged_decode", False),
                       ("decode", True)):
        check((dense_counts[name] > 0) == want, f"dense path: kernel "
              f"{name} launched {dense_counts[name]} times")
    check(eng.pool.hits > hits0, "no prefix-cache hit on the main path")
    check(stats["decode_burst_dispatches"] > 0, "no decode burst ran")
    check(all(len(o) == b for o, b in zip(outs, budgets)),
          "a request emitted other than its budget")

    # each request alone, in admission order from a fresh cache, so the
    # prefix hits fall as they did in the batch
    admitted = [info[2] for _, info in log["prefill"]]
    order = sorted(range(len(prompts)),
                   key=lambda i: admitted.index(tuple(prompts[i])))
    eng.reset()
    for i in order:
        solo = eng.generate(prompts[i], budgets[i])
        check(solo == outs[i], f"request {i}: batched {outs[i]} != solo "
              f"{solo}")
    print("path: every batched request equals its solo run", flush=True)
    check(dense_out == outs[0], f"dense engine {dense_out} != paged "
          f"{outs[0]}")
    print("path: the dense engine (K3) gives the paged engine's tokens",
          flush=True)

    # the full-prefix oracle on the short request
    n_cmp = 16
    p0 = prompts[0]
    ids = torch.tensor([p0], device=net.device)
    oracle = net.generate(ids, max_new_tokens=n_cmp,
                          use_cache=False)[0, len(p0):].tolist()
    if same_or_near_tie(net, p0, oracle, outs[0][:n_cmp],
                        "path: served vs the oracle") is None:
        print(f"path: the first {n_cmp} tokens equal net.generate("
              "use_cache=False)", flush=True)
    for what, e in (("paged", eng), ("dense", dense)):
        graph_check(what, e, prompts)
    del dense
    drive_features(net, eng)
    return counts, dense_counts, net, eng, prompts, budgets, outs


# ------------------------------------------------------------ phase 5
def build_draft(net, num_layers=6):
    """DistilGPT-2's shape (``gpt2_124m`` with 6 layers) holding the
    target's embeddings, first ``num_layers`` cells and ``ln_f``: a
    layer-truncated draft that agrees with the target often enough at
    random weights to be accepted."""
    from incubator_mxnet_tpu_torch.models.gpt import gpt2_124m
    draft = gpt2_124m(dropout=0.0, num_layers=num_layers, device=net.device)
    missing, unexpected = draft.load_state_dict(net.state_dict(),
                                                strict=False)
    check(not missing and all(k.startswith("cells.") for k in unexpected),
          f"draft weights: missing {missing}")
    return draft


def record_spec_steps(eng):
    """Wrap ``eng.spec_step`` to log each call's host-clock seconds (each
    returns host arrays, so each ends synchronised with the card) and the
    accept count of every live slot (free slots ride along at position
    0).  Returns the log; ``del eng.spec_step`` unwraps."""
    log = []
    real = eng.spec_step

    def step(last, pos):
        t = time.perf_counter()
        out, acc = real(last, pos)
        log.append((time.perf_counter() - t,
                    [int(a) for a, p in zip(acc, pos) if p > 0]))
        return out, acc
    eng.spec_step = step
    return log


def graph_check(what, eng, prompts):
    """Hold ``eng``'s graph replays to its eager bodies over
    ``GRAPH_STEPS`` scripted steps (:func:`graph_vs_eager`): the same
    tokens bit for bit and the same launch counts."""
    same, graph_counts, eager_counts = graph_vs_eager(eng, prompts,
                                                      GRAPH_STEPS)
    print(f"graphs: {what}: {GRAPH_STEPS} scripted steps (sampling "
          f"parameters and tables changed between steps), graph replays "
          f"equal the eager bodies bit for bit: {same}; launches "
          f"{graph_counts} (eager {eager_counts})", flush=True)
    check(same, f"graphs: {what}: graph tokens differ from eager tokens")
    check(graph_counts == eager_counts, f"graphs: {what}: launch counts "
          f"differ")


def drive_spec_path(fa, net, prompts, budgets, plain):
    """The paged speculative path (the 8 requests behind a
    ``ContinuousBatcher``), then a dense target with a dense draft over
    its own net on one request, each in its own launch-count window.
    ``plain`` holds the plain paged path's outputs.  Then the paged spec
    engine's graphs against its eager bodies.  Returns the two windows'
    counts."""
    from incubator_mxnet_tpu_torch.serving import (ContinuousBatcher,
                                                   GenerationEngine)
    t0 = time.perf_counter()
    eng = GenerationEngine(net, name="gpt2_124m")
    draft = GenerationEngine(build_draft(net), name="draft6")
    eng.attach_draft(draft)
    k = eng.spec_k
    check(k == 4 and draft.scan_steps == k and draft.paged,
          f"spec defaults changed: spec_k {k}, draft {draft!r}")
    n_warm = eng.warmup()
    torch.cuda.synchronize()
    print(f"spec: target {eng!r} + draft {draft!r}, spec_k {k}; built and "
          f"warmed ({n_warm} target programs) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    program_line("spec target", eng, CARD)
    program_line("spec draft", draft, CARD)
    log = record_spec_steps(eng)

    fa.reset_launch_counts()                 # --- the paged spec path
    t0 = time.perf_counter()
    bat = ContinuousBatcher(eng)
    try:
        reqs = []
        for p, b in zip(prompts, budgets):
            reqs.append(bat.submit_async(p, max_new_tokens=b))
            time.sleep(0.03)
        outs = [r.result(timeout=300) for r in reqs]
        wall = time.perf_counter() - t0
        stats = bat.stats()
    finally:
        bat.close()
    torch.cuda.synchronize()
    counts = dict(fa.launch_counts)          # --- end of the paged spec path
    del eng.spec_step

    dense = GenerationEngine(net, name="dense", paged=False)
    dense.attach_draft(GenerationEngine(net, name="dense-draft",
                                        paged=False))
    dense.warmup()
    dense_log = record_spec_steps(dense)
    fa.reset_launch_counts()                 # --- the dense spec path
    dense_out = dense.generate(prompts[0], budgets[0])
    torch.cuda.synchronize()
    dense_counts = dict(fa.launch_counts)    # --- end of the dense spec path

    n_tok = sum(len(o) for o in outs)
    ms = [dt * 1e3 for dt, _ in log]
    hist = np.bincount([a for _, acc in log for a in acc], minlength=k + 1)
    dense_hist = np.bincount([a for _, acc in dense_log for a in acc],
                             minlength=k + 1)
    print(f"spec: {len(reqs)} requests, budgets {budgets}: {n_tok} tokens "
          f"in {wall:.3f} s = {n_tok / wall:.1f} tokens/s; "
          f"{stats['spec_dispatches']} verify dispatches, "
          f"{stats['accepted_tokens_per_dispatch']:.3f} tokens per verify "
          f"dispatch per slot, accept rate {stats['spec_accept_rate']:.3f}",
          flush=True)
    print(f"spec: spec_step: {len(ms)} calls, mean {np.mean(ms):.2f} ms "
          f"(min {np.min(ms):.2f}, max {np.max(ms):.2f}) per step of up to "
          f"8 slots; accepted per live slot-step {hist.tolist()} (index = "
          f"draft tokens accepted of {k}); pool rewinds {eng.pool.rewinds} "
          f"target, {draft.pool.rewinds} draft", flush=True)
    print(f"spec: dense run: {len(dense_out)} tokens in {len(dense_log)} "
          f"spec steps, accepted per step {dense_hist.tolist()}", flush=True)
    print(f"spec: launches on the paged spec path {counts}; on the dense "
          f"spec path {dense_counts}", flush=True)
    for name, want in (("flash_fwd", True), ("paged_decode", True),
                       ("paged_verify", True), ("decode", False),
                       ("verify", False)):
        check((counts[name] > 0) == want, f"paged spec path: kernel {name} "
              f"launched {counts[name]} times")
    for name, want in (("flash_fwd", True), ("decode", True),
                       ("verify", True), ("paged_decode", False),
                       ("paged_verify", False)):
        check((dense_counts[name] > 0) == want, f"dense spec path: kernel "
              f"{name} launched {dense_counts[name]} times")
    # at random weights the truncated draft is rarely accepted, so the
    # full-accept branch may run only in the dense run, whose draft is
    # the target's own net
    both = hist + dense_hist
    check(both[k] > 0, "no slot-step accepted every draft token")
    check(both[:k].sum() > 0, "no slot-step rolled back a draft token")
    split = 0
    for i, (p, want, got) in enumerate(zip(prompts, plain, outs)):
        split += same_or_near_tie(net, p, want, got,
                                  f"spec: request {i}") is not None
    split += same_or_near_tie(net, prompts[0], plain[0], dense_out,
                              "spec: dense request 0") is not None
    print(f"spec: {len(outs) + 1 - split} of {len(outs) + 1} requests equal "
          f"the plain path's tokens; {split} first differ at a near-tie",
          flush=True)
    del dense
    graph_check("paged spec", eng, prompts)
    return counts, dense_counts


# ------------------------------------------------- programs and windows
def program_line(what, eng, card):
    """Print the closed program set of ``eng``: expected and captured
    programs, the time warmup spent warming and capturing them, and the
    bytes its shared graph pool reserved; fail unless every program is
    captured."""
    st = eng.graph_stats()
    print(f"programs: {what} {eng.name!r}: expected {st['expected']}, "
          f"captured {st['captured']}, capture "
          f"{st['capture_seconds'] * 1e3:.1f} ms, graph pool "
          f"{st['pool_bytes']} bytes [{card}]", flush=True)
    check(st["captured"] == st["expected"] == eng.compiled_programs(),
          f"{what}: {st['captured']} of {st['expected']} programs captured")
    return st


def scripted_steps(eng, prompts, steps):
    """``steps`` steps of every live slot through ``eng``'s programs
    (``decode``, or ``spec_step`` with a draft attached) from a reset,
    the slots filled from ``prompts`` in turn, with the state changing
    between steps: every third step one slot gets new sampling parameters
    and a logit-bias row that forbids 8 random tokens, and every fourth
    step (or when a slot nears ``max_len``) one slot leaves and the next
    prompt joins in its place, with new blocks and a new table row.
    Returns every step's token array."""
    from incubator_mxnet_tpu_torch.serving import SamplingParams
    S, V = eng.max_slots, eng.vocab_size
    k = eng.spec_k if eng.draft is not None else 0
    rng = np.random.RandomState(SEED)
    eng.reset()
    queue = [list(p) for p in prompts]
    live = {}                              # slot -> (prompt length, tokens)

    def join(s):
        p = queue.pop(0)
        queue.append(p)
        eng.set_slot_sampling(s, None)
        live[s] = (len(p), [eng.prefill(p, s)])

    for s in range(min(S, len(prompts))):
        join(s)
    record = []
    for step in range(steps):
        slots = sorted(live)
        if step % 3 == 2:
            s = slots[step % len(slots)]
            eng.set_slot_sampling(s, SamplingParams(
                temperature=0.7, top_k=int(rng.randint(0, 60)), top_p=0.9,
                seed=int(rng.randint(1 << 30))))
            row = np.zeros(V, np.float32)
            row[rng.randint(0, V, 8)] = -1e9
            eng.update_slot_bias(s, row)
        for s in slots:
            n, toks = live[s]
            if (step % 4 == 3 and s == slots[step % len(slots)]) \
                    or n + len(toks) + k + 1 >= eng.max_len:
                eng.release_slot(s)
                join(s)
        last, pos = np.zeros(S, np.int32), np.zeros(S, np.int32)
        for s, (n, toks) in live.items():
            last[s], pos[s] = toks[-1], n + len(toks) - 1
        if k:
            out, acc = eng.spec_step(last, pos)
            record.append(out.copy())
            for s, (_, toks) in live.items():
                toks.extend(int(t) for t in out[s, :int(acc[s]) + 1])
        else:
            nxt = eng.decode(last, pos)
            record.append(nxt.copy())
            for s, (_, toks) in live.items():
                toks.append(int(nxt[s]))
    for s in list(live):
        eng.release_slot(s)
    return record


def graph_vs_eager(eng, prompts, steps):
    """:func:`scripted_steps` through ``eng``'s captured graphs, then again
    through its bodies run eagerly on the card.  Returns (the two runs'
    tokens equal bit for bit, the graph run's launch counts, the eager
    run's)."""
    fa = importlib.import_module(
        "incubator_mxnet_tpu_torch.kernels.flash_attention")
    fa.reset_launch_counts()
    graph = scripted_steps(eng, prompts, steps)
    torch.cuda.synchronize()
    graph_counts = dict(fa.launch_counts)
    with eng._eager_bodies():
        fa.reset_launch_counts()
        eager = scripted_steps(eng, prompts, steps)
        torch.cuda.synchronize()
        eager_counts = dict(fa.launch_counts)
    same = len(graph) == len(eager) and all(
        np.array_equal(a, b) for a, b in zip(graph, eager))
    return same, graph_counts, eager_counts


# host-side API calls that put work on the card, by the profiler's names
HOST_LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                    "cudaMemcpyAsync", "cudaMemsetAsync")


def profile_window(setup, window, repeats=3):
    """One serving window on the card: the host-clock wall ms (median of
    ``repeats`` unprofiled runs, ``setup`` untimed before each, each run
    ending synchronised), then one ``torch.profiler`` run: the summed
    device time of every kernel and copy, their count, the host API
    calls that launch work (``HOST_LAUNCH_APIS``), and the idle share
    1 - device / wall.  Returns a dict, the profiler beside it."""
    walls = []
    for _ in range(repeats):
        setup()
        torch.cuda.synchronize()
        t = time.perf_counter()
        window()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    setup()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        window()
        torch.cuda.synchronize()
    dev_us, kernels, host = 0.0, 0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_us += e.time_range.end - e.time_range.start
            kernels += 1
        elif e.name in HOST_LAUNCH_APIS:
            host += 1
    wall = float(np.median(walls))
    return {"wall_ms": wall, "walls": walls, "device_ms": dev_us / 1e3,
            "device_ops": kernels, "host_launches": host,
            "idle_share": 1.0 - dev_us / 1e3 / wall}, prof


def serving_windows(eng, spec, prompts, measure):
    """The serving windows, each through ``measure(name, setup, window)``:
    ``burst`` (one ``decode_burst`` of ``eng.scan_steps`` steps over 8
    live slots holding ``prompts``), ``decode`` (one ``decode`` over
    them), ``prefill-1024`` and ``prefill-64`` (one prefix-miss prefill
    of 1000 and 60 tokens), and on ``spec`` (a target with its draft):
    ``spec-step`` (one ``spec_step`` over 8 live slots), ``spec-draft``
    (the draft's burst of ``spec_k`` steps) and ``verify`` (the target's
    verify of ``spec_k + 1`` rows).  Returns {name: measure's result}."""
    S, V = eng.max_slots, eng.vocab_size
    lengths = np.array([len(p) for p in prompts], np.int32)
    rng = np.random.RandomState(SEED)
    state = {}

    def fill(e):
        def setup():
            e.reset()
            last = np.zeros(S, np.int32)
            for s, p in enumerate(prompts):
                last[s] = e.prefill(p, s, reserve_tokens=len(p) + 64)
            state["last"], state["pos"] = last, lengths
            if e.draft is not None:
                sk = e.spec_k
                toks, _ = e.draft.decode_burst(
                    last, lengths, np.full(S, sk + 1), np.full(S, -1),
                    np.ones(S, bool))
                state["rows"] = np.concatenate([last[:, None], toks.T], 1)
        return setup

    def prefill(n):
        p = rng.randint(0, V, n)
        return eng.reset, lambda: eng.prefill(p, 0, reserve_tokens=n + 1)

    out = {}
    out["burst"] = measure("burst", fill(eng), lambda: eng.decode_burst(
        state["last"], state["pos"], np.full(S, 64), np.full(S, -1),
        np.ones(S, bool)))
    out["decode"] = measure("decode", fill(eng), lambda: eng.decode(
        state["last"], state["pos"]))
    out["prefill-1024"] = measure("prefill-1024", *prefill(1000))
    out["prefill-64"] = measure("prefill-64", *prefill(60))
    sk = spec.spec_k
    out["spec-step"] = measure("spec-step", fill(spec), lambda: spec.spec_step(
        state["last"], state["pos"]))
    out["spec-draft"] = measure(
        "spec-draft", fill(spec), lambda: spec.draft.decode_burst(
            state["last"], state["pos"], np.full(S, sk + 1), np.full(S, -1),
            np.ones(S, bool)))
    out["verify"] = measure("verify", fill(spec), lambda: spec.verify(
        state["rows"], state["pos"]))
    eng.reset()
    spec.reset()
    return out


def drive_windows(card):
    """Measure the serving windows (:func:`serving_windows`) on the
    plain path's engine and a spec engine with the 6-layer draft, built
    as the paths build them, and print the ``windows:`` lines: wall,
    device ms, host launches and idle share of each window."""
    net, eng = build_served()
    prompts, _ = served_requests(net._vocab_size)
    from incubator_mxnet_tpu_torch.serving import GenerationEngine
    spec = GenerationEngine(net, name="gpt2_124m")
    spec.attach_draft(GenerationEngine(build_draft(net), name="draft6"))
    spec.warmup()

    def measure(name, setup, window):
        return profile_window(setup, window)[0]
    res = serving_windows(eng, spec, prompts, measure)
    for name, r in res.items():
        print(f"windows: {name}: wall {r['wall_ms']:.3f} ms (median of "
              f"{', '.join(f'{w:.3f}' for w in r['walls'])}), device "
              f"{r['device_ms']:.3f} ms in {r['device_ops']} kernels and "
              f"copies, {r['host_launches']} host launches, idle share "
              f"{r['idle_share']:.3f} [{card}]", flush=True)
    check(all(r["device_ops"] > 0 for r in res.values()),
          "a window ran nothing on the card")
    print("windows: " + json.dumps({name: {k: r[k] for k in (
        "wall_ms", "device_ms", "host_launches", "idle_share")}
        for name, r in res.items()}), flush=True)


def windows_in_child():
    """Run :func:`drive_windows` in a child interpreter (``--windows``),
    so its profiler runs in a process where no batcher thread has run,
    and print the child's ``windows:`` lines.  Fails unless the child
    exits 0 and reports every window."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--windows"], capture_output=True, text=True,
                          timeout=600)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("windows: ")]
    for ln in lines:
        print(ln, flush=True)
    check(proc.returncode == 0 and lines
          and lines[-1].startswith("windows: {"),
          f"windows: the child exited {proc.returncode}:\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    print(f"windows: measured in a child process in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# ------------------------------------------------------------ phase 7
SERVE_QUEUE = 8         # the server's --queue; the flood below exceeds it
SERVE_FLOOD = 40        # concurrent requests of the 429 check
SERVE_DRAIN_TOKENS = 400  # the stream in flight across the SIGTERM


def gpt2_config(**extra):
    """``gpt2_124m``'s architecture as a ``--gen-model`` config, with
    ``extra`` keys over it."""
    cfg = dict(vocab_size=50257, units=768, hidden_size=3072,
               num_layers=12, num_heads=12, max_length=1024)
    cfg.update(extra)
    return cfg


def http_json(base, path, body=None, headers=None, timeout=300):
    """GET (``body`` None) or POST JSON; returns ``(status, headers,
    parsed body or text)``."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers=dict(headers or {}))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            code, hdrs, raw = resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        code, hdrs, raw = e.code, dict(e.headers), e.read()
    text = raw.decode()
    try:
        return code, hdrs, json.loads(text)
    except ValueError:
        return code, hdrs, text


def sse_client(base, model, prompt, budget, out):
    """One streaming ``:generate``: the send time, each token event's
    arrival time (host clock of this process) and the ``done`` payload
    into ``out``."""
    import urllib.request
    req = urllib.request.Request(
        f"{base}/v1/models/{model}:generate",
        data=json.dumps({"tokens": prompt, "max_new_tokens": budget,
                         "stream": True}).encode())
    out["t_send"] = time.perf_counter()
    out["arrivals"], out["tokens"], out["events"] = [], [], []
    with urllib.request.urlopen(req, timeout=600) as resp:
        out["status"] = resp.status
        event = None
        for raw in resp:
            line = raw.decode().rstrip("\n")
            if line.startswith("event: "):
                event = line[len("event: "):]
            elif line.startswith("data: "):
                data = json.loads(line[len("data: "):])
                out["events"].append(event)
                if event == "token":
                    out["arrivals"].append(time.perf_counter())
                    out["tokens"].append(data["token"])
                elif event == "done":
                    out["done"] = data
    out["t_done"] = time.perf_counter()


def launches(base):
    """``mxtpu_kernel_launches`` by kernel, read from the server's
    ``/metrics``."""
    _, _, text = http_json(base, "/metrics")
    out = {}
    for line in text.splitlines():
        if line.startswith("mxtpu_kernel_launches{"):
            name = line.split('kernel="', 1)[1].split('"', 1)[0]
            out[name] = int(float(line.rsplit(" ", 1)[1]))
    return out


def metric_quantiles(base, name):
    """The p50 and p99 of summary ``name`` on the server's ``/metrics``."""
    _, _, text = http_json(base, "/metrics")
    q = {}
    for line in text.splitlines():
        for key, tag in (("p50", 'quantile="0.5"'), ("p99",
                                                      'quantile="0.99"')):
            if line.startswith(f"{name}{{{tag}}}"):
                q[key] = float(line.rsplit(" ", 1)[1])
    return q


def drive_serve(card, ref_path):
    """The HTTP path: ``mxtpu-serve-torch`` started as a user starts it
    (a child process, two ``gpt2_124m`` models: ``plain`` and ``spec``
    with a 6-layer draft), fed the path phase's 8 requests by 8
    concurrent SSE clients and then as 8 sync requests to ``spec``, its
    endpoints read, its queue flooded past ``--queue``, and SIGTERM'd
    with a stream in flight.  Prints the ``serve:`` lines."""
    import socket
    import tempfile
    import threading
    with open(ref_path) as f:
        ref = json.load(f)
    prompts, budgets, plain = ref["prompts"], ref["budgets"], ref["plain"]
    net = []

    def oracle():
        if not net:     # built only when a token differs
            from incubator_mxnet_tpu_torch import initializer as init
            from incubator_mxnet_tpu_torch.models.gpt import gpt2_124m
            n = gpt2_124m(dropout=0.0)
            n.initialize(init.Normal(0.02), seed=SEED)
            net.append(n)
        return net[0]

    def near_tie(prompt, want, got, what):
        if got == want:
            return None
        return same_or_near_tie(oracle(), prompt, want, got, what)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    cfg, draft_cfg = Path(tmp) / "gpt2.json", Path(tmp) / "gpt2_6l.json"
    cfg.write_text(json.dumps(gpt2_config()))
    draft_cfg.write_text(json.dumps(gpt2_config(num_layers=6, spec_k=4)))
    cmd = [sys.executable, "-X", "faulthandler", "-m",
           "incubator_mxnet_tpu_torch._cli", "--gen-model", f"plain={cfg}",
           "--gen-model", f"spec={cfg}", "--gen-draft", f"spec={draft_cfg}",
           "--port", "0", "--host", "127.0.0.1", "--queue",
           str(SERVE_QUEUE)]
    print(f"serve: {' '.join(cmd[3:])}", flush=True)
    t_start = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    log = []
    reader = threading.Thread(target=lambda: log.extend(proc.stderr),
                              daemon=True)
    reader.start()
    try:
        port = None
        while port is None:
            check(proc.poll() is None and time.perf_counter() - t_start
                  < 300, "serve: the server did not start:\n"
                  + "".join(log)[-3000:])
            for line in list(log):
                if "listening on http://127.0.0.1:" in line:
                    port = int(line.split("127.0.0.1:")[1].split()[0])
            time.sleep(0.05)
        base = f"http://127.0.0.1:{port}"
        t_bound = time.perf_counter() - t_start
        unready = 0
        while True:
            code = http_json(base, "/readyz")[0]
            if code == 200:
                break
            unready += 1
            check(proc.poll() is None and time.perf_counter() - t_start
                  < 600, f"serve: never ready ({code}):\n"
                  + "".join(log)[-3000:])
            time.sleep(0.2)
        warm = time.perf_counter() - t_start
        for line in log:
            if "loaded generation model" in line or "attached" in line:
                print(f"serve: server: {line.strip()}", flush=True)
        print(f"serve: port bound after {t_bound:.1f} s, /readyz 200 after "
              f"{warm:.1f} s ({unready} polls answered 503 while the "
              f"programs were captured in the background) [{card}]",
              flush=True)

        # -- plain: 8 concurrent SSE clients
        before = launches(base)
        res = [{} for _ in prompts]
        threads = [threading.Thread(target=sse_client,
                                    args=(base, "plain", p, b, r))
                   for p, b, r in zip(prompts, budgets, res)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        plain_launch = {k: v - before.get(k, 0)
                        for k, v in launches(base).items()}
        check(all(r.get("status") == 200 and r["events"][-1] == "done"
                  for r in res), f"serve: a stream failed: {res}")
        ttft = [(r["arrivals"][0] - r["t_send"]) * 1e3 for r in res]
        gaps = [(b - a) * 1e3 for r in res
                for a, b in zip(r["arrivals"], r["arrivals"][1:])]
        n_tok = sum(len(r["tokens"]) for r in res)
        server_gap = metric_quantiles(base, "mxtpu_generate_token_seconds")
        print(f"serve: plain: 8 concurrent SSE clients, budgets {budgets}: "
              f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} "
              f"tokens/s; time to first token p50 {pct(ttft, 50):.2f} ms, "
              f"p99 {pct(ttft, 99):.2f} ms; gap between tokens p50 "
              f"{pct(gaps, 50):.3f} ms, p99 {pct(gaps, 99):.3f} ms (at the "
              f"client); server's mxtpu_generate_token_seconds p50 "
              f"{server_gap['p50'] * 1e3:.3f} ms, p99 "
              f"{server_gap['p99'] * 1e3:.3f} ms [{card}]", flush=True)
        print(f"serve: plain: kernel launches {plain_launch}", flush=True)
        for name, want in (("flash_fwd", True), ("paged_decode", True),
                           ("paged_verify", False)):
            check((plain_launch.get(name, 0) > 0) == want,
                  f"serve: plain: kernel {name} launched "
                  f"{plain_launch.get(name, 0)} times")
        split = 0
        for i, (p, want, r) in enumerate(zip(prompts, plain, res)):
            check(r["done"]["tokens"] == r["tokens"],
                  f"serve: request {i}: done payload != streamed tokens")
            split += near_tie(p, want, r["tokens"],
                              f"serve: plain request {i}") is not None
        print(f"serve: plain: {8 - split} of 8 streams equal the path "
              f"phase's tokens; {split} first differ at a near-tie",
              flush=True)

        # -- spec: the same 8 prompts as sync requests
        before = launches(base)
        sync = [None] * len(prompts)

        def post(i):
            sync[i] = http_json(base, "/v1/models/spec:generate",
                                {"tokens": prompts[i],
                                 "max_new_tokens": budgets[i]},
                                headers={"x-request-id": f"spec-{i}"})
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(prompts))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        spec_launch = {k: v - before.get(k, 0)
                       for k, v in launches(base).items()}
        check(all(a is not None and a[0] == 200 for a in sync),
              f"serve: a spec request failed: {sync}")
        acc = sum(a[2]["accepted_tokens"] for a in sync)
        drafted = sum(a[2]["draft_tokens"] for a in sync)
        n_tok = sum(a[2]["count"] for a in sync)
        print(f"serve: spec: 8 concurrent sync requests: {n_tok} tokens in "
              f"{wall:.3f} s = {n_tok / wall:.1f} tokens/s; "
              f"accepted_tokens {acc} of draft_tokens {drafted}; kernel "
              f"launches {spec_launch} [{card}]", flush=True)
        check(all(a[2]["request_id"] == f"spec-{i}"
                  and a[1]["X-Request-Id"] == f"spec-{i}"
                  for i, a in enumerate(sync)), "serve: request ids lost")
        for name in ("flash_fwd", "paged_decode", "paged_verify"):
            check(spec_launch.get(name, 0) > 0, f"serve: spec: kernel "
                  f"{name} launched {spec_launch.get(name, 0)} times")
        split = 0
        for i, (p, want, a) in enumerate(zip(prompts, plain, sync)):
            split += near_tie(p, want, a[2]["tokens"],
                              f"serve: spec request {i}") is not None
        print(f"serve: spec: {8 - split} of 8 responses equal the plain "
              f"tokens; {split} first differ at a near-tie", flush=True)

        # -- endpoints
        _, _, progs = http_json(base, "/programs")
        for name, inv in progs["engines"].items():
            check(inv["compiled_programs"] == inv["expected_programs"],
                  f"serve: /programs: {name} {inv}")
        check({"plain", "spec", "spec-draft"} <= set(progs["engines"]),
              f"serve: /programs engines {sorted(progs['engines'])}")
        print("serve: /programs: " + ", ".join(
            f"{n} {inv['compiled_programs']} of {inv['expected_programs']}"
            for n, inv in sorted(progs["engines"].items())), flush=True)
        _, _, mem = http_json(base, "/memory")
        for owner in ("kv:plain", "params:plain"):
            check(mem["owners"].get(owner, 0) > 0,
                  f"serve: /memory: owner {owner} {mem['owners']}")
        print(f"serve: /memory: owners {mem['owners']}; devices "
              f"{mem['devices']} [{card}]", flush=True)
        _, _, text = http_json(base, "/metrics")
        for series in ("mxtpu_generate_tokens",
                       "mxtpu_generate_token_seconds",
                       "mxtpu_dispatches_per_token"):
            check(f"\n{series}" in text, f"serve: /metrics lacks {series}")
        _, _, models = http_json(base, "/v1/models")
        for name, st in models["models"].items():
            check(st["slots_in_use"] == 0, f"serve: {name} still holds "
                  f"{st['slots_in_use']} slots")
        print("serve: /metrics carries the generation series; /v1/models: "
              + ", ".join(f"{n} slots_in_use {st['slots_in_use']}, "
                          f"dispatches_per_token "
                          f"{st['dispatches_per_token']:.3f}"
                          for n, st in sorted(models["models"].items())),
              flush=True)

        # -- backpressure: a flood past --queue
        flood = [None] * SERVE_FLOOD

        def flood_one(i):
            flood[i] = http_json(base, "/v1/models/plain:generate",
                                 {"tokens": [1, 2, 3, 4],
                                  "max_new_tokens": 64})
        threads = [threading.Thread(target=flood_one, args=(i,))
                   for i in range(SERVE_FLOOD)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        shed = [a for a in flood if a is not None and a[0] == 429]
        served = [a for a in flood if a is not None and a[0] == 200]
        check(shed and all(int(a[1]["Retry-After"]) >= 1 for a in shed)
              and len(shed) + len(served) == SERVE_FLOOD,
              f"serve: flood: {[a and a[0] for a in flood]}")
        print(f"serve: flood of {SERVE_FLOOD} concurrent requests past "
              f"--queue {SERVE_QUEUE}: {len(served)} served, {len(shed)} "
              f"answered 429 with Retry-After "
              f"{shed[0][1]['Retry-After']}", flush=True)
        check(http_json(base, "/v1/models")[2]["models"]["plain"][
            "slots_in_use"] == 0, "serve: slots held after the flood")

        # -- shutdown: SIGTERM with a stream in flight
        stream = {}
        t = threading.Thread(target=sse_client, args=(
            base, "plain", [5, 6, 7], SERVE_DRAIN_TOKENS, stream))
        t.start()
        while not stream.get("arrivals"):
            check(t.is_alive(), f"serve: the drain stream failed {stream}")
            time.sleep(0.005)
        proc.send_signal(15)                    # SIGTERM
        draining = 0
        while t.is_alive():
            try:
                code, _, body = http_json(base, "/readyz", timeout=5)
            except OSError:
                break                           # the port has closed
            if code == 503 and body.get("status") == "draining":
                draining += 1
            time.sleep(0.01)
        t.join(timeout=300)
        rc = proc.wait(timeout=120)
        reader.join(timeout=10)
        check(len(stream.get("tokens", ())) == SERVE_DRAIN_TOKENS
              and stream["events"][-1] == "done",
              f"serve: the in-flight stream was cut: "
              f"{len(stream.get('tokens', ()))} tokens")
        check(draining > 0, "serve: /readyz never answered 503 draining")
        check(rc == 0 and any("drained, exiting" in ln for ln in log),
              f"serve: the server exited {rc}:\n" + "".join(log)[-3000:])
        try:
            socket.create_connection(("127.0.0.1", port), timeout=2).close()
            closed = False
        except OSError:
            closed = True
        check(closed, "serve: the port is still open after exit")
        print(f"serve: SIGTERM with a {SERVE_DRAIN_TOKENS}-token stream in "
              f"flight: /readyz answered 503 draining {draining} times, the "
              f"stream finished, exit code {rc}, 'drained, exiting', port "
              f"closed", flush=True)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def serve_in_child(prompts, budgets, plain):
    """Run :func:`drive_serve` in a child interpreter (``--serve``, with
    ``faulthandler`` on, as ``--windows`` runs), handing it the path
    phase's requests and tokens through a file, and print the child's
    ``serve:`` lines.  Fails unless the child exits 0 and reports the
    drain."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump({"prompts": prompts, "budgets": budgets,
                   "plain": plain}, f)
    try:
        proc = subprocess.run([sys.executable, "-X", "faulthandler",
                               str(Path(__file__).resolve()), "--serve",
                               f.name], capture_output=True, text=True,
                              timeout=900)
    finally:
        os.unlink(f.name)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith(("serve: ", "path: "))]
    for ln in lines:
        print(ln, flush=True)
    check(proc.returncode == 0 and lines
          and lines[-1].startswith("serve: SIGTERM"),
          f"serve: the child exited {proc.returncode}:\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    print(f"serve: the HTTP phase ran in a child process in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def parses_as_json(tokens):
    """``tokens`` read as bytes form a complete JSON document by the JSON
    mode's grammar, and parse; the grammar's number rule is permissive
    (it takes "-E." as a number), so a document that fails to parse must
    parse with every number run replaced by 0."""
    import re
    from incubator_mxnet_tpu_torch.serving.sampling import JsonMaskMachine
    m = JsonMaskMachine([chr(i) for i in range(max(tokens) + 1)])
    if not (all(m.advance(t) for t in tokens) and m.done):
        return False
    text = "".join(chr(t) for t in tokens)
    try:
        json.loads(text)
    except ValueError:
        json.loads(re.sub(r"[-0-9][-+.eE0-9]*", "0", text))
    return True


def drive_features(net, eng):
    """One request of each feature through a ``ContinuousBatcher`` over
    the warmed paged engine, each checked: JSON mode (a complete document
    that parses, served without a burst), ``n = 2`` (the children are the
    solo runs with derived seeds), a stop sequence (trimmed inside a
    burst) and logprobs (one record per token, the greedy token on top,
    the values the full-prefix forward's within ``LOGPROB_TOL``)."""
    from incubator_mxnet_tpu_torch.serving import (ContinuousBatcher,
                                                   SamplingParams)
    from incubator_mxnet_tpu_torch.serving.sampling import \
        derive_candidate_seed

    def serve(prompt, budget, sp):
        bat = ContinuousBatcher(eng)
        try:
            r = bat.submit_async(prompt, budget, sampling=sp)
            if hasattr(r, "results"):
                r.results(300)
            else:
                r.result(300)
            return r, bat.stats()
        finally:
            bat.close()

    t0 = time.perf_counter()
    r, st = serve([1], 24, SamplingParams(temperature=0.9, seed=5,
                                          json_mode=True))
    out = r.result(1)
    check(parses_as_json(out), f"features: JSON mode gave {out}")
    check(st["decode_burst_dispatches"] == 0,
          "features: a JSON-mode request was served by a burst")
    print(f"features: JSON mode: {len(out)} tokens "
          f"{''.join(chr(t) for t in out)!r} in "
          f"{time.perf_counter() - t0:.2f} s, {st['decode_steps']} per-step "
          f"decodes, no burst", flush=True)

    prompt = [int(t) for t in np.random.RandomState(SEED).randint(
        0, eng.vocab_size, 4)]
    r, _ = serve(prompt, 12, SamplingParams(temperature=0.9, seed=99, n=2))
    outs = r.results(1)
    solo = [eng.generate(prompt, 12, sampling=SamplingParams(
        temperature=0.9, seed=derive_candidate_seed(99, i)))
        for i in range(2)]
    check(outs == solo, f"features: n = 2 gave {outs}, solo {solo}")
    print(f"features: n = 2: children {r.request_ids} equal their solo runs "
          f"with derived seeds", flush=True)

    sp = SamplingParams(temperature=0.8, seed=11)
    base = eng.generate(prompt, 16, sampling=sp)
    i = next(i for i in range(3, 14) if all(
        tuple(base[j:j + 2]) != tuple(base[i:i + 2]) for j in range(i)))
    r, st = serve(prompt, 16, SamplingParams(temperature=0.8, seed=11,
                                             stop=(tuple(base[i:i + 2]),)))
    check(r.result(1) == base[:i + 2] and st["stop_trimmed_tokens"] > 0
          and st["decode_burst_dispatches"] > 0,
          f"features: stop gave {r.result(1)}, want {base[:i + 2]}, stats "
          f"{st}")
    print(f"features: stop {tuple(base[i:i + 2])}: {i + 2} of 16 tokens kept, "
          f"{st['stop_trimmed_tokens']} trimmed from a burst", flush=True)

    r, st = serve(prompt, 12, SamplingParams(logprobs=5))
    toks, recs = r.result(1), r.logprobs_out
    check(len(recs) == len(toks) == 12 and all(
        rec["token_ids"][0] == t for rec, t in zip(recs, toks)),
        f"features: logprob records {recs} for tokens {toks}")
    with torch.no_grad():
        lg = net(torch.tensor([prompt + toks[:-1]], device=net.device))
        want = torch.log_softmax(lg[0, len(prompt) - 1:].float(), -1)
    err = max(abs(v - float(want[j, t])) for j, rec in enumerate(recs)
              for t, v in zip(rec["token_ids"], rec["logprobs"]))
    check(err <= LOGPROB_TOL, f"features: logprobs differ by {err}")
    print(f"features: logprobs: {len(recs)} records of 5, the greedy token "
          f"on top, within {err:.3e} of the full-prefix forward (tol "
          f"{LOGPROB_TOL})", flush=True)


# ------------------------------------------------------------ phase 6
def bert_batch(V, B, T, seed=SEED):
    """``bench.py``'s batch (bench.py:183-202): from ``default_rng(seed)``,
    the settling batch it draws first, then ids, zero token types and the
    packed labels (T MLM targets + 1 NSP class, float32)."""
    rng = np.random.default_rng(seed)
    rng.integers(0, V, (B, T))                  # bench.py's settle batch
    ids = rng.integers(0, V, (B, T)).astype(np.int32)
    types = np.zeros((B, T), np.int32)
    labels = np.concatenate([rng.integers(0, V, (B, T)),
                             rng.integers(0, 2, (B, 1))],
                            axis=1).astype(np.float32)
    return ids, types, labels


def drive_training(fa, card, k8_row):
    """BERT-large pretraining steps through ``SPMDTrainer``: 3 steps
    through the eager step body and 3 through the CUDA graph from the
    same seed-0 weights, held equal bit for bit; then ``TRAIN_STEPS``
    timed graph steps in their own launch-count window, and one profiled
    step (host launches, idle share).  Returns the window's counts."""
    from incubator_mxnet_tpu_torch import initializer as init
    from incubator_mxnet_tpu_torch.models import bert as bert_mod
    from incubator_mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
    V, B, T = BERT_VOCAB, TRAIN_B, TRAIN_T
    t0 = time.perf_counter()
    net = bert_mod.BERTForPretrain(bert_mod.bert_large(dropout=0.0),
                                   vocab_size=V)
    net.initialize(init.Normal(0.02), seed=SEED)
    ref_net = copy.deepcopy(net)

    def trainer_of(n):
        return SPMDTrainer(n, bert_mod.BERTPretrainLoss(V), "adam",
                           {"learning_rate": 1e-4},
                           mesh=make_mesh({"data": 1}))

    ref = trainer_of(ref_net)
    trainer = trainer_of(net)
    n_params = sum(p.numel() for p in net.parameters())
    torch.cuda.synchronize()
    print(f"train: bert_large + pretrain heads on {net.device}, "
          f"{n_params} parameters in {len(trainer.params)} leaves, "
          f"Normal(0.02) seed {SEED}, built in "
          f"{time.perf_counter() - t0:.1f} s; B={B} T={T} fp32, Adam lr "
          f"1e-4, mesh {trainer.mesh}", flush=True)
    ids, types, labels = bert_batch(V, B, T)
    batch = (ids, types, labels)

    # the eager step body against the graph, from the same weights
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with ref._eager_steps():
        eager = [ref.step(*batch)]
        start.record()
        eager += [ref.step(*batch) for _ in range(TRAIN_CHECK - 1)]
        end.record()
    end.synchronize()
    eager_ms = start.elapsed_time(end) / (TRAIN_CHECK - 1)
    t0 = time.perf_counter()
    losses = [trainer.step(*batch)]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    losses += [trainer.step(*batch) for _ in range(TRAIN_CHECK - 1)]
    torch.cuda.synchronize()
    check([float(x) for x in losses] == [float(x) for x in eager],
          f"graph losses {[float(x) for x in losses]} != eager "
          f"{[float(x) for x in eager]}")
    for (name, a), b in zip(ref.params.items(), trainer.params.values()):
        check(torch.equal(a, b), f"graph step: parameter {name} differs "
              f"from the eager body's after {TRAIN_CHECK} steps")
    print(f"train: {TRAIN_CHECK} steps through the graph equal "
          f"{TRAIN_CHECK} through the eager body bit for bit (losses and "
          f"all {len(trainer.params)} parameters); first step (eager, on a "
          f"side stream) + capture {first_s:.2f} s, graph pool "
          f"{trainer.graph_pool_bytes() / 2 ** 20:.1f} MiB; eager body "
          f"{eager_ms:.2f} ms per step [{card}]", flush=True)
    del ref, ref_net, eager
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()                 # --- the training path
    start.record()
    for _ in range(TRAIN_STEPS):
        losses.append(trainer.step(*batch))
    end.record()
    end.synchronize()
    counts = dict(fa.launch_counts)          # --- end of the training path
    ms = start.elapsed_time(end) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved = torch.cuda.memory_reserved() / 2 ** 30
    prof, _ = profile_window(lambda: None, lambda: trainer.step(*batch))
    with torch.no_grad():
        dev = net.device
        after = float(bert_mod.BERTPretrainLoss(V)(
            *net(torch.from_numpy(ids).to(dev),
                 torch.from_numpy(types).to(dev)),
            torch.from_numpy(labels).to(dev)))
    losses = [float(x) for x in losses]
    print(f"train: losses {[round(x, 5) for x in losses]}; after the "
          f"{len(losses) + 4} steps {after:.5f}", flush=True)
    print(f"train: {ms:.2f} ms per step, {B * 1e3 / ms:.2f} samples/s over "
          f"{TRAIN_STEPS} graph steps (B={B} T={T}, CUDA events); "
          f"one profiled step: wall {prof['wall_ms']:.2f} ms (median of "
          f"3), device {prof['device_ms']:.2f} ms in "
          f"{prof['device_ops']} kernels and copies, "
          f"{prof['host_launches']} host launches, idle share "
          f"{prof['idle_share']:.3f}; peak {peak:.2f} GiB allocated, "
          f"{reserved:.2f} GiB reserved, graph pool "
          f"{trainer.graph_pool_bytes() / 2 ** 30:.2f} GiB [{card}]",
          flush=True)
    print(f"train: K8 multi_tensor_adam {k8_row['ms']:.4f} ms per update "
          f"against its bound {k8_row['bound_ms']:.4f} ms and "
          f"torch.optim.Adam(fused=True)'s {k8_row['library_ms']:.4f} ms; "
          f"the per-leaf plain update {k8_row['plain_ms']:.4f} ms [{card}]",
          flush=True)
    print(f"train: launches in the {TRAIN_STEPS}-step window {counts}",
          flush=True)
    check(all(math.isfinite(x) for x in losses + [after]),
          "a non-finite loss")
    check(after < losses[0], f"loss did not fall: {losses[0]} -> {after}")
    per_step = {"flash_fwd": BERT_LAYERS, "flash_bwd_dq": BERT_LAYERS,
                "flash_bwd_dkv": BERT_LAYERS, "multi_tensor_adam": 1}
    for name, n in counts.items():
        expect = per_step.get(name, 0) * TRAIN_STEPS
        check(n == expect, f"training path: kernel {name} launched {n} "
              f"times, expected {expect}")
    check(prof["host_launches"] <= 8, f"a graph step made "
          f"{prof['host_launches']} host launches")
    del trainer, net
    torch.cuda.empty_cache()
    return counts


def check_cell_grads(fa, dev):
    """One full-width ``TransformerEncoderCell`` (1024 units, 16 heads,
    FFN 4096) at B=32, T=128 with ragged valid lengths: input and
    parameter gradients through the kernels (K1 with lse, K6, K7) against
    the same cell with the plain attention on the card."""
    from incubator_mxnet_tpu_torch import initializer as init
    from incubator_mxnet_tpu_torch.models import bert as bert_mod
    B, T, C = TRAIN_B, TRAIN_T, 1024
    cell = bert_mod.TransformerEncoderCell(C, 4096, BERT_HEADS, device=dev)
    init.initialize(cell, init.Normal(0.02), SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(B, T, C, device=dev, generator=gen)
    dy = torch.randn(B, T, C, device=dev, generator=gen)
    valid = torch.randint(1, T + 1, (B,), device=dev, generator=gen)
    mask = (torch.arange(T, device=dev)[None] < valid[:, None]).float()
    params = list(cell.parameters())

    def grads():
        xi = x.clone().requires_grad_()
        return torch.autograd.grad(cell(xi, mask), [xi] + params, dy)

    fa.reset_launch_counts()
    got = grads()
    torch.cuda.synchronize()
    launched = (fa.launch_counts["flash_fwd"],
                fa.launch_counts["flash_bwd_dq"],
                fa.launch_counts["flash_bwd_dkv"])
    real = bert_mod.flash_attention
    bert_mod.flash_attention = (
        lambda q, k, v, scale=None, causal=False, mask=None:
        fa._plain_flash_attention(q, k, v, scale, causal, mask))
    try:
        want = grads()
    finally:
        bert_mod.flash_attention = real
    worst = 0.0
    names = ["x"] + [n for n, _ in cell.named_parameters()]
    top = max(float(b.abs().max()) for b in want)
    for n, a, b in zip(names, got, want):
        if n == "attention.key.bias":
            # zero in exact arithmetic (the softmax over keys ignores a
            # shift shared by every key): both must be ~0 against the
            # cell's largest gradient
            small = max(float(a.abs().max()), float(b.abs().max())) / top
            check(small <= CELL_TOL, f"cell gradient {n}: {small} of the "
                  f"largest gradient, expected ~0")
            continue
        rel = max_err(a, b) / max(float(b.abs().max()), 1e-30)
        check(rel <= CELL_TOL, f"cell gradient {n}: relative error {rel} > "
              f"{CELL_TOL}")
        worst = max(worst, rel)
    check(launched == (1, 1, 1), f"cell: launches {launched}, expected one "
          "each of K1, K6, K7")
    print(f"train: full-width TransformerEncoderCell (B={B} T={T} C={C}, 16 "
          f"heads, valid lengths {valid.min().item()}..{valid.max().item()})"
          f": {len(names)} gradients through K1/K6/K7 agree with the plain "
          f"attention's to {worst:.3e} of each one's largest value (tol "
          f"{CELL_TOL})", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="build and check the kernels; skip the path")
    ap.add_argument("--windows", action="store_true",
                    help="only measure the serving windows (the full run "
                         "does this in a child process)")
    ap.add_argument("--serve", metavar="REF.json",
                    help="only run the HTTP phase against the path phase's "
                         "requests and tokens in REF.json (the full run "
                         "does this in a child process)")
    args = ap.parse_args()
    faulthandler.enable()       # a crash in native code prints the stack
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke runs only "
                         "on a GPU")
    from incubator_mxnet_tpu_torch.kernels import _build
    # the module (its package exports a function of the same name)
    fa = importlib.import_module(
        "incubator_mxnet_tpu_torch.kernels.flash_attention")

    global CARD
    card = CARD = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.windows:
        drive_windows(card)
        return                               # a measurement, no result
    if args.serve:
        drive_serve(card, args.serve)
        return                               # a phase, no result

    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall", flush=True)
    for name, r in report.items():
        print(f"build: {name}: {r['seconds']:.1f} s", flush=True)
        for line in r["ptxas"]:
            print(f"build:   {line}", flush=True)

    rng = np.random.RandomState(SEED)
    torch.manual_seed(SEED)
    rows = [check_k1(fa, dev, rng)] + check_k2_k3(fa, dev, rng) \
        + check_k4_k5(fa, dev, rng)
    e_lse, bwd_rows = check_k6_k7(fa, dev, rng)
    rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"], e_lse)
    rows += bwd_rows
    k8_row = check_k8(fa, dev)
    rows.append(k8_row)
    for r in rows:
        print(f"time: {r['name']} ({r['shape']}): {r['ms']:.4f} ms on the "
              f"card ({r['eager_ms']:.4f} ms per eager call, host "
              f"included), bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
              f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']} ms "
              f"[{card}]", flush=True)

    # each kernel's launches on the path it serves: K1 and K2 on the paged
    # main path, K3 on the dense engine's run, K4 on the paged spec path,
    # K5 on the dense spec run, K6, K7 and K8 on the training path
    launches = {r["name"]: 0 for r in rows}
    if not args.kernels:
        counts, dense_counts, net, eng, prompts, budgets, plain = \
            drive_path(fa)
        spec, dense_spec = drive_spec_path(fa, net, prompts, budgets, plain)
        del net, eng
        torch.cuda.empty_cache()
        windows_in_child()
        serve_in_child(prompts, budgets, plain)
        train = drive_training(fa, card, k8_row)
        check_cell_grads(fa, dev)
        launches = {"flash_fwd": counts["flash_fwd"],
                    "paged_decode": counts["paged_decode"],
                    "decode": dense_counts["decode"],
                    "paged_verify": spec["paged_verify"],
                    "verify": dense_spec["verify"],
                    "flash_bwd_dq": train["flash_bwd_dq"],
                    "flash_bwd_dkv": train["flash_bwd_dkv"],
                    "multi_tensor_adam": train["multi_tensor_adam"]}
    kernels = [{"name": r["name"], "route": "cuda", "source": r["source"],
                "replaces": r["replaces"], "launches": launches[r["name"]],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
               for r in rows]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    if args.kernels:
        return                               # no path run: no result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

"""Decoder-only causal language model, GPT-2 style (counterpart of
``incubator_mxnet_tpu/models/gpt.py``).

Pre-LN blocks whose self-attention is :func:`.bert._sdpa` with the causal
mask (kernel K1 on the card), learned position embeddings, and a tied LM
head (logits through the token-embedding matrix).  ``generate`` keeps the
JAX package's two paths: ``use_cache=True`` primes a per-layer KV cache in
one full-prefix pass and then steps one position at a time;
``use_cache=False`` re-runs the whole prefix every step and is the
oracle.  Sampling draws from an explicit ``torch.Generator``."""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..context import resolve_device
from ..gluon.nn import (Dropout, Embedding, HybridBlock,
                        HybridSequential, LayerNorm)
from .bert import MultiHeadAttention, PositionwiseFFN, _sdpa, cached_step_attn

__all__ = ["GPTCell", "GPTModel", "gpt_tiny", "gpt2_124m"]


class GPTCell(HybridBlock):
    """Pre-LN decoder block: x + attn(ln1(x)), then x + ffn(ln2(x))."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.ln1 = LayerNorm(units, device=device)
            self.attention = MultiHeadAttention(units, num_heads, dropout,
                                                causal=True, device=device)
            self.ln2 = LayerNorm(units, device=device)
            self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                       device=device)

    def forward(self, x):
        x = x + self.attention(self.ln1(x))
        return x + self.ffn(self.ln2(x))

    def prime(self, x):
        """Full-prefix forward that also returns this layer's K/V
        projections (B, T, C) — fills a generation cache in one pass."""
        at = self.attention
        h = self.ln1(x)
        q, k, v = at.query(h), at.key(h), at.value(h)
        out = _sdpa(q, k, v, at._num_heads, causal=True)
        x = x + at.dropout(at.proj(out))
        return x + self.ffn(self.ln2(x)), k, v

    def step(self, x, cache_k, cache_v, t):
        """One position: x (B, 1, C) at position ``t``; cache_k/v
        (B, Tmax, C) hold positions < t and get position t written in
        place.  Returns (y (B, 1, C), cache_k, cache_v)."""
        at = self.attention
        h = self.ln1(x)
        q, k_new, v_new = at.query(h), at.key(h), at.value(h)
        out, ck, cv = cached_step_attn(q, k_new, v_new, cache_k, cache_v, t,
                                       at._num_heads)
        out = x + at.dropout(at.proj(out))
        return out + self.ffn(self.ln2(out)), ck, cv


def _lm_logits(x, w):
    """The tied head: logits = x @ E^T."""
    return torch.matmul(x, w.t())


class GPTModel(HybridBlock):
    """Token + learned position embeddings -> N GPTCells -> final LN ->
    tied LM head.  Parameters are created on ``device`` (default
    ``cuda:0``; ``device='cpu'`` for the CPU) and hold zeros until
    :meth:`initialize` or :func:`..convert.load_jax_params` fills them."""

    def __init__(self, vocab_size, units=128, hidden_size=512,
                 num_layers=2, num_heads=2, max_length=256, dropout=0.1,
                 moe_experts=0, device=None, **kwargs):
        super().__init__(**kwargs)
        if int(moe_experts) > 0:
            raise MXNetError("MoE cells are not ported yet (moe_experts=0)")
        dev = resolve_device(device)
        self._vocab_size = int(vocab_size)
        self._units = int(units)
        self._max_length = int(max_length)
        with self.name_scope():
            self.embed = Embedding(vocab_size, units, device=dev)
            self.pos_embed = Embedding(max_length, units, device=dev)
            self.drop = Dropout(dropout)
            self.cells = HybridSequential()
            for _ in range(num_layers):
                self.cells.add(GPTCell(units, hidden_size, num_heads,
                                       dropout, device=dev))
            self.ln_f = LayerNorm(units, device=dev)
        # inference mode by default: MXNet applies dropout only while
        # training (autograd.record), so a fresh model does not drop
        self.eval()

    # -- helpers -------------------------------------------------------
    def _embed_at(self, ids, offset=0):
        T = ids.shape[1]
        pos = torch.arange(offset, offset + T, device=ids.device)
        return self.drop(self.embed(ids) + self.pos_embed(pos)[None])

    def _project(self, x):
        return _lm_logits(x, self.embed.weight)

    def forward(self, ids):
        if ids.shape[1] > self._max_length:
            raise MXNetError(
                f"sequence length {ids.shape[1]} exceeds max_length "
                f"{self._max_length}")
        x = self._embed_at(ids)
        for cell in self.cells:
            x = cell(x)
        return self._project(self.ln_f(x))

    # -- generation ----------------------------------------------------
    def generate(self, ids, max_new_tokens=32, temperature=0.0, top_k=0,
                 top_p=0.0, use_cache=True, seed=None, generator=None):
        """Continue prompt ``ids`` (B, Tp) int.  ``temperature == 0`` is
        greedy (argmax, ties to the first index); otherwise softmax
        sampling at that temperature, restricted to the ``top_k`` highest
        logits and/or the nucleus of mass ``top_p`` (top-k first, the
        top-1 token always survives), drawn from ``generator`` (or a
        ``torch.Generator`` seeded with ``seed``).  Returns (B, Tp +
        max_new_tokens) int64 tokens."""
        ids = torch.as_tensor(ids, device=self.device).long()
        B, Tp = ids.shape
        total = Tp + int(max_new_tokens)
        if total > self._max_length:
            raise MXNetError(
                f"prompt {Tp} + {max_new_tokens} new tokens exceeds "
                f"max_length {self._max_length}")
        if max_new_tokens < 0:
            raise MXNetError(
                f"max_new_tokens={max_new_tokens} is negative; use 0 for "
                "no-op generation")
        if max_new_tokens == 0:
            return ids
        if not 0.0 <= float(top_p) <= 1.0:
            raise MXNetError(f"top_p={top_p} outside [0, 1]")
        if generator is None and temperature > 0.0:
            generator = torch.Generator(device=self.device)
            if seed is None:
                generator.seed()
            else:
                generator.manual_seed(int(seed))

        def pick(logits):
            return _sample(logits, temperature, top_k, top_p, generator)

        with torch.no_grad():
            if use_cache:
                return self._generate_cached(ids, int(max_new_tokens), pick)
            return self._generate_full(ids, int(max_new_tokens), pick)

    def _generate_full(self, ids, n_new, pick):
        """Oracle: the whole prefix re-runs every step."""
        toks = ids
        for _ in range(n_new):
            nxt = pick(self.forward(toks)[:, -1])
            toks = torch.cat([toks, nxt[:, None]], dim=1)
        return toks

    def _generate_cached(self, ids, n_new, pick):
        B, Tp = ids.shape
        total = Tp + n_new
        x = self._embed_at(ids)
        caches = []
        for cell in self.cells:
            x, k, v = cell.prime(x)
            ck = torch.zeros(B, total, self._units, device=x.device,
                             dtype=k.dtype)
            cv = torch.zeros_like(ck)
            ck[:, :Tp] = k
            cv[:, :Tp] = v
            caches.append((ck, cv))
        out = [ids, pick(self._project(self.ln_f(x))[:, -1])[:, None]]
        for t in range(Tp, total - 1):
            xn = self.embed(out[-1]) + self.pos_embed.weight[t][None, None]
            for l, cell in enumerate(self.cells):
                xn, ck, cv = cell.step(xn, caches[l][0], caches[l][1], t)
                caches[l] = (ck, cv)
            logits = self._project(self.ln_f(xn))[:, 0]
            out.append(pick(logits)[:, None])
        return torch.cat(out, dim=1)


def _sample(logits, temperature, top_k, top_p, generator):
    """Next token per row from (B, V) logits (``models/gpt.py``'s
    ``_sample_fn`` conventions)."""
    lf = logits.float()
    if temperature <= 0.0:
        return torch.argmax(lf, dim=-1)
    lf = lf / temperature
    V = lf.shape[-1]
    k = min(int(top_k), V) if top_k else 0
    if (0 < k < V) or 0.0 < top_p < 1.0:
        srt = torch.sort(lf, dim=-1, descending=True).values
    if 0 < k < V:
        kth = srt[:, k - 1:k]
        lf = lf.masked_fill(lf < kth, float("-inf"))
        srt = srt.masked_fill(torch.arange(V, device=lf.device) >= k,
                              float("-inf"))
    if 0.0 < top_p < 1.0:
        probs = torch.softmax(srt, dim=-1)
        before = torch.cumsum(probs, dim=-1) - probs
        cutoff = torch.where(before < top_p, srt,
                             torch.full_like(srt, float("inf"))).amin(
                                 dim=-1, keepdim=True)
        lf = lf.masked_fill(lf < cutoff, float("-inf"))
    return torch.multinomial(torch.softmax(lf, dim=-1), 1,
                             generator=generator)[:, 0]


def gpt_tiny(vocab_size=512, **kwargs):
    kwargs.setdefault("units", 64)
    kwargs.setdefault("hidden_size", 128)
    kwargs.setdefault("num_layers", 2)
    kwargs.setdefault("num_heads", 2)
    kwargs.setdefault("max_length", 128)
    return GPTModel(vocab_size, **kwargs)


def gpt2_124m(vocab_size=50257, **kwargs):
    """GPT-2 small (124M): 12 layers, 768 units, 12 heads, ctx 1024."""
    kwargs.setdefault("units", 768)
    kwargs.setdefault("hidden_size", 3072)
    kwargs.setdefault("num_layers", 12)
    kwargs.setdefault("num_heads", 12)
    kwargs.setdefault("max_length", 1024)
    return GPTModel(vocab_size, **kwargs)

"""Autoregressive generation over a preallocated KV cache (counterpart of
``incubator_mxnet_tpu/serving/engine.py``'s :class:`GenerationEngine`).

The JAX engine is a closed set of jitted programs that take the cache
donated and return the updated copy.  PyTorch runs eagerly, so there is
no program set here: each entry point is plain tensor code, and the
donated cache becomes an in-place update of the pool tensors
(``index_put_`` / slice assignment).  The kernels are the port's own:
prefill self-attention goes through :func:`..models.bert._sdpa` (kernel
K1 on the card), decode through :func:`paged_decode_attention` (K2) or,
in the dense layout, :func:`decode_attention` (K3), and the
speculative-decode verify through :func:`paged_verify_decode_attention`
(K4) or :func:`verify_decode_attention` (K5).

Layouts (fp32, as in the JAX engine):

* **paged** (default): per layer a block pool ``(num_blocks, H,
  block_size, D)`` managed by :class:`~.kvcache.BlockPool`; each slot
  addresses its K/V through a row of an int32 block table padded with
  the null block 0.  A prompt whose leading full blocks are in the prefix
  cache prefills only its suffix.
* **dense**: per layer ``(max_slots, H, max_len, D)``; the parity oracle
  for paged.

JAX clamps out-of-range gathers and ``dynamic_update_slice`` starts where
torch raises; the engine reproduces the clamps it relies on explicitly
(the null-block redirect of :meth:`_scatter_strips`, the position clamp
of the prefix-hit prefill, the table-column clamp of decode, the dropped
or null-block verify writes past ``max_len``) and checks the host inputs
it is given."""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as _np
import torch

from ..base import MXNetError, getenv_bool, getenv_int
from ..kernels.flash_attention import (NEG, decode_attention,
                                       paged_decode_attention,
                                       paged_verify_decode_attention,
                                       verify_decode_attention)
from .kvcache import BlockPool, blocks_for
from .sampling import (SamplingParams, root_key, sample_tokens, step_keys,
                       topn_logprobs)

__all__ = ["GenerationEngine", "derive_prefill_buckets"]


def derive_prefill_buckets(max_len: int, smallest: int = 8):
    """Prompt-length buckets: powers of two from ``smallest`` up to (and
    always including) ``max_len`` — ``derive_prefill_buckets(128) ==
    (8, 16, 32, 64, 128)``."""
    m = int(max_len)
    if m < 1:
        raise MXNetError(f"max_len must be >= 1, got {m}")
    out, b = [], min(int(smallest), m)
    while b < m:
        out.append(b)
        b *= 2
    out.append(m)
    return tuple(out)


class GenerationEngine:
    """A GPT-style model served from ``max_slots`` slots over one KV
    cache.

    * ``prefill(tokens, slot)`` runs the prompt (zero-padded to its
      prompt-length bucket) and returns the first generated token;
    * ``decode(last_tokens, positions)`` advances EVERY slot one token;
    * ``decode_burst(...)`` advances every slot up to ``scan_steps``
      tokens with a per-slot done mask kept on the device, so the k steps
      run without a host round-trip between them;
    * with a draft engine attached (:meth:`attach_draft`),
      ``spec_step(...)`` lets the draft propose ``spec_k`` tokens per slot
      and scores all ``spec_k + 1`` positions in one :meth:`verify`.

    Free slots ride along in decode (their writes land in the null block,
    or in their own dense row at position 0).  The cache is single-writer:
    only one thread (the continuous batcher's worker) dispatches.
    Constructor arguments and their environment variables are the JAX
    engine's."""

    def __init__(self, block, *, name: Optional[str] = None,
                 max_slots: Optional[int] = None,
                 max_len: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 paged: Optional[bool] = None,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 scan_steps: Optional[int] = None,
                 logprobs_topn: Optional[int] = None):
        for attr in ("embed", "pos_embed", "cells", "ln_f", "_units",
                     "_max_length"):
            if not hasattr(block, attr):
                raise MXNetError(
                    "GenerationEngine needs a GPT-style block (embed/"
                    f"pos_embed/cells/ln_f); {type(block).__name__} has "
                    f"no {attr!r}")
        self.block = block
        self.name = str(name or "gpt")
        self.device = block.embed.weight.device
        self.max_slots = int(max_slots
                             or getenv_int("MXNET_GEN_MAX_SLOTS", 8))
        if self.max_slots < 1:
            raise MXNetError(f"max_slots must be >= 1: {self.max_slots}")
        blk_len = int(block._max_length)
        self.max_len = min(int(max_len
                               or getenv_int("MXNET_GEN_MAX_LEN", blk_len)),
                           blk_len)
        if self.max_len < 2:
            raise MXNetError(f"max_len must be >= 2: {self.max_len}")
        self._cells = list(block.cells)
        self.num_layers = len(self._cells)
        self.num_heads = int(self._cells[0].attention._num_heads)
        self.head_dim = int(block._units) // self.num_heads
        if prefill_buckets:
            self.prefill_buckets = tuple(sorted(
                {int(b) for b in prefill_buckets}))
            if self.prefill_buckets[0] < 1 \
                    or self.prefill_buckets[-1] > self.max_len:
                raise MXNetError(
                    f"prefill buckets must be in [1, {self.max_len}]: "
                    f"{self.prefill_buckets}")
        else:
            self.prefill_buckets = derive_prefill_buckets(self.max_len)
        self.paged = bool(getenv_bool("MXNET_KV_PAGED", True)
                          if paged is None else paged)
        self.block_size = int(block_size
                              or getenv_int("MXNET_KV_BLOCK_SIZE", 16))
        if self.block_size < 1:
            raise MXNetError(f"block_size must be >= 1: {self.block_size}")
        self.prefix_cache_enabled = self.paged and bool(
            getenv_bool("MXNET_KV_PREFIX_CACHE", True)
            if prefix_cache is None else prefix_cache)
        if self.paged:
            self.max_blocks_per_slot = -(-self.max_len // self.block_size)
            nb = int(num_blocks or getenv_int("MXNET_KV_NUM_BLOCKS", 0)) \
                or 1 + self.max_slots * self.max_blocks_per_slot
            if nb < 1 + self.max_blocks_per_slot:
                raise MXNetError(
                    f"num_blocks {nb} cannot hold even one max_len slot "
                    f"({self.max_blocks_per_slot} blocks + null block)")
            self.num_blocks = nb
            self.pool = BlockPool(nb, self.block_size,
                                  prefix_cache=self.prefix_cache_enabled,
                                  model=self.name)
        else:
            self.max_blocks_per_slot = 0
            self.num_blocks = 0
            self.pool = None
        self._warming = False
        self.scan_steps = int(scan_steps if scan_steps is not None
                              else getenv_int("MXNET_DECODE_SCAN_STEPS",
                                              8))
        if self.scan_steps < 0:
            raise MXNetError(
                f"scan_steps must be >= 0: {self.scan_steps}")
        self.vocab_size = int(block._vocab_size)
        self.logprobs_topn = max(0, min(
            int(logprobs_topn if logprobs_topn is not None
                else getenv_int("MXNET_SAMPLING_LOGPROBS_TOPN", 5)),
            self.vocab_size))
        # per-slot sampling state on the host, mirrored to the device
        # lazily (invalidated on every slot update)
        self._samp_temp = _np.zeros(self.max_slots, _np.float32)
        self._samp_topk = _np.zeros(self.max_slots, _np.int64)
        self._samp_topp = _np.ones(self.max_slots, _np.float32)
        self._samp_bias = _np.zeros((self.max_slots, self.vocab_size),
                                    _np.float32)
        self._samp_keys = _np.zeros((self.max_slots, 2), _np.int64)
        self._samp_logprobs = _np.zeros(self.max_slots, bool)
        self._samp_dev = None
        self._last_logprobs = None
        self._last_verify_logprobs = None
        # speculative decoding: a draft engine attached by attach_draft
        # proposes spec_k tokens per slot for one verify to score
        self.draft: Optional["GenerationEngine"] = None
        self.spec_k = 0
        self._cache: Tuple[torch.Tensor, ...] = ()
        self.reset()

    # -- sampling plane --------------------------------------------------
    def set_slot_sampling(self, slot: int, params=None) -> None:
        """Install a request's :class:`~.sampling.SamplingParams` into
        ``slot`` before its prefill (None: greedy).  Cascades to an
        attached draft, so its proposals are drawn from the same key
        stream (the coupling that speculative sampling needs)."""
        s = int(slot)
        if not 0 <= s < self.max_slots:
            raise MXNetError(f"{self.name}: slot {s} out of range")
        p = params if params is not None else SamplingParams()
        self._samp_temp[s] = float(p.temperature)
        self._samp_topk[s] = int(p.top_k)
        self._samp_topp[s] = float(p.top_p)
        row = _np.zeros(self.vocab_size, _np.float32)
        if p.logit_bias:
            for t, b in p.logit_bias.items():
                if 0 <= int(t) < self.vocab_size:
                    row[int(t)] = float(b)
        self._samp_bias[s] = row
        self._samp_keys[s] = root_key(p.seed or 0)
        self._samp_logprobs[s] = int(p.logprobs) > 0
        self._samp_dev = None
        if self.draft is not None:
            self.draft.set_slot_sampling(s, params)

    def update_slot_bias(self, slot: int, row) -> None:
        """Replace ``slot``'s logit-bias row for the next dispatch
        (cascades to an attached draft)."""
        s = int(slot)
        self._samp_bias[s] = _np.asarray(row, _np.float32).reshape(
            self.vocab_size)
        self._samp_dev = None
        if self.draft is not None:
            self.draft.update_slot_bias(s, row)

    def last_logprobs(self):
        """Host ``(values, token ids)`` of the most recent decode, (S, N),
        or burst, (k, S, N); None when ``logprobs_topn`` is 0 or no slot
        of that dispatch asked for logprobs (``SamplingParams.logprobs``),
        so a dispatch nobody reads from computes none.  The copy to the
        host is made here, on first read."""
        lp = self._last_logprobs
        if lp is not None and isinstance(lp[0], torch.Tensor):
            lp = self._last_logprobs = tuple(a.cpu().numpy() for a in lp)
        return lp

    def last_verify_logprobs(self):
        """Host ``(values, token ids)`` of the most recent :meth:`verify`,
        each (S, Q, N); None when no slot of it asked for logprobs."""
        lp = self._last_verify_logprobs
        if lp is not None and isinstance(lp[0], torch.Tensor):
            lp = self._last_verify_logprobs = tuple(a.cpu().numpy()
                                                    for a in lp)
        return lp

    def _samp_tensors(self):
        if self._samp_dev is None:
            dev = self.device
            self._samp_dev = tuple(
                torch.from_numpy(a).to(dev)
                for a in (self._samp_temp, self._samp_topk, self._samp_topp,
                          self._samp_bias, self._samp_keys))
        return self._samp_dev

    def _sample(self, lg, key_idx, slots=None):
        """Next token for each row of ``lg`` (R, V), the rows being
        ``slots`` (default: all slots; a slot may repeat); ``key_idx``
        (R,) int64 the positions the sampled tokens will occupy.  Returns
        (tokens (R,) int64, logprobs pair or None), both on the device."""
        temps, topks, topps, biases, roots = self._samp_tensors()
        want = self._samp_logprobs
        if slots is not None:
            sel = torch.as_tensor(slots, device=lg.device)
            temps, topks, topps = temps[sel], topks[sel], topps[sel]
            biases, roots = biases[sel], roots[sel]
            want = want[list(slots)]
        nxt = sample_tokens(lg, temps, topks, topps, biases,
                            step_keys(roots, key_idx))
        lp = topn_logprobs(lg, biases, self.logprobs_topn) \
            if self.logprobs_topn and want.any() else None
        return nxt, lp

    # -- cache lifecycle -------------------------------------------------
    def reset(self):
        """Zero the cache: all slots free.  Paged mode also rewipes the
        block pool, every block table and the prefix cache — cached K/V
        must never outlive the params that computed it.  Cascades to an
        attached draft."""
        if self.draft is not None:
            self.draft.reset()
        self._samp_dev = None
        if self.paged:
            shape = (self.num_blocks, self.num_heads, self.block_size,
                     self.head_dim)
        else:
            shape = (self.max_slots, self.num_heads, self.max_len,
                     self.head_dim)
        if self._cache:
            for c in self._cache:
                c.zero_()
        else:
            self._cache = tuple(
                torch.zeros(shape, dtype=torch.float32, device=self.device)
                for _ in range(2 * self.num_layers))
        if self.paged:
            self.pool.reset()
            self.pool.block_bytes = self.cache_bytes // self.num_blocks
            self._slot_blocks: List[List[int]] = [
                [] for _ in range(self.max_slots)]
            self._tables = _np.zeros(
                (self.max_slots, self.max_blocks_per_slot), _np.int32)
            self._tables_dev = None

    @property
    def cache_bytes(self) -> int:
        return sum(c.numel() * c.element_size() for c in self._cache)

    def prefill_bucket_for(self, n: int) -> Optional[int]:
        for b in self.prefill_buckets:
            if b >= int(n):
                return b
        return None

    def _tables_tensor(self) -> torch.Tensor:
        if self._tables_dev is None:
            self._tables_dev = torch.from_numpy(self._tables).to(
                self.device)
        return self._tables_dev

    def _ids(self, a) -> torch.Tensor:
        return torch.as_tensor(_np.asarray(a, _np.int64),
                               device=self.device)

    # -- prefill ---------------------------------------------------------
    def _first_token(self, last, first_pos: int, slot: int) -> int:
        """Sample the first generated token from the prompt's last logits
        ``last`` (V,), keyed at ``first_pos``."""
        nxt, _ = self._sample(last[None], self._ids([first_pos]), [slot])
        return int(nxt[0])

    def _prime(self, tokens: torch.Tensor, n: int):
        """Full-prefix forward over ``tokens`` (1, Tb): the last valid
        row's logits (V,) and every layer's K/V as (H, Tb, D)."""
        H, D = self.num_heads, self.head_dim
        Tb = tokens.shape[1]
        x = self.block._embed_at(tokens)
        ks, vs = [], []
        for cell in self._cells:
            x, k, v = cell.prime(x)
            ks.append(k.reshape(Tb, H, D).transpose(0, 1))
            vs.append(v.reshape(Tb, H, D).transpose(0, 1))
        last = self.block._project(self.block.ln_f(x[:, n - 1:n]))[0, 0]
        return last, ks, vs

    def _scatter_strips(self, pool, strips, row, j0: int):
        """Write ``strips`` (H, W, D) — logical positions ``[j0 * bs, j0 *
        bs + W)`` of a slot — into the blocks its table ``row`` names,
        in place.  Block indices past the table redirect to the null
        block 0 (JAX clamps them into a harmless sink); a last strip
        narrower than ``block_size`` fills only the front of its block."""
        bs = self.block_size
        H, W, D = strips.shape
        MB = self.max_blocks_per_slot
        idx = [int(row[j0 + j]) if j0 + j < MB else 0
               for j in range(-(-W // bs))]
        full = W // bs
        if full:
            blocks = torch.as_tensor(idx[:full], device=pool.device)
            pool[blocks] = strips[:, :full * bs].reshape(
                H, full, bs, D).transpose(0, 1)
        if W % bs:
            pool[idx[-1], :, :W % bs] = strips[:, full * bs:]

    @torch.no_grad()
    def prefill(self, tokens, slot: int,
                reserve_tokens: Optional[int] = None) -> int:
        """Admit a prompt into ``slot``: pad it to its bucket, run it, and
        return the FIRST generated token.  The slot's write head is then
        at ``len(tokens)``.

        Paged mode first reserves the slot's blocks for ``reserve_tokens``
        positions (default ``max_len``: prompt + budget), so decode never
        allocates; a prefix-cache hit runs only the unshared suffix.

        With a draft attached, the draft is prefilled first with the same
        prompt into the same slot, so its write head tracks this one (its
        first token is discarded: only this engine's tokens are emitted),
        and both engines reserve ``spec_k`` more positions: a verify near
        the budget edge writes up to ``spec_k`` positions past the last
        consumed token.  A failed prefill frees the draft's slot too."""
        toks = _np.asarray(tokens, _np.int32).reshape(-1)
        n = int(toks.shape[0])
        slot = int(slot)
        if not 0 <= slot < self.max_slots:
            raise MXNetError(f"{self.name}: slot {slot} out of range "
                             f"(max_slots {self.max_slots})")
        if n < 1:
            raise MXNetError(f"{self.name}: empty prompt")
        if n > self.max_len - 1:
            raise MXNetError(
                f"{self.name}: prompt length {n} leaves no room to "
                f"generate (max_len {self.max_len})")
        if int(toks.min()) < 0 or int(toks.max()) >= self.vocab_size:
            raise MXNetError(f"{self.name}: token ids outside the vocab "
                             f"[0, {self.vocab_size})")
        if self.draft is None:
            return self._prefill_own(toks, n, slot, reserve_tokens)
        self.draft._warming = self._warming
        self.draft.prefill(toks, slot, reserve_tokens=int(
            reserve_tokens or self.max_len) + self.spec_k)
        try:
            return self._prefill_own(toks, n, slot, reserve_tokens)
        except Exception:
            self.draft.release_slot(slot)
            raise

    def _prefill_own(self, toks, n: int, slot: int, reserve_tokens) -> int:
        """:meth:`prefill` of this engine alone, on checked inputs."""
        if not self.paged:
            bucket = self.prefill_bucket_for(n)
            padded = _np.zeros((1, bucket), _np.int64)
            padded[0, :n] = toks
            last, ks, vs = self._prime(self._ids(padded), n)
            for l in range(self.num_layers):
                # JAX donates the cache to a dynamic_update_slice at
                # (slot, 0, 0, 0); here the slot's rows are overwritten
                # in place
                self._cache[l][slot, :, :bucket] = ks[l]
                self._cache[self.num_layers + l][slot, :, :bucket] = vs[l]
            return self._first_token(last, n, slot)
        if self._slot_blocks[slot]:
            self._release_blocks(slot)
        reserve = int(reserve_tokens or self.max_len) \
            + (self.spec_k if self.draft is not None else 0)
        reserve = max(n + 1, min(reserve, self.max_len))
        table, m = self.pool.allocate(toks, n, reserve,
                                      share=not self._warming)
        self._slot_blocks[slot] = table
        row = _np.zeros(self.max_blocks_per_slot, _np.int32)
        row[:len(table)] = table
        self._tables[slot] = row
        self._tables_dev = None
        try:
            if m == 0:
                return self._prefill_miss(toks, n, row, slot)
            return self._prefill_hit(toks[m:], m, row, slot)
        except Exception:
            # the fresh blocks never got their K/V, but allocate()
            # already registered the full ones in the prefix cache:
            # unregister them so a later same-prefix request prefills
            # cold instead of hitting garbage
            self.pool.invalidate(table[m // self.block_size:])
            self.release_slot(slot)
            raise

    def _prefill_miss(self, toks, n: int, row, slot: int) -> int:
        """Prefix-cache miss: the dense prefill body with the slot's K/V
        scattered into the blocks of its table ``row``."""
        bucket = self.prefill_bucket_for(n)
        padded = _np.zeros((1, bucket), _np.int64)
        padded[0, :n] = toks
        last, ks, vs = self._prime(self._ids(padded), n)
        L = self.num_layers
        for l in range(L):
            self._scatter_strips(self._cache[l], ks[l], row, 0)
            self._scatter_strips(self._cache[L + l], vs[l], row, 0)
        return self._first_token(last, n, slot)

    def _prefill_hit(self, suffix, ctx: int, row, slot: int) -> int:
        """Prefix-cache hit: ``ctx`` leading positions (a multiple of
        ``block_size``) already hold valid K/V in shared blocks.  Run only
        the suffix (zero-padded to its bucket), append its K/V at
        positions ``[ctx, ctx + Tb)`` and attend through the block table.
        The attention here is plain torch, as the JAX engine's einsum
        (it is outside any Pallas kernel there)."""
        L, H, D = self.num_layers, self.num_heads, self.head_dim
        bs = self.block_size
        sn = int(suffix.shape[0])
        Tb = self.prefill_bucket_for(sn)
        T = self.max_blocks_per_slot * bs
        C = H * D
        scale = 1.0 / math.sqrt(D)
        padded = _np.zeros((1, Tb), _np.int64)
        padded[0, :sn] = suffix
        dev = self.device
        q_pos = ctx + torch.arange(Tb, device=dev)
        # padded rows may run past max_len: JAX clamps the embedding
        # gather, torch would raise
        pos = torch.clamp(q_pos, max=self.max_len - 1)[None]
        h = self.block.drop(self.block.embed(self._ids(padded))
                            + self.block.pos_embed(pos))
        live = torch.arange(T, device=dev)[None, :] <= q_pos[:, None]
        table = torch.as_tensor(row, dtype=torch.int64, device=dev)
        for l, cell in enumerate(self._cells):
            at = cell.attention
            hn = cell.ln1(h)
            q, kn, vn = at.query(hn), at.key(hn), at.value(hn)
            qh = q.reshape(Tb, H, D).transpose(0, 1)[None]
            ck, cv = self._cache[l], self._cache[L + l]
            self._scatter_strips(ck, kn.reshape(Tb, H, D).transpose(0, 1),
                                 row, ctx // bs)
            self._scatter_strips(cv, vn.reshape(Tb, H, D).transpose(0, 1),
                                 row, ctx // bs)
            kf = ck[table].transpose(0, 1).reshape(1, H, T, D)
            vf = cv[table].transpose(0, 1).reshape(1, H, T, D)
            s = torch.einsum("bhqd,bhkd->bhqk", qh, kf) * scale
            s = torch.where(live[None, None], s, torch.full_like(s, NEG))
            p = torch.exp(s - s.amax(dim=-1, keepdim=True))
            attn = torch.einsum("bhqk,bhkd->bhqd",
                                p / p.sum(dim=-1, keepdim=True), vf)
            h = h + at.dropout(at.proj(
                attn.transpose(1, 2).reshape(1, Tb, C)))
            h = h + cell.ffn(cell.ln2(h))
        last = self.block._project(self.block.ln_f(h[:, sn - 1:sn]))[0, 0]
        return self._first_token(last, ctx + sn, slot)

    # -- decode ----------------------------------------------------------
    def _layers(self, lt, emb_pos, write, attend):
        """The model over Q tokens per slot: ``lt`` (S, Q) int64 token ids
        embedded at positions ``emb_pos`` (S, Q).  In layer ``l``,
        ``write(l, k, v)`` stores the new K/V (S, Q, H, D) into that
        layer's cache in place, then ``attend(l, q)`` returns the
        attention of the queries q (S, Q, H, D) as (S, Q, H, D).  Returns
        the logits (S, Q, V)."""
        H, D = self.num_heads, self.head_dim
        S, Q = lt.shape
        h = self.block.drop(self.block.embed(lt)
                            + self.block.pos_embed(emb_pos))
        for l, cell in enumerate(self._cells):
            at = cell.attention
            hn = cell.ln1(h)
            q, kn, vn = at.query(hn), at.key(hn), at.value(hn)
            # the JAX program scatters into a donated copy of the cache;
            # the port writes the pool tensors in place
            write(l, kn.reshape(S, Q, H, D), vn.reshape(S, Q, H, D))
            attn = attend(l, q.reshape(S, Q, H, D))
            h = h + at.dropout(at.proj(attn.reshape(S, Q, H * D)))
            h = h + cell.ffn(cell.ln2(h))
        return self.block._project(self.block.ln_f(h))

    def _step_logits(self, lt, pos, blk=None, off=None):
        """One position for every slot: ``lt`` (S,) int64 tokens at write
        heads ``pos`` (S,) int64.  Writes each slot's K/V in place — at
        ``(blk, off)`` in the pools when paged, else at ``pos`` in its
        dense row — then attends over positions ``<= pos`` through K2 or
        K3.  Returns the logits (S, V)."""
        L = self.num_layers
        ck, cv = self._cache[:L], self._cache[L:]
        pos32 = pos.to(torch.int32)
        if self.paged:
            tables = self._tables_tensor()

            def write(l, k, v):
                ck[l][blk, :, off] = k[:, 0]
                cv[l][blk, :, off] = v[:, 0]

            def attend(l, q):
                return paged_decode_attention(q[:, 0], ck[l], cv[l], tables,
                                              pos32)[:, None]
        else:
            rows = torch.arange(lt.shape[0], device=lt.device)

            def write(l, k, v):
                ck[l][rows, :, pos] = k[:, 0]
                cv[l][rows, :, pos] = v[:, 0]

            def attend(l, q):
                return decode_attention(q[:, 0], ck[l], cv[l], pos32)[:, None]
        return self._layers(lt[:, None], pos[:, None], write, attend)[:, 0]

    def _block_of(self, pos):
        """Physical block of each slot's write head; the table column is
        clamped into the table, as the JAX gather clamps it."""
        col = torch.clamp(pos // self.block_size,
                          max=self.max_blocks_per_slot - 1)
        rows = torch.arange(pos.shape[0], device=pos.device)
        return self._tables_tensor()[rows, col].long()

    def _host_positions(self, positions):
        pos = _np.asarray(positions, _np.int64).reshape(self.max_slots)
        if pos.min() < 0 or pos.max() > self.max_len - 1:
            raise MXNetError(f"{self.name}: positions must lie in [0, "
                             f"{self.max_len - 1}], got {pos.tolist()}")
        return pos

    @torch.no_grad()
    def decode(self, last_tokens, positions):
        """Advance EVERY slot one position: ``last_tokens`` (S,) (free
        slots: 0) at write heads ``positions`` (S,) (free slots: 0).
        Returns the next token per slot as a host int32 array."""
        lt = self._ids(_np.asarray(last_tokens).reshape(self.max_slots))
        pos = self._ids(self._host_positions(positions))
        blk = off = None
        if self.paged:
            blk, off = self._block_of(pos), pos % self.block_size
        lg = self._step_logits(lt, pos, blk, off)
        nxt, self._last_logprobs = self._sample(lg, pos + 1)
        return nxt.cpu().numpy().astype(_np.int32)

    @torch.no_grad()
    def decode_burst(self, last_tokens, positions, budgets, eos_ids,
                     active):
        """Advance every slot up to ``scan_steps`` positions with the
        per-slot termination of the JAX scan kept on the device:
        ``budgets`` (S,) caps the tokens each slot may emit, ``eos_ids``
        (S,) is its stop token (-1: none), ``active`` (S,) is False for
        free slots.  A slot that hits eos or its budget freezes: its
        (token, position) stop advancing and its later K/V writes go to
        the null block (paged) or rewrite the same dense entry.  Returns
        host arrays ``(tokens (k, S) int32, emitted (S,) int32)``; slot
        ``s`` emitted ``tokens[:emitted[s], s]``, the same tokens as that
        many :meth:`decode` calls."""
        k = int(self.scan_steps)
        if k < 1:
            raise MXNetError(
                f"{self.name}: decode bursts disabled (scan_steps "
                f"{self.scan_steps}; set MXNET_DECODE_SCAN_STEPS >= 1)")
        S = self.max_slots
        pos_h = self._host_positions(positions)
        bud_h = _np.asarray(budgets, _np.int64).reshape(S)
        act_h = _np.asarray(active, bool).reshape(S)
        reach = pos_h + _np.clip(bud_h, 1, k) - 1
        if (act_h & (reach > self.max_len - 1)).any():
            raise MXNetError(
                f"{self.name}: a burst would write past max_len "
                f"{self.max_len} (positions {pos_h.tolist()}, budgets "
                f"{bud_h.tolist()})")
        lt = self._ids(_np.asarray(last_tokens).reshape(S))
        pos = self._ids(pos_h)
        bud = self._ids(bud_h)
        eos = self._ids(_np.asarray(eos_ids).reshape(S))
        done = torch.as_tensor(~act_h, device=self.device)
        emitted = torch.zeros(S, dtype=torch.int64, device=self.device)
        toks, lps = [], []
        for _ in range(k):
            blk = off = None
            if self.paged:
                blk = torch.where(done, torch.zeros_like(pos),
                                  self._block_of(pos))
                off = pos % self.block_size
            lg = self._step_logits(lt, pos, blk, off)
            # keyed at pos + 1, the position this token will occupy
            nxt, lp = self._sample(lg, pos + 1)
            emit = ~done
            emitted = emitted + emit.long()
            done = done | (emit & ((nxt == eos) | (emitted >= bud)))
            lt = torch.where(done, lt, nxt)
            pos = torch.where(done, pos, pos + 1)
            toks.append(nxt)
            if lp is not None:
                lps.append(lp)
        self._last_logprobs = None if not lps else (
            torch.stack([v for v, _ in lps]), torch.stack([i for _, i in lps]))
        return (torch.stack(toks).cpu().numpy().astype(_np.int32),
                emitted.cpu().numpy().astype(_np.int32))

    # -- speculative decoding --------------------------------------------
    def attach_draft(self, draft: "GenerationEngine",
                     spec_k: Optional[int] = None) -> None:
        """Attach a (small) draft engine for speculative decoding.

        The draft proposes ``spec_k`` tokens per slot (default
        ``MXNET_SPEC_K``, 4); :meth:`verify` scores all ``spec_k + 1``
        positions at once.  The draft must mirror this engine's slot
        layout and position space: the same ``max_slots``, a ``max_len``
        at least this one's, the same vocabulary (sampled ids are
        compared).  Attach before :meth:`warmup`."""
        if draft is self:
            raise MXNetError(f"{self.name}: a model cannot draft itself")
        if int(draft.max_slots) != self.max_slots:
            raise MXNetError(
                f"{self.name}: draft max_slots {draft.max_slots} != "
                f"target max_slots {self.max_slots}")
        if int(draft.max_len) < self.max_len:
            raise MXNetError(
                f"{self.name}: draft max_len {draft.max_len} < target "
                f"max_len {self.max_len} (the draft decodes at the same "
                f"positions)")
        if int(draft.vocab_size) != self.vocab_size:
            raise MXNetError(f"{self.name}: draft vocab {draft.vocab_size} "
                             f"!= target vocab {self.vocab_size}")
        k = int(spec_k if spec_k is not None
                else getenv_int("MXNET_SPEC_K", 4))
        if k < 1:
            raise MXNetError(f"spec_k must be >= 1, got {k}")
        self.draft = draft
        self.spec_k = k
        # the draft's tokens are never emitted, so it computes no logprobs
        draft.logprobs_topn = 0
        # the k draft steps run as one burst; scan_steps == 0 (bursts
        # switched off) keeps the host loop of spec_step
        if draft.scan_steps != 0:
            draft.scan_steps = k

    @torch.no_grad()
    def verify(self, tokens, positions):
        """Score Q positions for EVERY slot at once: ``tokens`` (S, Q) —
        column 0 each slot's last accepted token, columns 1..Q-1 the
        draft's proposals — at base write heads ``positions`` (S,).

        Writes the Q positions' K/V per slot and layer — dense writes past
        ``max_len`` are dropped, paged writes past the slot's reservation
        or ``max_len`` go to the null block, so an overrun row near the
        budget edge never lands on a live entry — embeds row j at position
        ``min(positions[s] + j, max_len - 1)``, and attends through K4 or
        K5.  Returns a host int32 (S, Q) array: ``out[s, j]`` is the token
        sampled after consuming ``tokens[s, :j + 1]``, keyed at position
        ``positions[s] + j + 1`` exactly as :meth:`decode` keys it there.
        With Q == 1 this is :meth:`decode`."""
        S, L = self.max_slots, self.num_layers
        H, D = self.num_heads, self.head_dim
        toks = _np.asarray(tokens, _np.int64).reshape(S, -1)
        Q = toks.shape[1]
        pos_h = self._host_positions(positions)
        pos_q_h = pos_h[:, None] + _np.arange(Q)[None, :]           # (S, Q)
        pos_q = self._ids(pos_q_h)
        pos32 = self._ids(pos_h).to(torch.int32)
        ck, cv = self._cache[:L], self._cache[L:]
        if self.paged:
            tables = self._tables_tensor()
            MB = self.max_blocks_per_slot
            col = pos_q // self.block_size
            ok = (col < MB) & (pos_q < self.max_len)
            rows = torch.arange(S, device=self.device)[:, None]
            blk = torch.where(ok, tables[rows, col.clamp(max=MB - 1)].long(),
                              torch.zeros_like(col))
            off = pos_q % self.block_size

            def write(l, k, v):
                # several redirected (slot, row) pairs may land on one null
                # block address: it is garbage by contract and no live row
                # reads a position written there
                ck[l][blk, :, off] = k
                cv[l][blk, :, off] = v

            def attend(l, q):
                return paged_verify_decode_attention(
                    q.transpose(1, 2).contiguous(), ck[l], cv[l], tables,
                    pos32).transpose(1, 2)
        else:
            keep = _np.flatnonzero(pos_q_h.reshape(-1) < self.max_len)
            src = self._ids(keep)
            ri, pi = self._ids(keep // Q), self._ids(pos_q_h.reshape(-1)[keep])

            def write(l, k, v):
                ck[l][ri, :, pi] = k.reshape(S * Q, H, D)[src]
                cv[l][ri, :, pi] = v.reshape(S * Q, H, D)[src]

            def attend(l, q):
                return verify_decode_attention(
                    q.transpose(1, 2).contiguous(), ck[l], cv[l],
                    pos32).transpose(1, 2)
        lg = self._layers(self._ids(toks),
                          torch.clamp(pos_q, max=self.max_len - 1),
                          write, attend)
        # each slot's sampling parameters repeated over its Q rows
        nxt, lp = self._sample(lg.reshape(S * Q, -1),
                               (pos_q + 1).reshape(-1),
                               _np.repeat(_np.arange(S), Q))
        self._last_verify_logprobs = None if lp is None else tuple(
            a.reshape(S, Q, -1) for a in lp)
        return nxt.reshape(S, Q).cpu().numpy().astype(_np.int32)

    def spec_step(self, last_tokens, positions):
        """One speculative step for EVERY slot: the draft proposes
        ``spec_k`` tokens per slot (one burst, or ``spec_k`` decodes when
        the draft's bursts are off), then one :meth:`verify` scores all
        ``spec_k + 1`` positions.

        Acceptance is the JAX engine's Gumbel-coupled speculative
        sampling: both engines key their samples by (slot root, position),
        so at every position they share one noise vector, and a draft
        token is accepted while it equals the target's sample there.
        Every emitted token is a target sample, the same token plain
        decode emits at that position, at any accept rate; greedy is the
        temperature-0 case.

        Returns ``(out, accepted)``: ``out`` (S, spec_k + 1) int32, of
        which ``out[s, :accepted[s] + 1]`` are this step's tokens, and
        ``accepted`` (S,) in ``[0, spec_k]``.  Rejected positions are
        rolled back by not advancing past them: their stale K/V is masked
        and overwritten by the next dispatch, and in paged mode
        :meth:`~.kvcache.BlockPool.rewind` keeps that overwrite out of
        any shared block."""
        if self.draft is None:
            raise MXNetError(f"{self.name}: no draft attached "
                             "(attach_draft first)")
        k, S = self.spec_k, self.max_slots
        last = _np.asarray(last_tokens, _np.int32).reshape(S)
        pos = self._host_positions(positions)
        # The draft never writes past position max_len - 1.  A proposal
        # consumed at position p is a guess for position p + 1, and no
        # token is ever emitted at max_len or later, so a slot's burst
        # stops after max_len - pos steps (its later proposals repeat the
        # last one, as a frozen burst slot does) and every proposal that
        # can be emitted is still the one JAX drafts.  The JAX draft runs
        # on past the cap, with dropped or clamped writes, where the
        # port's index checks would raise.
        room = self.max_len - pos
        if self.draft.scan_steps == k:
            drafted, _ = self.draft.decode_burst(
                last, pos, budgets=_np.minimum(room, k + 1),
                eos_ids=_np.full(S, -1, _np.int32),
                active=_np.ones(S, bool))
            drafted = _np.ascontiguousarray(drafted.T)              # (S, k)
        else:
            drafted = _np.zeros((S, k), _np.int32)
            lt, pv = last, pos
            for j in range(k):
                nxt = _np.asarray(self.draft.decode(lt, pv),
                                  _np.int32).reshape(S)
                drafted[:, j] = nxt
                go = pv + 1 < self.max_len
                lt, pv = _np.where(go, nxt, lt), _np.where(go, pv + 1, pv)
        out = self.verify(_np.concatenate([last[:, None], drafted], axis=1),
                          pos)
        match = out[:, :k] == drafted                               # (S, k)
        accepted = _np.where(match.all(axis=1), k,
                             _np.argmin(match, axis=1))
        if self.paged or self.draft.paged:
            self._rollback_rejected(pos, accepted)
        return out, accepted

    def _rollback_rejected(self, base_positions, accepted) -> None:
        """Paged rollback after a verify: for every slot that rejected
        draft tokens, run the pool's copy-on-write guard over the dirty
        tail of both engines' tables, so the next dispatch's overwrites
        cannot touch a shared block."""
        for s in range(self.max_slots):
            if int(accepted[s]) >= self.spec_k:
                continue
            keep = int(base_positions[s]) + int(accepted[s]) + 1
            for eng in (self, self.draft):
                if not eng.paged or not eng._slot_blocks[s]:
                    continue
                blocks = eng._slot_blocks[s]
                new = eng.pool.rewind(blocks, keep)
                if new != blocks:
                    eng._slot_blocks[s] = new
                    row = _np.zeros(eng.max_blocks_per_slot, _np.int32)
                    row[:len(new)] = new
                    eng._tables[s] = row
                    eng._tables_dev = None

    # -- paged-pool bookkeeping (no-ops in dense mode) --------------------
    def release_slot(self, slot: int) -> None:
        """Return ``slot``'s blocks to the pool (decref: shared prefix
        blocks stay live for their other readers and the prefix cache).
        Cascades to an attached draft's mirrored slot."""
        if self.draft is not None:
            self.draft.release_slot(slot)
        self._release_blocks(slot)

    def _release_blocks(self, slot: int) -> None:
        """:meth:`release_slot` of this engine's own blocks."""
        if not self.paged:
            return
        blocks = self._slot_blocks[int(slot)]
        if blocks:
            self.pool.release(blocks)
        self._slot_blocks[int(slot)] = []
        self._tables[int(slot)] = 0
        self._tables_dev = None

    def can_admit(self, tokens, reserve_tokens: int,
                  reserved_blocks: int = 0) -> bool:
        """Can the pool reserve worst-case capacity for this prompt now?
        ``reserved_blocks`` discounts capacity promised to earlier admits
        of the same scheduling step.  Dense mode always admits.  With a
        draft attached both pools must fit the reservation plus the
        ``spec_k`` verify headroom."""
        if self.draft is not None and not self.draft.can_admit(
                tokens, int(reserve_tokens) + self.spec_k,
                reserved_blocks):
            return False
        if not self.paged:
            return True
        toks = _np.asarray(tokens, _np.int32).reshape(-1)
        n = int(toks.shape[0])
        reserve = int(reserve_tokens) \
            + (self.spec_k if self.draft is not None else 0)
        reserve = max(n + 1, min(reserve, self.max_len))
        return self.pool.can_admit(toks, n, reserve, reserved_blocks)

    def reserve_estimate(self, reserve_tokens: int) -> int:
        """Worst-case blocks a request reserving ``reserve_tokens``
        positions takes (no sharing assumed)."""
        if not self.paged:
            return 0
        reserve = int(reserve_tokens) \
            + (self.spec_k if self.draft is not None else 0)
        return blocks_for(min(reserve, self.max_len), self.block_size)

    def kv_capacity_tokens(self) -> int:
        """Token positions the KV cache holds across all requests."""
        if self.paged:
            return (self.num_blocks - 1) * self.block_size
        return self.max_slots * self.max_len

    def kv_stats(self) -> dict:
        out = {"kv_paged": self.paged,
               "kv_capacity_tokens": self.kv_capacity_tokens()}
        if self.paged:
            out.update(self.pool.stats())
        return out

    def slot_occupancy(self) -> List[dict]:
        """Blocks held and reserved token capacity per live slot (paged
        mode; ``[]`` dense)."""
        if not self.paged:
            return []
        return [{"slot": s, "blocks": len(b),
                 "reserved_tokens": len(b) * self.block_size}
                for s, b in enumerate(self._slot_blocks) if b]

    # -- warmup / reference path -----------------------------------------
    def warmup(self) -> int:
        """Run every entry point once — each prefill bucket (miss, and
        with the prefix cache the suffix variant, whose writes land in
        the null block), decode, the burst and, with a draft attached,
        verify — so kernels are built and the allocator is warm, then
        reset the cache and warm the draft.  Returns the number of this
        engine's dispatches warmed."""
        n = 0
        self._warming = True
        try:
            for b in self.prefill_buckets:
                self.prefill(_np.zeros(max(1, min(b, self.max_len - 1)),
                                       _np.int32), 0)
                self.release_slot(0)
                n += 1
            if self.paged and self.prefix_cache_enabled:
                row = _np.zeros(self.max_blocks_per_slot, _np.int32)
                for b in self.prefill_buckets:
                    with torch.no_grad():
                        self._prefill_hit(
                            _np.zeros(max(1, min(b, self.max_len - 1)),
                                      _np.int64), 0, row, 0)
                    n += 1
            zeros = _np.zeros(self.max_slots, _np.int32)
            self.decode(zeros, zeros)
            n += 1
            if self.scan_steps >= 1:
                self.decode_burst(zeros, zeros,
                                  _np.ones(self.max_slots, _np.int32),
                                  _np.full(self.max_slots, -1, _np.int32),
                                  _np.ones(self.max_slots, bool))
                n += 1
            if self.draft is not None:
                self.verify(_np.zeros((self.max_slots, self.spec_k + 1),
                                      _np.int32), zeros)
                n += 1
        finally:
            self._warming = False
        self.reset()
        if self.draft is not None:
            self.draft.warmup()
        return n

    def generate(self, tokens, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None,
                 speculative: Optional[bool] = None, sampling=None):
        """Solo generation through the serving entry points (slot 0):
        prefill, then one :meth:`decode` per token — or, with a draft
        attached, one :meth:`spec_step` per 1 to ``spec_k + 1`` tokens
        (the default then; ``speculative=False`` forces plain decode).
        Every emitted token is a target sample either way, so the outputs
        are the same.  ``sampling`` is an optional
        :class:`~.sampling.SamplingParams` (None: greedy).  Returns the
        generated tokens as a list."""
        toks = list(_np.asarray(tokens, _np.int32).reshape(-1))
        n = len(toks)
        budget = min(int(max_new_tokens), self.max_len - n)
        if budget < 1:
            raise MXNetError(
                f"{self.name}: no token budget (prompt {n}, max_len "
                f"{self.max_len})")
        spec = self.draft is not None and (speculative is None
                                           or bool(speculative))
        self.set_slot_sampling(0, sampling)
        out = [self.prefill(toks, 0, reserve_tokens=n + budget)]
        try:
            lt = _np.zeros(self.max_slots, _np.int32)
            pv = _np.zeros(self.max_slots, _np.int32)
            while len(out) < budget and (eos_id is None
                                         or out[-1] != int(eos_id)):
                lt[0] = out[-1]
                pv[0] = n + len(out) - 1
                if not spec:
                    out.append(int(self.decode(lt, pv)[0]))
                    continue
                burst, acc = self.spec_step(lt, pv)
                for t in burst[0, :int(acc[0]) + 1]:
                    out.append(int(t))
                    if len(out) >= budget or (eos_id is not None
                                              and out[-1] == int(eos_id)):
                        break
        finally:
            self.release_slot(0)
        return out

    def __repr__(self):
        return (f"<GenerationEngine {self.name!r}: slots={self.max_slots}, "
                f"max_len={self.max_len}, layers={self.num_layers}, "
                f"heads={self.num_heads}, paged={self.paged}, "
                f"device={self.device}>")

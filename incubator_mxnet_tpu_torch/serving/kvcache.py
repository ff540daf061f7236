"""Paged KV-cache block pool with prefix sharing (a copy of
``incubator_mxnet_tpu/serving/kvcache.py``, its gauges included).

The :class:`BlockPool` is the host-side allocator behind the paged
``GenerationEngine``: device KV storage is carved into fixed-size blocks
of ``block_size`` token positions, and each live slot holds an ordered
*block table* (a list of block ids) instead of a dense ``max_len`` strip.
Three properties fall out:

* **Fragmentation-free packing** — a request reserves only
  ``ceil((prompt + budget) / block_size)`` blocks, so short streams no
  longer pay for ``max_len`` worth of cache and many more of them fit in
  the same byte budget.
* **Prefix sharing** — every *full* block of a prompt is keyed by a
  chained blake2b digest (digest of the previous block's digest plus
  this block's tokens), so two requests with a common prefix map their
  leading blocks to the same physical storage. A digest match implies
  token-exact prefix equality — keys are 128-bit content digests, not
  Python ``hash()`` values, so distinct prompts cannot alias. Shared
  blocks are refcounted; the joiner skips prefill for the shared span
  entirely.
* **Copy-on-write** — a writer that needs to mutate a block with
  refcount > 1 asks :meth:`copy_on_write` for a private copy first. The
  serving flow never mutates shared blocks by construction (only *full*,
  immutable prompt blocks are ever registered for sharing), but the COW
  primitive is part of the pool contract and unit-tested so future
  writers (e.g. speculative-decode rollback) inherit it.

Block id 0 is the reserved **null block**: block tables are padded with
it and out-of-range scatter positions are redirected to it, so garbage
writes from padded prefill rows land in a sink nobody ever attends to.

**Burst write contract** (``GenerationEngine.decode_burst``): the
scanned multi-token decode advances a slot at most ``budget`` positions
past its current length, and every admit reserves
``blocks_for(prompt + budget)`` up front — so the burst's furthest KV
write (position ``prompt + budget - 1`` at the worst case) always lands
inside the slot's reserved table and **no extra headroom is needed for
any scan_steps**. Slots that finish mid-burst have their remaining
in-scan writes redirected to the null block, the same sink padded
prefill rows use.

Eviction: a cached block whose refcount drops to 0 is *not* returned to
the free list — it stays in the prefix cache, instantly reusable by the
next request with the same prefix, and is only reclaimed (LRU) when the
free list runs dry. ``mxtpu_prefix_cache_evictions`` counts reclaims.

All methods take an internal lock; the pool is shared between the
batcher worker thread and HTTP admission checks.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError
from . import metrics as _m

__all__ = ["BlockPool", "blocks_for", "NULL_BLOCK"]

NULL_BLOCK = 0


def blocks_for(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` positions."""
    return max(0, -(-int(tokens) // int(block_size)))


class BlockPool:
    """Refcounted allocator over ``num_blocks`` fixed-size KV blocks.

    ``num_blocks`` includes the reserved null block, so ``num_blocks - 1``
    blocks are allocatable. ``prefix_cache=False`` disables sharing (every
    allocation takes fresh blocks) but keeps the same accounting.
    """

    def __init__(self, num_blocks: int, block_size: int, *,
                 prefix_cache: bool = True, model: str = "?"):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (null block + 1), got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.prefix_cache = bool(prefix_cache)
        self._model = model
        # device bytes behind one block (set by the owning engine once
        # its cache arrays exist) — lets stats() speak bytes, the unit
        # the device-memory plane attributes in (telemetry_device)
        self.block_bytes = 0
        self._lock = threading.RLock()
        self.hits = 0            # blocks reused from the prefix cache
        self.evictions = 0       # idle cached blocks reclaimed (LRU)
        self.cow_copies = 0      # copy_on_write calls that actually copied
        self.rewinds = 0         # rewind() calls that had work to do
        self.reset()

    # -- state ------------------------------------------------------------
    def reset(self) -> None:
        """Drop every allocation AND the prefix cache (weight update /
        watchdog restart: cached K/V no longer matches the params)."""
        with self._lock:
            self._ref = [0] * self.num_blocks
            self._free: deque = deque(range(1, self.num_blocks))
            self._hash: List[Optional[bytes]] = [None] * self.num_blocks
            self._by_hash: Dict[bytes, int] = {}
            # cached blocks with refcount 0, in LRU order (oldest first)
            self._idle: "OrderedDict[int, None]" = OrderedDict()
            self._update_gauges()

    @property
    def free_blocks(self) -> int:
        """Blocks available to a new allocation (truly free + evictable)."""
        with self._lock:
            return len(self._free) + len(self._idle)

    @property
    def blocks_in_use(self) -> int:
        """Blocks pinned by a nonzero refcount."""
        with self._lock:
            return (self.num_blocks - 1) - len(self._free) - len(self._idle)

    @property
    def cached_blocks(self) -> int:
        """Blocks currently registered in the prefix cache (any refcount)."""
        with self._lock:
            return len(self._by_hash)

    def refcount(self, block: int) -> int:
        with self._lock:
            return self._ref[block]

    def _update_gauges(self) -> None:
        _m.KV_BLOCKS_TOTAL.set(self.num_blocks - 1, model=self._model)
        _m.KV_BLOCKS_IN_USE.set(
            (self.num_blocks - 1) - len(self._free) - len(self._idle),
            model=self._model)

    # -- prefix hashing ---------------------------------------------------
    def chain_hashes(self, tokens: Sequence[int], limit: int) -> List[bytes]:
        """Chained blake2b digest per full block over ``tokens[:limit]``.

        ``hashes[i]`` commits to blocks ``0..i`` of the prompt, so a
        digest match implies the whole prefix matches, not just one
        block. 128-bit content digests make accidental aliasing of
        distinct prompts cryptographically impossible — unlike Python
        ``hash()``, where e.g. ``hash(-1) == hash(-2)`` collides.
        """
        bs = self.block_size
        out: List[bytes] = []
        h = ("mxtpu-kv:%d" % bs).encode()
        for i in range(int(limit) // bs):
            blk = b",".join(b"%d" % int(t)
                            for t in tokens[i * bs:(i + 1) * bs])
            h = hashlib.blake2b(h + b"|" + blk, digest_size=16).digest()
            out.append(h)
        return out

    def _match(self, hashes: Sequence[bytes], usable: int) -> List[int]:
        """Longest cached run of leading blocks, without increfing."""
        if not self.prefix_cache:
            return []
        shared: List[int] = []
        for i in range(min(usable, len(hashes))):
            b = self._by_hash.get(hashes[i])
            if b is None:
                break
            shared.append(b)
        return shared

    @staticmethod
    def _usable_prefix_blocks(n: int, block_size: int) -> int:
        # At least one prompt token must stay outside the shared span so
        # the suffix prefill has a row to read the first logits from.
        return max(0, (int(n) - 1) // block_size)

    # -- allocation -------------------------------------------------------
    def can_admit(self, tokens: Sequence[int], n: int, reserve_tokens: int,
                  reserved_blocks: int = 0) -> bool:
        """Would :meth:`allocate` succeed right now? ``reserved_blocks``
        discounts capacity already promised to earlier admits in the same
        scheduling step."""
        with self._lock:
            need = blocks_for(reserve_tokens, self.block_size)
            hashes = self.chain_hashes(tokens, (int(n) // self.block_size)
                                       * self.block_size)
            shared = self._match(
                hashes, self._usable_prefix_blocks(n, self.block_size))
            free = len(self._free) + len(self._idle) - int(reserved_blocks)
            # Idle blocks this request would share are pinned by the
            # share itself — they cannot double as reclaimable capacity
            # for the fresh tail.
            shared_idle = sum(1 for b in shared if self._ref[b] == 0)
            return free - shared_idle >= need - len(shared)

    def allocate(self, tokens: Sequence[int], n: int, reserve_tokens: int,
                 share: bool = True) -> Tuple[List[int], int]:
        """Reserve blocks for a request with prompt ``tokens[:n]`` and a
        worst-case total of ``reserve_tokens`` positions.

        Returns ``(table, shared_tokens)``: the ordered block table (length
        ``ceil(reserve_tokens / block_size)``) and how many leading token
        positions already hold valid K/V from the prefix cache (always a
        multiple of ``block_size``). Raises :class:`MXNetError` when the
        pool cannot satisfy the reservation. ``share=False`` skips both
        prefix matching and registration (warmup traffic must not poison
        the cache).
        """
        n = int(n)
        need = blocks_for(reserve_tokens, self.block_size)
        if need < 1:
            raise ValueError(f"reserve_tokens must be >= 1, got {reserve_tokens}")
        with self._lock:
            full = (n // self.block_size) * self.block_size
            hashes = self.chain_hashes(tokens, full) if share else []
            shared = self._match(
                hashes, self._usable_prefix_blocks(n, self.block_size))
            fresh_needed = need - len(shared)
            # Full capacity check BEFORE any mutation: idle blocks this
            # request shares are pinned by the share, so they must not
            # count toward the fresh tail — otherwise the shortfall
            # would only surface in _pop_free after refcounts were
            # already bumped, leaking the partial allocation.
            shared_idle = sum(1 for b in shared if self._ref[b] == 0)
            available = len(self._free) + len(self._idle) - shared_idle
            if available < fresh_needed:
                raise MXNetError(
                    f"kv pool exhausted: need {fresh_needed} blocks, "
                    f"{available} available "
                    f"({self.num_blocks - 1} total, block_size "
                    f"{self.block_size})")
            for b in shared:
                self._incref(b)
            table = list(shared)
            for _ in range(fresh_needed):
                b = self._pop_free()
                self._ref[b] = 1
                table.append(b)
            # Register this prompt's remaining full blocks so later
            # requests with the same prefix share them. The worker
            # prefills immediately after allocate() (same thread), so the
            # registered blocks hold valid K/V before any later lookup.
            if self.prefix_cache and share:
                for i in range(len(shared), len(hashes)):
                    if hashes[i] not in self._by_hash:
                        self._by_hash[hashes[i]] = table[i]
                        self._hash[table[i]] = hashes[i]
            if shared:
                self.hits += len(shared)
                _m.PREFIX_CACHE_HITS.inc(len(shared), model=self._model)
            self._update_gauges()
            return table, len(shared) * self.block_size

    def release(self, table: Sequence[int]) -> None:
        """Decref every block in ``table``. Blocks reaching refcount 0
        return to the free list, unless cached — those stay evictable in
        LRU order for future prefix hits."""
        with self._lock:
            for b in table:
                if b == NULL_BLOCK:
                    continue
                if self._ref[b] <= 0:
                    raise MXNetError(f"double free of kv block {b}")
                self._ref[b] -= 1
                if self._ref[b] == 0:
                    if self._hash[b] is not None:
                        self._idle[b] = None
                        self._idle.move_to_end(b)
                    else:
                        self._free.append(b)
            self._update_gauges()

    def invalidate(self, blocks: Sequence[int]) -> None:
        """Unregister ``blocks`` from the prefix cache without touching
        refcounts. For blocks whose K/V never became valid — a prefill
        that failed after :meth:`allocate` had already registered them —
        so a later request with the same prefix prefills cold instead of
        "hitting" garbage. Unregistered blocks are a no-op."""
        with self._lock:
            for b in blocks:
                if b != NULL_BLOCK:
                    self._evict_hash(b)

    def copy_on_write(self, block: int) -> int:
        """Private handle for a block the caller wants to mutate. Returns
        ``block`` unchanged when exclusively owned; otherwise decrefs it,
        allocates a fresh block (refcount 1), and returns the new id — the
        caller must copy the device contents before writing."""
        with self._lock:
            if self._ref[block] <= 0:
                raise MXNetError(f"copy_on_write of unreferenced block {block}")
            if self._ref[block] == 1 and self._hash[block] is None:
                return block
            if self._ref[block] == 1:
                # Exclusively owned but published in the prefix cache:
                # unpublish instead of copying — readers arriving later
                # simply miss.
                self._evict_hash(block)
                return block
            if not self._free and not self._idle:
                raise MXNetError("kv pool exhausted during copy_on_write")
            self._ref[block] -= 1
            new = self._pop_free()
            self._ref[new] = 1
            self.cow_copies += 1
            self._update_gauges()
            return new

    def rewind(self, table: Sequence[int], keep_tokens: int) -> List[int]:
        """Prepare ``table`` for overwriting every position
        ``>= keep_tokens`` (speculative-decode rollback: rejected draft
        positions will be re-written by the next dispatch).

        No block is ever freed — the reservation stays intact, and blocks
        holding only kept positions (the shared prefix among them) are
        untouched.  Blocks in the dirty span that are shared (refcount
        > 1) or published in the prefix cache get :meth:`copy_on_write`
        treatment so the overwrite cannot corrupt a neighbor's view;
        the returned table carries any replacement ids.

        The serving flow only ever writes past the prompt, and only full
        immutable prompt blocks are shared/published, so the COW branch
        is a contract guard rather than a hot path.  A shared block that
        also holds kept positions cannot be rolled back on the host alone
        (the private copy would lose the kept K/V) — that state is
        unreachable through the engine and raises.
        """
        keep_tokens = max(0, int(keep_tokens))
        bs = self.block_size
        with self._lock:
            out = list(table)
            first = keep_tokens // bs   # first block with a dirty position
            touched = False
            for i in range(first, len(out)):
                b = out[i]
                if b == NULL_BLOCK:
                    continue
                if self._ref[b] <= 1 and self._hash[b] is None:
                    continue
                if i * bs < keep_tokens:
                    raise MXNetError(
                        f"rewind would copy-on-write block {b} holding "
                        f"kept positions (keep={keep_tokens}); decode "
                        f"writes must never land in shared prompt blocks")
                out[i] = self.copy_on_write(b)
                touched = True
            if touched:
                self.rewinds += 1
                self._update_gauges()
            return out

    # -- internals --------------------------------------------------------
    def _incref(self, b: int) -> None:
        self._ref[b] += 1
        if self._ref[b] == 1:
            self._idle.pop(b, None)

    def _pop_free(self) -> int:
        if self._free:
            return self._free.popleft()
        if self._idle:
            b, _ = self._idle.popitem(last=False)  # LRU: oldest idle first
            self._evict_hash(b)
            self.evictions += 1
            _m.PREFIX_CACHE_EVICTIONS.inc(model=self._model)
            return b
        raise MXNetError("kv pool exhausted")

    def _evict_hash(self, b: int) -> None:
        h = self._hash[b]
        if h is not None and self._by_hash.get(h) == b:
            del self._by_hash[h]
        self._hash[b] = None

    def stats(self) -> Dict[str, object]:
        with self._lock:
            total = self.num_blocks - 1
            in_use = total - len(self._free) - len(self._idle)
            out = {
                "kv_block_size": self.block_size,
                "kv_blocks_total": total,
                "kv_blocks_in_use": in_use,
                "kv_blocks_cached_idle": len(self._idle),
                "kv_utilization": (in_use / total) if total else 0.0,
                "prefix_cache": self.prefix_cache,
                "prefix_cache_hits": self.hits,
                "prefix_cache_evictions": self.evictions,
                "rewinds": self.rewinds,
            }
            if self.block_bytes:
                out["kv_bytes_total"] = total * self.block_bytes
                out["kv_bytes_in_use"] = in_use * self.block_bytes
            return out

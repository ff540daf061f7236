"""Sampling plane of the PyTorch port (counterpart of
``incubator_mxnet_tpu/serving/sampling.py``).

Each slot carries a root key ``(hi, lo)`` derived from the request seed;
the token at sequence position ``t`` is sampled with ``step_keys(root,
t)`` — the position XORed into the low word — so every dispatch path
(per-step decode, burst, prefill) draws the same noise for the same
position.  Sampling is keyed Gumbel-max over the top-k / top-p support,
and ``temperature == 0`` selects the biased argmax.

The Gumbel noise comes from :func:`_gumbel_row`, an integer hash ported
bit-exactly from the JAX package: the uint32 arithmetic is done in int64
and masked to 32 bits after every multiply and xor (torch's uint32 lacks
multiply and shift on many backends), so a seeded request draws the same
noise in both packages.

The host-side planes are the JAX package's own logic, copied: the seed of
candidate ``i`` of an ``n > 1`` fan-out (:func:`derive_candidate_seed`),
stop-sequence detection over a burst (:func:`stop_trim`) and the JSON
constrained-output automaton (:class:`JsonMaskMachine`), whose mask row
the engine applies as the slot's logit bias."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import numpy as _np
import torch

__all__ = ["SamplingParams", "root_key", "derive_candidate_seed",
           "step_keys", "sample_tokens", "topn_logprobs", "stop_trim",
           "JsonMaskMachine", "MASK_OFF"]

# Disallowed tokens get this logit bias: decisively below any real logit,
# but finite — a fully masked row still has a defined argmax.
MASK_OFF = -1e9

_M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration; the default instance is greedy.
    ``stop`` holds token-id sequences (a matched stop stays in the
    output), ``n > 1`` fans out into ``n`` candidates with derived seeds,
    ``json_mode`` constrains the output to one JSON object or array, and
    ``logprobs`` asks for the top-N logprobs of every emitted token."""

    temperature: float = 0.0
    top_k: int = 0                  # 0: no top-k filter
    top_p: float = 1.0              # 1.0: no nucleus filter
    seed: Optional[int] = None
    logprobs: int = 0               # top-N per-token logprobs (0: off)
    stop: Tuple[Tuple[int, ...], ...] = ()
    n: int = 1
    logit_bias: Optional[Dict[int, float]] = None
    json_mode: bool = False

    @property
    def sampled(self) -> bool:
        return float(self.temperature) > 0.0

    def validate(self, *, max_stops: int = 4, max_stop_len: int = 16,
                 max_n: int = 8) -> "SamplingParams":
        """Range-check every field (ValueError) and return a canonicalized
        copy (stop sequences as int tuples)."""
        if not float(self.temperature) >= 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if int(self.top_k) < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < float(self.top_p) <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1], got {self.top_p}")
        if self.seed is not None and not 0 <= int(self.seed) < 2 ** 63:
            raise ValueError(f"seed must be in [0, 2**63), got "
                             f"{self.seed}")
        if int(self.logprobs) < 0:
            raise ValueError(
                f"logprobs must be >= 0, got {self.logprobs}")
        stops = []
        for s in self.stop or ():
            seq = tuple(int(t) for t in
                        (s if isinstance(s, (list, tuple)) else (s,)))
            if not seq:
                raise ValueError("stop sequences must be non-empty")
            if len(seq) > int(max_stop_len):
                raise ValueError(
                    f"stop sequence length {len(seq)} exceeds "
                    f"{max_stop_len}")
            stops.append(seq)
        if len(stops) > int(max_stops):
            raise ValueError(
                f"{len(stops)} stop sequences exceed the limit of "
                f"{max_stops}")
        if not 1 <= int(self.n) <= int(max_n):
            raise ValueError(f"n must be in [1, {max_n}], got {self.n}")
        if self.logit_bias:
            for t, b in self.logit_bias.items():
                int(t), float(b)
        return replace(self, temperature=float(self.temperature),
                       top_k=int(self.top_k), top_p=float(self.top_p),
                       logprobs=int(self.logprobs), n=int(self.n),
                       stop=tuple(stops))


def root_key(seed: int) -> _np.ndarray:
    """The slot's root key as a host uint32 pair, equal to the JAX
    package's ``root_key`` with its default 32-bit mode (``jax.random.
    PRNGKey(seed)``: the high word is 0)."""
    s = int(seed) & ((1 << 64) - 1)
    return _np.array([0, s & _M32], _np.uint32)


def derive_candidate_seed(seed: int, candidate: int) -> int:
    """Seed for candidate ``i`` of an n>1 fan-out.  Candidate 0 keeps the
    request seed unchanged, so an ``n=1`` rerun of the echoed seed replays
    candidate 0 token for token."""
    if candidate == 0:
        return int(seed)
    return (int(seed) + 0x9E3779B97F4A7C15 * int(candidate)) % (2 ** 63)


def step_keys(root_keys: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Per-slot keys for the tokens at positions ``indices``: ``(hi, lo
    XOR index)`` as int64 (..., 2) holding uint32 values.  ``root_keys``
    (..., 2) broadcasts against ``indices`` (...,)."""
    idx = indices.to(torch.int64) & _M32
    root = root_keys.to(torch.int64)
    hi = root[..., 0].expand(idx.shape)
    return torch.stack([hi, root[..., 1] ^ idx], dim=-1)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32), without ever
    leaving int64's range: the constant is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_row(key: torch.Tensor, V: int) -> torch.Tensor:
    """The counter-based hash behind :func:`_gumbel_row`: two murmur3
    finalizer rounds over (lane, key), as uint32 values in int64
    (..., V).  ``key`` (..., 2) int64 holding uint32 words."""
    k0 = key[..., 0:1].to(torch.int64)
    k1 = key[..., 1:2].to(torch.int64)
    x = _mul32(torch.arange(V, dtype=torch.int64, device=key.device),
               0x9E3779B9)
    x = x ^ k1
    for salt in (k0, k1):
        x = x ^ (x >> 16)
        x = _mul32(x, 0x85EBCA6B)
        x = x ^ (x >> 13)
        x = _mul32(x, 0xC2B2AE35)
        x = x ^ (x >> 16) ^ salt
    return x


def _gumbel_row(key: torch.Tensor, V: int) -> torch.Tensor:
    """Keyed Gumbel noise (..., V) f32 from :func:`_hash_row`, so every
    path that derives the same :func:`step_keys` key draws the same
    noise."""
    # top 24 bits -> uniform in [2^-24, 1]; the floor keeps log finite
    u = torch.clamp(_hash_row(key, V) >> 8, min=1).to(torch.float32) \
        * (2.0 ** -24)
    return -torch.log(-torch.log(u))


def _sample_row(lg, temperature, top_k, top_p, bias, key):
    """One slot: logits (V,) -> sampled token id (0-d int64 tensor); the
    single-row case of :func:`sample_tokens`."""
    def row(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=lg.device).reshape(1)
    return sample_tokens(lg[None], row(temperature, torch.float32),
                         row(top_k, torch.int64), row(top_p, torch.float32),
                         bias[None], key[None])[0]


def sample_tokens(logits, temperatures, top_ks, top_ps, biases, keys):
    """Per-slot keyed Gumbel-max sampling: ``logits`` (S, V) -> (S,) int64.
    ``temperatures``/``top_ks``/``top_ps`` (S,), ``biases`` (S, V),
    ``keys`` (S, 2) from :func:`step_keys`.  Branchless per row, as in the
    JAX package: ``temperature == 0`` rows take the biased argmax (ties to
    the first index).  Filter conventions are ``models/gpt.py``'s:
    temperature scales before the filters, ``top_k <= 0`` (or >= vocab)
    disables top-k, and the nucleus filter's exclusive cumsum always keeps
    the top-1 token."""
    S, V = logits.shape
    lgb = (logits + biases).float()
    greedy = torch.argmax(lgb, dim=-1)
    temps = temperatures.float()
    z = lgb / torch.clamp(temps, min=1e-6)[:, None]
    srt = torch.sort(z, dim=-1, descending=True).values
    kk = torch.where(top_ks <= 0, torch.full_like(top_ks, V),
                     torch.clamp(top_ks, max=V)).long()
    keep = z >= srt.gather(1, (kk - 1)[:, None])
    probs = torch.softmax(srt, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs      # exclusive: before[0]==0
    cutoff = torch.where(before < top_ps.float()[:, None], srt,
                         torch.full_like(srt, float("inf"))).amin(
                             dim=-1, keepdim=True)
    keep &= z >= cutoff
    noisy = torch.where(keep, z, torch.full_like(z, MASK_OFF)) \
        + _gumbel_row(keys, V)
    sampled = torch.argmax(noisy, dim=-1)
    return torch.where(temps > 0.0, sampled, greedy)


def topn_logprobs(logits, biases, n: int):
    """Top-``n`` logprobs of the biased distribution: ``(values (..., n)
    f32, token ids (..., n) int64)``."""
    lp = torch.log_softmax((logits + biases).float(), dim=-1)
    vals, ids = torch.topk(lp, int(n), dim=-1)
    return vals, ids


# ---------------------------------------------------------------------------
# host-side planes: stop sequences and constrained output
# ---------------------------------------------------------------------------

def stop_trim(prev_tail, new_tokens, stops):
    """Scan ``new_tokens`` (appended after ``prev_tail``) for the first
    completion of any stop sequence.  Returns ``(kept, stopped)``: keep
    the first ``kept`` new tokens (the stop sequence itself stays in the
    output) and discard the rest — a burst's over-generated tail."""
    if not stops:
        return len(new_tokens), False
    window = max(len(s) for s in stops)
    tail = list(prev_tail)[-(window - 1):] if window > 1 else []
    for i, t in enumerate(new_tokens):
        tail.append(int(t))
        for s in stops:
            if len(tail) >= len(s) and tuple(tail[-len(s):]) == tuple(s):
                return i + 1, True
        if len(tail) > window:
            del tail[0]
    return len(new_tokens), False


class JsonMaskMachine:
    """Constrained-output state machine: a character-level pushdown
    automaton over (a useful subset of) the JSON grammar, driving a
    per-slot vocab mask.

    The host advances the machine at each emit boundary with the token
    just emitted; :meth:`mask` renders the set of now-legal next
    tokens as a logit-bias row (0 allowed, :data:`MASK_OFF` not) that
    the engine applies inside its next program — the mask is written
    into the slot's static bias buffer, so constrained decoding costs
    no extra program.  Because the mask can change
    every token, a constrained slot pins the batcher to the per-step
    decode path (``ContinuousBatcher._burst_ready``): a k-step burst
    could not observe mid-burst mask updates.

    ``token_strs`` maps token id → string; the default serving mapping
    is byte-level (``chr(id)``).  Multi-character tokens are allowed
    when every character advances the automaton.  The grammar requires
    a top-level object or array (the JSON-mode contract), after which
    :attr:`done` flips and the batcher finishes the request."""

    _WS = " \t\n\r"
    _DIGITS = "0123456789"
    # string-interior chars allowed without escaping (printable ASCII
    # minus '"' and '\\'); enough for byte-level serving vocabularies
    _STR_OK = "".join(chr(c) for c in range(0x20, 0x7F)
                      if chr(c) not in '"\\')

    def __init__(self, token_strs):
        self._toks = [str(s) for s in token_strs]
        # state: (mode, stack, literal-remainder); modes are short
        # strings, the stack holds 'O'/'A' container contexts
        self._state = ("value", (), "")

    # -- pure transition core -------------------------------------------
    @classmethod
    def _feed(cls, state, ch):
        """One character; returns the next state or None (illegal)."""
        mode, stack, lit = state
        if mode == "done":
            return None
        if mode == "str" or mode == "str_esc":
            if mode == "str_esc":
                return ("str", stack, "") if ch in '"\\/bfnrt' else None
            if ch == '"':
                return cls._after_value(stack)
            if ch == "\\":
                return ("str_esc", stack, "")
            return ("str", stack, "") if ch in cls._STR_OK else None
        if mode == "lit":
            if lit and ch == lit[0]:
                rest = lit[1:]
                return ("lit", stack, rest) if rest \
                    else cls._after_value(stack)
            return None
        if mode == "num":
            if ch in cls._DIGITS:
                return ("num", stack, "")
            if ch in ".eE+-":        # permissive; parseability is the
                return ("num", stack, "")   # test's oracle, not ours
            # a number is ended by its terminator: close/comma/ws
            nxt = cls._after_value(stack)
            return cls._feed(nxt, ch) if nxt is not None else None
        if mode == "key" or mode == "key_esc":
            if mode == "key_esc":
                return ("key", stack, "") if ch in '"\\/bfnrt' else None
            if ch == '"':
                return ("colon", stack, "")
            if ch == "\\":
                return ("key_esc", stack, "")
            return ("key", stack, "") if ch in cls._STR_OK else None
        if ch in cls._WS:
            return state            # whitespace is legal between tokens
        if mode == "value":
            if ch == "{":
                return ("obj_key0", stack + ("O",), "")
            if ch == "[":
                return ("arr_val0", stack + ("A",), "")
            if not stack:           # top level must be a container
                return None
            if ch == '"':
                return ("str", stack, "")
            if ch in cls._DIGITS or ch == "-":
                return ("num", stack, "")
            if ch == "t":
                return ("lit", stack, "rue")
            if ch == "f":
                return ("lit", stack, "alse")
            if ch == "n":
                return ("lit", stack, "ull")
            return None
        if mode in ("obj_key0", "obj_key"):
            if ch == '"':
                return ("key", stack, "")
            if ch == "}" and mode == "obj_key0":
                return cls._after_value(stack[:-1])
            return None
        if mode == "colon":
            return ("value", stack, "") if ch == ":" else None
        if mode == "arr_val0":
            if ch == "]":
                return cls._after_value(stack[:-1])
            nxt = cls._feed(("value", stack, ""), ch)
            return nxt
        if mode == "obj_next":
            if ch == ",":
                return ("obj_key", stack, "")
            if ch == "}":
                return cls._after_value(stack[:-1])
            return None
        if mode == "arr_next":
            if ch == ",":
                return ("value", stack, "")
            if ch == "]":
                return cls._after_value(stack[:-1])
            return None
        return None

    @staticmethod
    def _after_value(stack):
        if not stack:
            return ("done", (), "")
        return ("obj_next" if stack[-1] == "O" else "arr_next",
                stack, "")

    @classmethod
    def _close_cost(cls, state):
        """Minimal characters from ``state`` to ``done`` — the cost of
        closing every open string/literal/number and container by the
        shortest legal path (a mandatory value costs 1: a digit)."""
        mode, stack, lit = state
        d = len(stack)
        if mode == "done":
            return 0
        if mode == "value":
            return d + (1 if stack else 2)    # top level needs "[]"
        return d + {"num": 0, "str": 1, "str_esc": 2,
                    "lit": len(lit), "key": 3, "key_esc": 4,
                    "colon": 2, "obj_key": 4, "obj_key0": 0,
                    "arr_val0": 0, "obj_next": 0, "arr_next": 0}[mode]

    def _feed_token(self, state, tok: int):
        s = self._toks[tok] if 0 <= int(tok) < len(self._toks) else ""
        if not s:
            return None
        for ch in s:
            state = self._feed(state, ch)
            if state is None:
                return None
        return state

    # -- host API --------------------------------------------------------
    @property
    def done(self) -> bool:
        return self._state[0] == "done"

    def advance(self, tok: int) -> bool:
        """Consume the emitted token; False if it was not legal (the
        in-program mask makes this unreachable on the serving path)."""
        nxt = self._feed_token(self._state, int(tok))
        if nxt is None:
            return False
        self._state = nxt
        return True

    def mask(self, budget: Optional[int] = None) -> _np.ndarray:
        """Logit-bias row for the NEXT token: 0 for every token whose
        whole string advances the automaton, :data:`MASK_OFF`
        otherwise.  O(vocab × token length) host work per emitted
        token — the serving mapping is byte-level, so this is a few
        thousand character transitions at the emit boundary, never on
        the device.

        ``budget`` (tokens still emittable, INCLUDING the one this
        mask gates) additionally drops every token whose resulting
        state could not be closed within what remains — the output is
        then guaranteed to parse before the budget runs out (with
        byte-level tokens, the shortest closing path always survives
        the filter, so the mask can never go empty while
        ``_close_cost(state) <= budget``)."""
        row = _np.full(len(self._toks), MASK_OFF, _np.float32)
        if self.done:
            return row
        for t in range(len(self._toks)):
            nxt = self._feed_token(self._state, t)
            if nxt is None:
                continue
            if budget is not None and self._close_cost(nxt) \
                    > budget - len(self._toks[t]):
                continue
            row[t] = 0.0
        return row

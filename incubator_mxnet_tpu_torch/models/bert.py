"""BERT and the transformer blocks it shares with the GPT model
(counterpart of ``incubator_mxnet_tpu/models/bert.py``: ``_sdpa``'s
non-sequence-parallel branch, ``MultiHeadAttention``, ``PositionwiseFFN``,
``cached_step_attn``, ``TransformerEncoderCell``, ``maybe_remat_cell``,
``BERTEncoder``, ``BERTModel``, ``BERTForPretrain``, ``MLMPretrainLoss``,
``BERTPretrainLoss``, ``BERTMLMOnly`` and the ``bert_tiny``/``bert_base``/
``bert_large`` configurations).

Self-attention runs :func:`..kernels.flash_attention`: on the card K1
forward and, in training, K6/K7 backward.  Parameter names follow MXNet's
scopes, so :func:`..convert.load_jax_params` carries a JAX BERT across by
name."""
from __future__ import annotations

import contextlib
import math

import torch
from torch.utils.checkpoint import checkpoint

from .. import initializer as _init
from .. import random as _random
from ..base import MXNetError, getenv_bool
from ..context import resolve_device
from ..gluon.loss import SoftmaxCrossEntropyLoss
from ..gluon.nn import (Dense, Dropout, Embedding, HybridBlock, LayerNorm,
                        gelu)
from ..kernels.flash_attention import NEG, flash_attention

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "cached_step_attn",
           "TransformerEncoderCell", "maybe_remat_cell", "BERTEncoder",
           "BERTModel", "BERTForPretrain", "MLMPretrainLoss",
           "BERTPretrainLoss", "BERTMLMOnly", "bert_tiny", "bert_base",
           "bert_large"]


def _sdpa(q, k, v, num_heads, mask=None, causal=False):
    """Scaled-dot-product attention over (B, T, C) projections.

    Self-attention (Tq == Tk) goes through :func:`flash_attention`: kernel
    K1 for CUDA tensors, its plain version for CPU tensors.  ``mask`` is
    an optional (B, Tk) 0/1 key-validity mask; ``causal`` adds the
    decoder's triangular mask.  Cross-attention stays plain torch, as in
    the JAX package."""
    B, Tq, C = q.shape
    Tk = k.shape[1]
    hd = C // num_heads

    def split(x):
        return x.reshape(B, -1, num_heads, hd).transpose(1, 2).contiguous()

    qh, kh, vh = split(q), split(k), split(v)
    scale = 1.0 / math.sqrt(hd)
    if Tq == Tk:
        out = flash_attention(qh, kh, vh, scale=scale, causal=causal,
                              mask=mask)
    else:
        s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
        if causal:
            tri = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()
            s = s.masked_fill(~tri[None, None], NEG)
        if mask is not None:
            s = s.masked_fill(~(mask[:, None, None, :] > 0), NEG)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", p, vh)
    return out.transpose(1, 2).reshape(B, Tq, C)


class MultiHeadAttention(HybridBlock):
    """Projected multi-head attention over :func:`_sdpa`.  ``mem``
    switches to cross-attention (keys/values project from ``mem``)."""

    def __init__(self, units, num_heads, dropout=0.0, causal=False,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise MXNetError("num_heads must divide units")
        self._units = units
        self._num_heads = num_heads
        self._causal = causal
        with self.name_scope():
            self.query = Dense(units, units, flatten=False, device=device)
            self.key = Dense(units, units, flatten=False, device=device)
            self.value = Dense(units, units, flatten=False, device=device)
            self.proj = Dense(units, units, flatten=False, device=device)
            self.dropout = Dropout(dropout)

    def forward(self, x, mask=None, mem=None):
        kv_src = x if mem is None else mem
        q, k, v = self.query(x), self.key(kv_src), self.value(kv_src)
        out = _sdpa(q, k, v, self._num_heads, mask=mask, causal=self._causal)
        return self.dropout(self.proj(out))


def cached_step_attn(qv, kn, vn, ck, cv, t, num_heads):
    """Single-position attention over a KV cache, for the incremental
    decoder (``GPTCell.step``): write this position's K/V at index ``t``
    (in place: the caller owns the caches), attend over positions <= t.
    qv/kn/vn (B, 1, C); ck/cv (B, Tmax, C); returns (out (B, 1, C), ck,
    cv)."""
    B, _, C = qv.shape
    hd = C // num_heads
    Tm = ck.shape[1]
    ck[:, t] = kn[:, 0]
    cv[:, t] = vn[:, 0]
    qh = qv.reshape(B, 1, num_heads, hd).transpose(1, 2)
    kh = ck.reshape(B, Tm, num_heads, hd).transpose(1, 2)
    vh = cv.reshape(B, Tm, num_heads, hd).transpose(1, 2)
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / math.sqrt(hd)
    live = torch.arange(Tm, device=qv.device)[None, None, None, :] <= t
    s = s.masked_fill(~live, NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vh)
    return out.transpose(1, 2).reshape(B, 1, C), ck, cv


class PositionwiseFFN(HybridBlock):
    """``dropout(ffn_2(gelu(ffn_1(x))))``."""

    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 device=None, **kwargs):
        super().__init__(**kwargs)
        if activation != "gelu":
            raise MXNetError(f"activation {activation!r} is not ported; "
                             "only 'gelu'")
        with self.name_scope():
            self.ffn_1 = Dense(hidden_size, units, flatten=False,
                               device=device)
            self.ffn_2 = Dense(units, hidden_size, flatten=False,
                               device=device)
            self.dropout = Dropout(dropout)

    def forward(self, x):
        return self.dropout(self.ffn_2(gelu(self.ffn_1(x))))


class TransformerEncoderCell(HybridBlock):
    """Post-LN transformer layer (BERT style): ln1(x + attn(x, mask)),
    then ln2(x + ffn(x))."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.attention = MultiHeadAttention(units, num_heads, dropout,
                                                device=device)
            self.ln1 = LayerNorm(units, device=device)
            self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                       device=device)
            self.ln2 = LayerNorm(units, device=device)

    def forward(self, x, mask=None):
        x = self.ln1(x + self.attention(x, mask))
        return self.ln2(x + self.ffn(x))


def maybe_remat_cell(cell, x, *rest):
    """Run one layer, under ``torch.utils.checkpoint`` when
    ``MXNET_BACKWARD_DO_MIRROR`` is set and a gradient is being recorded:
    the layer's activations are then recomputed in the backward instead of
    saved (the JAX package's ``jax.checkpoint``).  The recompute runs the
    layer's forward, and so K1, a second time, and draws its dropout masks
    again from the port's generator of ``x``'s device, set back to its
    state before the forward (torch's checkpoint keeps only its own
    default generators' states), so they are the forward's."""
    if not getenv_bool("MXNET_BACKWARD_DO_MIRROR") \
            or not torch.is_grad_enabled():
        return cell(x, *rest)
    gen = _random.generator(x.device)

    def contexts():
        before = gen.get_state()          # called before the forward runs

        @contextlib.contextmanager
        def recompute():
            now = gen.get_state()
            gen.set_state(before)
            try:
                yield
            finally:
                gen.set_state(now)
        return contextlib.nullcontext(), recompute()
    return checkpoint(cell, x, *rest, use_reentrant=False,
                      context_fn=contexts)


class BERTEncoder(HybridBlock):
    """``num_layers`` :class:`TransformerEncoderCell` in sequence,
    registered as ``layer0``, ``layer1``, ... (the reference's structural
    names); ``cells`` lists them."""

    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.0, device=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            for i in range(num_layers):
                self.register_child(TransformerEncoderCell(
                    units, hidden_size, num_heads, dropout, device=device),
                    f"layer{i}")

    @property
    def cells(self):
        return list(self._modules.values())

    def forward(self, x, mask=None):
        for cell in self.cells:
            x = maybe_remat_cell(cell, x, mask)
        return x


class BERTModel(HybridBlock):
    """Embeddings + encoder + tanh pooler (GluonNLP's ``BERTModel``).
    ``forward(input_ids, token_types, valid_length=None)`` -> (sequence
    output (B, T, units), pooled (B, units)).  ``valid_length`` (B,) masks
    the keys at and past each sequence's length.  Parameters are created
    on ``device`` (default ``cuda:0``; ``device='cpu'`` for the CPU) and
    hold zeros until ``initialize`` or :func:`..convert.load_jax_params`
    fills them."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 token_type_vocab=2, dropout=0.1, device=None, **kwargs):
        super().__init__(**kwargs)
        dev = resolve_device(device)
        self._units = int(units)
        self._max_length = int(max_length)
        # MXNet's params.get("position_weight", init="normal"): its own
        # initializer wins over the one passed to initialize()
        pos = torch.nn.Parameter(torch.zeros(max_length, units, device=dev))
        pos.mx_init = _init.Normal()
        self.position_weight = pos
        with self.name_scope():
            self.word_embed = Embedding(vocab_size, units, device=dev)
            self.token_type_embed = Embedding(token_type_vocab, units,
                                              device=dev)
            self.embed_ln = LayerNorm(units, device=dev)
            self.embed_dropout = Dropout(dropout)
            self.encoder = BERTEncoder(num_layers, units, hidden_size,
                                       num_heads, dropout, device=dev)
            self.pooler = Dense(units, units, activation="tanh",
                                flatten=False, device=dev)
        # inference mode by default, as MXNet outside autograd.record
        self.eval()

    def forward(self, input_ids, token_types, valid_length=None):
        T = input_ids.shape[1]
        if T > self._max_length:
            raise MXNetError(f"sequence length {T} exceeds max_length "
                             f"{self._max_length}")
        emb = self.word_embed(input_ids) + self.token_type_embed(token_types)
        emb = self.embed_dropout(self.embed_ln(
            emb + self.position_weight[:T][None]))
        mask = None
        if valid_length is not None:
            ar = torch.arange(T, device=emb.device).reshape(1, -1)
            mask = (ar < valid_length.reshape(-1, 1)).float()
        seq = self.encoder(emb, mask)
        return seq, self.pooler(seq[:, 0])


class BERTForPretrain(HybridBlock):
    """MLM and NSP heads over a :class:`BERTModel` (GluonNLP's
    ``BERTForPretrain``), on the encoder's device.  ``forward(input_ids,
    token_types, valid_length=None)`` -> (mlm_scores (B, T, vocab),
    nsp_scores (B, 2))."""

    def __init__(self, bert: BERTModel, vocab_size=30522, **kwargs):
        super().__init__(**kwargs)
        dev = bert.device
        units = bert._units
        self._vocab_size = int(vocab_size)
        with self.name_scope():
            self.bert = bert
            self.mlm_dense = Dense(units, units, flatten=False, device=dev)
            self.mlm_ln = LayerNorm(units, device=dev)
            self.mlm_decoder = Dense(vocab_size, units, flatten=False,
                                     device=dev)
            self.nsp_classifier = Dense(2, units, device=dev)
        self.eval()

    def forward(self, input_ids, token_types, valid_length=None):
        seq, pooled = self.bert(input_ids, token_types, valid_length)
        h = gelu(self.mlm_dense(seq))
        return self.mlm_decoder(self.mlm_ln(h)), self.nsp_classifier(pooled)


class MLMPretrainLoss(HybridBlock):
    """Masked-LM cross-entropy over the flattened (B*T, vocab) scores."""

    def __init__(self, vocab_size, **kwargs):
        super().__init__(**kwargs)
        self._vocab_size = int(vocab_size)
        with self.name_scope():
            self.ce = SoftmaxCrossEntropyLoss()

    def forward(self, mlm_scores, labels):
        return self.ce(mlm_scores.reshape(-1, self._vocab_size),
                       labels.reshape(-1))


class BERTPretrainLoss(HybridBlock):
    """Masked-LM CE + next-sentence CE.  ``labels`` (B, T+1) packs both:
    ``labels[:, :T]`` the per-token MLM targets, ``labels[:, T]`` the NSP
    class.  Returns the scalar mean MLM loss + mean NSP loss."""

    def __init__(self, vocab_size, **kwargs):
        super().__init__(**kwargs)
        self._vocab_size = int(vocab_size)
        with self.name_scope():
            self.ce = SoftmaxCrossEntropyLoss()

    def forward(self, mlm_scores, nsp_scores, labels):
        mlm = self.ce(mlm_scores.reshape(-1, self._vocab_size),
                      labels[:, :-1].reshape(-1))
        nsp = self.ce(nsp_scores, labels[:, -1])
        return mlm.mean() + nsp.mean()


class BERTMLMOnly(HybridBlock):
    """A :class:`BERTForPretrain` with only its MLM scores as output (a
    one-output step for ``SPMDTrainer``); no prefix of its own, so its
    parameters keep the inner model's names."""

    def __init__(self, inner, **kwargs):
        kwargs.setdefault("prefix", "")
        super().__init__(**kwargs)
        with self.name_scope():
            self.inner = inner

    def forward(self, input_ids, token_types):
        mlm_scores, _nsp_scores = self.inner(input_ids, token_types)
        return mlm_scores


def bert_tiny(vocab_size=1024, max_length=128, **kw):
    return BERTModel(vocab_size=vocab_size, units=64, hidden_size=128,
                     num_layers=2, num_heads=2, max_length=max_length, **kw)


def bert_base(vocab_size=30522, **kw):
    return BERTModel(vocab_size=vocab_size, units=768, hidden_size=3072,
                     num_layers=12, num_heads=12, **kw)


def bert_large(vocab_size=30522, **kw):
    """BERT-large: 24 layers, 1024 units, 16 heads of 64, FFN 4096."""
    return BERTModel(vocab_size=vocab_size, units=1024, hidden_size=4096,
                     num_layers=24, num_heads=16, **kw)

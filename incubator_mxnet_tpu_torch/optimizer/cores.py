"""Optimizer update cores (counterpart of
``incubator_mxnet_tpu/optimizer/cores.py``): the same formulas, evaluated
in the same order, as in-place updates of torch tensors.  Callers run them
under ``torch.no_grad()``.

Each torch op rounds to fp32 once, as each of the JAX package's eager
ops does; the whole-tree kernels K8-K10 (``optimizer/fused.py``) are held
bit for bit (LAMB: to its stated tolerance) to these loops.  A scalar
(``lr``, ``wd``, a bias-correction denominator) may be a Python number,
which torch rounds to fp32 once as JAX weak-types it, or a 0-d fp32
tensor on the leaves' device, as the train step passes it.

Square roots go through :func:`sqrt`: torch's fp32 ``sqrt`` on the CPU is
not correctly rounded (about 0.6 % of results are 1 ulp off), while
XLA's, numpy's and CUDA's are; so on the CPU it is taken in fp64 and
rounded once to fp32, which gives the correctly rounded value.

16-bit leaves (a cast net) follow JAX's typing, which torch's promotion
does not: every operation here goes through :func:`add`, :func:`sub`,
:func:`mul` or :func:`div`, whose result has JAX's dtype.  A Python
number is weak-typed (rounded to the other operand's dtype first, as jnp
converts it: through fp32, as the kernels round it); two tensors of one
dtype stay in it; a 16-bit tensor with a fp32 one (a 0-d fp32 tensor
included, which JAX does not weak-type: the train step's lr_t, the bias
corrections) goes to fp32.  Each op computes in fp32 and rounds its
result once to that dtype, as XLA's and the kernels' do.  A rule's new
weight or state is written in place where it keeps the leaf's dtype, and
returned as a new tensor where JAX promoted it.

One exception follows XLA rather than JAX's eager ops: the reference's
train step runs under ``jax.jit``, where XLA's CPU backend computes a
bf16 operation in fp32 and rounds its result, but drops that rounding
where the next operation promotes the result to fp32 (its simplifier
removes the convert pair under ``xla_allow_excess_precision``, on by
default).  So a bf16 result read by a promoting operation is read at
fp32: it carries that value as ``_unrounded`` (only the fresh tensors the
operations here return do; a rule's weights and state never do).  fp16
operations run as fp16 on that backend and keep their roundings."""
from __future__ import annotations

import torch

__all__ = ["sqrt", "weak", "add", "sub", "mul", "div", "prep_grad", "sgd",
           "sgd_momentum", "nag_momentum", "moments", "adam", "adamw",
           "rmsprop", "adagrad", "lamb_direction", "lamb_apply"]

HALF = (torch.bfloat16, torch.float16)


# the 16-bit dtypes whose results a promoting operation reads unrounded
_ELIDED = (torch.bfloat16,)


def _rounded(r, dtype):
    """The fp32 result ``r`` of an operation of JAX dtype ``dtype``."""
    if dtype == torch.float32:
        return r
    out = r.to(dtype)
    if dtype in _ELIDED:
        out._unrounded = r
    return out


def sqrt(x):
    """The correctly rounded square root of a fp32 tensor on any device;
    of a 16-bit one, that fp32 root rounded to its dtype (as CUDA's
    ``sqrt`` of a 16-bit tensor, and the kernels, compute it)."""
    if x.dtype in HALF:
        return _rounded(sqrt(x.float()), x.dtype)
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).to(torch.float32)
    return torch.sqrt(x)


def weak(x, dtype) -> float:
    """The Python number ``x`` as JAX's weak-typed constant beside a
    tensor of ``dtype``: a 16-bit dtype's value (rounded through fp32);
    unchanged for fp32, where torch rounds it to fp32 itself."""
    if dtype in HALF:
        return float(torch.tensor(float(x), dtype=torch.float32).to(dtype))
    return x


def _wide(x):
    """``x`` as an operand of an operation that promotes it to fp32."""
    r = getattr(x, "_unrounded", None)
    return x.float() if r is None else r


def _op(f, a, b):
    """``f`` on two operands, typed as JAX types it (module docstring)."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        if a.dtype != b.dtype:
            return f(_wide(a), _wide(b))
        dt = a.dtype
        a, b = a.float(), b.float()
    elif isinstance(a, torch.Tensor):
        dt = a.dtype
        a, b = a.float(), weak(b, dt)
    else:
        dt = b.dtype
        a, b = weak(a, dt), b.float()
    return _rounded(f(a, b), dt)


def add(a, b):
    return _op(torch.add, a, b)


def sub(a, b):
    return _op(torch.sub, a, b)


def mul(a, b):
    return _op(torch.mul, a, b)


def div(a, b):
    return _op(torch.div, a, b)


def _put(dst, value):
    """``dst``'s new ``value``: written in place when it keeps ``dst``'s
    dtype (``dst`` returned), else returned as the new, promoted
    tensor."""
    if value.dtype == dst.dtype:
        dst.copy_(value)
        return dst
    return value


def prep_grad(g, rescale_grad=None, clip_gradient=None, wd=None, w=None):
    """rescale -> clip -> fold wd * w into the gradient; ``None`` skips a
    stage.  Returns a new tensor (``g`` is left as it is)."""
    if rescale_grad is not None:
        g = mul(g, rescale_grad)
    if clip_gradient is not None:
        c = weak(clip_gradient, g.dtype)
        g = torch.clamp(g, -c, c)
    if wd is not None and w is not None:
        g = add(g, mul(wd, w))
    return g


def sgd(w, g, lr):
    """w = w - lr g (g prepped, wd folded).  Returns the new w."""
    return _put(w, sub(w, mul(lr, g)))


def sgd_momentum(w, g, m, lr, momentum):
    """m = momentum m - lr g; w = w + m.  Returns (w, m)."""
    m = _put(m, sub(mul(m, momentum), mul(lr, g)))
    return _put(w, add(w, m)), m


def nag_momentum(w, g, m, lr, momentum):
    """m = momentum m + g; w = w - lr (g + momentum m).  Returns (w,
    m)."""
    m = _put(m, add(mul(m, momentum), g))
    return _put(w, sub(w, mul(lr, add(g, mul(momentum, m))))), m


def _moments(m, v, g, beta1, beta2, moments_dtype=None):
    # the new moments, fresh tensors (a bf16 one carries its fp32 value)
    b1, b2 = (beta1, beta2) if moments_dtype is None else \
        (weak(beta1, moments_dtype), weak(beta2, moments_dtype))
    return (add(mul(m, b1), mul(g, 1 - beta1)),
            add(mul(v, b2), mul(mul(g, 1 - beta2), g)))


def moments(m, v, g, beta1, beta2, moments_dtype=None):
    """Adam-family moment EMAs: m = beta1 m + (1 - beta1) g,
    v = beta2 v + (1 - beta2) g g.  Returns (m, v).

    ``moments_dtype``: the 16-bit dtype the moments had in the JAX step
    where ``m`` and ``v`` hold them at fp32 (the step after a promoting
    one, the moments read as fp32): beta1 m and beta2 v take beta1 and
    beta2 rounded to it, as the JAX step's weak typing does, and keep the
    product at fp32 (XLA, bf16; the module docstring)."""
    nm, nv = _moments(m, v, g, beta1, beta2, moments_dtype)
    return _put(m, nm), _put(v, nv)


def adam(w, g, m, v, lr, beta1, beta2, epsilon, moments_dtype=None):
    """Adam: ``lr`` arrives pre-scaled by the bias correction
    sqrt(1 - beta2^t) / (1 - beta1^t), and wd is already folded into
    ``g`` by :func:`prep_grad`; w -= lr m / (sqrt(v) + epsilon).  Returns
    (w, m, v); ``moments_dtype`` as :func:`moments`'."""
    nm, nv = _moments(m, v, g, beta1, beta2, moments_dtype)
    nw = sub(w, div(mul(nm, lr), add(sqrt(nv), epsilon)))
    return _put(w, nw), _put(m, nm), _put(v, nv)


def adamw(w, g, m, v, lr, wd, beta1, beta2, epsilon, coef1, coef2,
          moments_dtype=None):
    """AdamW (decoupled weight decay): ``coef1``/``coef2`` are the bias
    correction's denominators 1 - beta1^t and 1 - beta2^t;
    w -= lr (m / coef1 / (sqrt(v / coef2) + epsilon) + wd w).  Returns
    (w, m, v); ``moments_dtype`` as :func:`moments`'."""
    nm, nv = _moments(m, v, g, beta1, beta2, moments_dtype)
    dirn = div(div(nm, coef1), add(sqrt(div(nv, coef2)), epsilon))
    nw = sub(w, mul(lr, add(dirn, mul(wd, w))))
    return _put(w, nw), _put(m, nm), _put(v, nv)


def rmsprop(w, g, n, lr, gamma1, epsilon):
    """Non-centered RMSProp, epsilon inside the sqrt, wd folded into g:
    n = (1 - gamma1) g g + gamma1 n; w -= lr g / sqrt(n + epsilon).
    Returns (w, n)."""
    t = mul(mul(g, 1 - gamma1), g)
    n = _put(n, add(mul(n, gamma1), t))
    return _put(w, sub(w, div(mul(lr, g), sqrt(add(n, epsilon))))), n


def adagrad(w, g, h, lr, epsilon, wd):
    """AdaGrad, decoupled wd, epsilon inside the sqrt: h = h + g g;
    w -= lr (g / sqrt(h + epsilon) + wd w).  Returns (w, h)."""
    h = _put(h, add(h, mul(g, g)))
    dirn = div(g, sqrt(add(h, epsilon)))
    return _put(w, sub(w, mul(lr, add(dirn, mul(wd, w))))), h


def lamb_direction(w, g, m, v, beta1, beta2, epsilon, wd, coef1, coef2,
                   moments_dtype=None):
    """LAMB's first phase: the moments in place, then the update
    direction u = m / coef1 / (sqrt(v / coef2) + epsilon) + wd w (a new
    tensor).  Without bias correction the denominators are 1, and a
    division by 1 changes no bit.  ``moments_dtype`` as
    :func:`moments`'."""
    nm, nv = _moments(m, v, g, beta1, beta2, moments_dtype)
    u = add(div(div(nm, coef1), add(sqrt(div(nv, coef2)), epsilon)),
            mul(wd, w))
    _put(m, nm)
    _put(v, nv)
    return u


def _norm(x):
    """||x||; of a 16-bit x as the JAX step's XLA computes it: the squares
    summed at fp32, the sum rounded to x's dtype, its root a 16-bit
    operation (which a promoting operation reads unrounded)."""
    if x.dtype in HALF:
        xf = x.float()
        return sqrt(_rounded(torch.sum(xf * xf), x.dtype))
    return torch.linalg.vector_norm(x)


def lamb_apply(w, u, lr, lower_bound=None, upper_bound=None):
    """LAMB's second phase: r1 = ||w|| (clamped to each bound that is
    given and > 0, as the reference), r2 = ||u||, ratio r1 / r2 where
    both are > 0, else 1; w -= (lr ratio) u.  Returns the new w."""
    r1, r2 = _norm(w), _norm(u)
    if lower_bound is not None and lower_bound > 0:
        r1 = torch.clamp(r1, min=lower_bound)
    if upper_bound is not None and upper_bound > 0:
        r1 = torch.clamp(r1, max=upper_bound)
    ratio = torch.where((r1 > 0) & (r2 > 0), div(r1, r2),
                        torch.ones((), dtype=torch.promote_types(
                            r1.dtype, r2.dtype), device=r1.device))
    return _put(w, sub(w, mul(mul(lr, ratio), u)))

"""Windowed causal local attention with its gradient: the CUDA kernels
and their plain versions.

* ``local_attention_fwd`` (A1) replaces the TPU kernel
  ``progen_tpu/ops/pallas_attention.py:_fwd`` (body ``_fwd_kernel``). It
  computes exactly what that kernel computes: query window i sees
  [window i-1 | window i] with the mask ``j <= i + w``; window 0's
  previous window is zeros that still count in the softmax; scores,
  softmax and P·V in float32 (P is NOT rounded to the input dtype, unlike
  the plain ``ops/attention.py:local_attention``); the output in q's
  dtype. Kernel: ``csrc/local_attention_fwd.cu``.
* ``local_attention_bwd_kv`` (A2) replaces ``_bwd_core``'s kv branch
  (body ``_bwd_kv_kernel_batched``): for key window j, recompute the
  softmax rows of query windows j and j+1; dq_j from row j, dk_j and dv_j
  from row j's current half plus row j+1's previous half; the last window
  has no row j+1. Kernel: ``csrc/local_attention_bwd_kv.cu``.
* ``local_attention_bwd_halo`` (A3) replaces ``_bwd_core``'s halo branch
  (body ``_bwd_kernel``): per query window, dq plus float32 dk2/dv2 for
  its [prev | cur] keys, resolved by the shifted add ``_halo_combine``
  (``combine`` in ``_bwd_core``), which drops program 0's previous half.
  Kernel: ``csrc/local_attention_bwd_halo.cu``; the combine and the cast
  run here in PyTorch, outside the kernel, as they run in XLA there.
* ``local_attention`` is the differentiable op (``jax.custom_vjp`` there,
  a ``torch.autograd.Function`` here): forward A1, backward A2 for
  ``bwd_impl="kv"`` or A3 for ``"halo"``. The TPU's ``"kv_g<N>"`` and
  ``"xla"`` are scheduling choices with no counterpart here.

On the CPU each wrapper runs its plain version (``*_reference``); on the
card it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from progen_tpu_torch.ops import _build
from progen_tpu_torch.ops.attention import (
    ATTN_MASK_VALUE,
    _window_mask,
    with_prev_window,
)
from progen_tpu_torch.ops.dispatch import check_same_device, takes_kernel

KERNEL_DIM_HEADS = (16, 32, 64, 128)
BWD_IMPLS = ("kv", "halo")


def _windows(t: torch.Tensor, w: int) -> torch.Tensor:
    """(b, h, n, d) -> float32 (b, h, n/w, w, d)."""
    b, h, n, d = t.shape
    if n % w != 0:
        raise ValueError(f"sequence length {n} not divisible by window {w}")
    return t.float().reshape(b, h, n // w, w, d)


def _softmax_rows(qw, k2, w: int, scale: float):
    """(.., w, d) x (.., 2w, d) float32 -> (.., w, 2w) masked softmax, as
    ``_softmax_rows_batched`` computes it."""
    s = torch.einsum("...id,...jd->...ij", qw, k2) * scale
    s = s.masked_fill(~_window_mask(w, qw.device), ATTN_MASK_VALUE)
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    return e / e.sum(dim=-1, keepdim=True)


def _ds(p, dow, v2):
    """The softmax backward, as ``_ds_from_batched``: ds = p * (dp - delta)
    with delta = sum(dp * p) over the row, in float32."""
    dp = torch.einsum("...id,...jd->...ij", dow, v2)
    return p * (dp - (dp * p).sum(dim=-1, keepdim=True))


def _t_product(a, b):
    """a^T b per window: (.., w, m) x (.., w, d) -> (.., m, d)."""
    return torch.einsum("...im,...id->...md", a, b)


def local_attention_fwd_reference(q, k, v, window_size, scale=None):
    """Plain float32 version of the kernel: (b, h, n, d) -> (b, h, n, d)
    in q.dtype."""
    b, h, n, d = q.shape
    w = window_size
    if scale is None:
        scale = d ** -0.5
    qw = _windows(q, w)
    k2 = with_prev_window(_windows(k, w), None)
    v2 = with_prev_window(_windows(v, w), None)
    p = _softmax_rows(qw, k2, w, scale)
    o = torch.einsum("bhwij,bhwjd->bhwid", p, v2)
    return o.to(q.dtype).reshape(b, h, n, d)


def local_attention_bwd_kv_reference(q, k, v, do, window_size, scale=None):
    """Plain version of A2, in the TPU kernel's structure: program j
    recomputes the softmax rows of windows j ([k_{j-1} | k_j]) and j+1
    ([k_j | k_{j+1}], clamped at the last window and masked out there by
    ``has_next``). Returns (dq, dk, dv), each (b, h, n, d) in its input's
    dtype."""
    b, h, n, d = q.shape
    w = window_size
    if scale is None:
        scale = d ** -0.5
    qw, kw, vw, dow = (_windows(t, w) for t in (q, k, v, do))
    nw = qw.shape[2]

    # row j: window 0's previous half is the phantom zero keys
    k2 = with_prev_window(kw, None)
    v2 = with_prev_window(vw, None)
    p = _softmax_rows(qw, k2, w, scale)
    ds = _ds(p, dow, v2)
    dq = torch.einsum("...ij,...jd->...id", ds, k2) * scale
    dk = _t_product(ds[..., w:], qw) * scale
    dv = _t_product(p[..., w:], dow)

    # row j+1: the program of the last window reads itself again (the
    # clamped index map) and has_next zeroes what it gives
    def nxt(t):
        return torch.cat((t[:, :, 1:], t[:, :, -1:]), dim=2)

    qn, don = nxt(qw), nxt(dow)
    k2n = torch.cat((kw, nxt(kw)), dim=3)
    v2n = torch.cat((vw, nxt(vw)), dim=3)
    pn = _softmax_rows(qn, k2n, w, scale)
    dsn = _ds(pn, don, v2n)
    has_next = (torch.arange(nw, device=q.device) < nw - 1).float()
    has_next = has_next[:, None, None]
    dk = dk + has_next * _t_product(dsn[..., :w], qn) * scale
    dv = dv + has_next * _t_product(pn[..., :w], don)
    return (dq.to(q.dtype).reshape(b, h, n, d),
            dk.to(k.dtype).reshape(b, h, n, d),
            dv.to(v.dtype).reshape(b, h, n, d))


def _halo_combine(d2: torch.Tensor, w: int) -> torch.Tensor:
    """(b, h, nw, 2w, d) [prev | cur] gradients -> (b, h, n, d): window i
    gets program i's current half plus program i+1's previous half;
    program 0's previous half (the phantom keys) is dropped."""
    b, h, nw, _, d = d2.shape
    cur = d2[:, :, :, w:]
    nxt = torch.cat((d2[:, :, 1:, :w], torch.zeros_like(d2[:, :, :1, :w])),
                    dim=2)
    return (cur + nxt).reshape(b, h, nw * w, d)


def local_attention_bwd_halo_reference(q, k, v, do, window_size,
                                       scale=None):
    """Plain version of A3, in the TPU kernel's structure: each window's
    dq and float32 dk2/dv2 for its [prev | cur] keys, then the shifted-add
    combine. Returns (dq, dk, dv), each (b, h, n, d) in its input's
    dtype."""
    b, h, n, d = q.shape
    w = window_size
    if scale is None:
        scale = d ** -0.5
    qw, kw, vw, dow = (_windows(t, w) for t in (q, k, v, do))
    k2 = with_prev_window(kw, None)
    v2 = with_prev_window(vw, None)
    p = _softmax_rows(qw, k2, w, scale)
    ds = _ds(p, dow, v2)
    dq = torch.einsum("...ij,...jd->...id", ds, k2) * scale
    dk2 = _t_product(ds, qw) * scale
    dv2 = _t_product(p, dow)
    return (dq.to(q.dtype).reshape(b, h, n, d),
            _halo_combine(dk2, w).to(k.dtype),
            _halo_combine(dv2, w).to(v.dtype))


def _check_operands(window_size, *ts):
    """The kernels' common contract: one shape (b, h, n, d), one dtype,
    one device, n % w == 0, a dim_head the kernels are built for."""
    b, h, n, d = ts[0].shape
    if any(t.shape != ts[0].shape for t in ts):
        raise ValueError("q, k, v (and dO) must have one shape")
    if any(t.dtype != ts[0].dtype for t in ts):
        raise TypeError("q, k, v (and dO) must have one dtype")
    check_same_device(*ts)
    if n % window_size != 0:
        raise ValueError(f"sequence length {n} not divisible by window "
                         f"{window_size}")
    if d not in KERNEL_DIM_HEADS:
        raise ValueError(f"kernel takes dim_head in {KERNEL_DIM_HEADS}, "
                         f"got {d}")
    return b, h, n, d


def local_attention_fwd(q, k, v, window_size, scale=None):
    """q, k, v: (batch, heads, n, dim_head), one dtype, n % window == 0.
    Returns (batch, heads, n, dim_head) in q.dtype."""
    if not takes_kernel(q):
        return local_attention_fwd_reference(q, k, v, window_size, scale)
    b, h, n, d = _check_operands(window_size, q, k, v)
    if scale is None:
        scale = d ** -0.5
    q, k, v = (t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    _build.launch(
        "local_attention_fwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b * h, n, window_size, d, float(scale), _build.dtype_code(q),
    )
    local_attention_fwd.launches += 1
    return out


local_attention_fwd.launches = 0


def local_attention_bwd_kv(q, k, v, do, window_size, scale=None):
    """A2: (dq, dk, dv) of ``local_attention_fwd`` given the output's
    gradient ``do``; all (batch, heads, n, dim_head) in one dtype."""
    if not takes_kernel(q):
        return local_attention_bwd_kv_reference(q, k, v, do, window_size,
                                                scale)
    b, h, n, d = _check_operands(window_size, q, k, v, do)
    if scale is None:
        scale = d ** -0.5
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stats = torch.empty((b * h, n, 4), dtype=torch.float32, device=q.device)
    _build.launch(
        "local_attention_bwd_kv", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        b * h, n, window_size, d, float(scale), _build.dtype_code(q),
    )
    local_attention_bwd_kv.launches += 1
    return dq, dk, dv


local_attention_bwd_kv.launches = 0


def local_attention_bwd_halo(q, k, v, do, window_size, scale=None):
    """A3: (dq, dk, dv) of ``local_attention_fwd`` through the float32
    halo scratch and the shifted-add combine."""
    if not takes_kernel(q):
        return local_attention_bwd_halo_reference(q, k, v, do, window_size,
                                                  scale)
    b, h, n, d = _check_operands(window_size, q, k, v, do)
    if scale is None:
        scale = d ** -0.5
    w, nw = window_size, n // window_size
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    dq = torch.empty_like(q)
    dk2, dv2 = (torch.empty((b, h, nw, 2 * w, d), dtype=torch.float32,
                            device=q.device) for _ in range(2))
    stats = torch.empty((b * h, n, 4), dtype=torch.float32, device=q.device)
    _build.launch(
        "local_attention_bwd_halo", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk2.data_ptr(), dv2.data_ptr(), stats.data_ptr(),
        b * h, n, w, d, float(scale), _build.dtype_code(q),
    )
    local_attention_bwd_halo.launches += 1
    return (dq, _halo_combine(dk2, w).to(k.dtype),
            _halo_combine(dv2, w).to(v.dtype))


local_attention_bwd_halo.launches = 0


class _LocalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window_size, scale, bwd_impl):
        ctx.save_for_backward(q, k, v)
        ctx.window_size, ctx.scale, ctx.bwd_impl = window_size, scale, \
            bwd_impl
        return local_attention_fwd(q, k, v, window_size, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        bwd = (local_attention_bwd_kv if ctx.bwd_impl == "kv"
               else local_attention_bwd_halo)
        dq, dk, dv = bwd(q, k, v, do, ctx.window_size, ctx.scale)
        return dq, dk, dv, None, None, None


def local_attention(q, k, v, window_size, scale=None, bwd_impl="kv"):
    """Differentiable windowed causal local attention: q, k, v (batch,
    heads, n, dim_head) -> (batch, heads, n, dim_head) in q.dtype. The
    forward is A1; the backward A2 (``bwd_impl="kv"``, the JAX package's
    default) or A3 (``"halo"``)."""
    if bwd_impl not in BWD_IMPLS:
        # at the call site, not at the first backward
        raise ValueError(f"unknown bwd_impl {bwd_impl!r}")
    return _LocalAttention.apply(q, k, v, window_size, scale, bwd_impl)

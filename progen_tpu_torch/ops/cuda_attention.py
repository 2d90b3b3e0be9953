"""Windowed causal local attention with its gradient: the CUDA kernels
and their plain versions.

* ``local_attention_fwd`` (A1) replaces the TPU kernel
  ``progen_tpu/ops/pallas_attention.py:_fwd`` (body ``_fwd_kernel``). It
  computes exactly what that kernel computes: query window i sees
  [window i-1 | window i] with the mask ``j <= i + w``; window 0's
  previous window is zeros that still count in the softmax; scores and
  softmax in float32, the output in q's dtype. The plain version, like the
  TPU kernel, takes P·V in float32 (P is NOT rounded to the input dtype,
  unlike the plain ``ops/attention.py:local_attention``). Kernel:
  ``csrc/local_attention_fwd.cu``.
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
* ``local_attention_halo_fwd``, ``local_attention_halo_bwd_kv`` and
  ``local_attention_halo_bwd_halo`` (A4) replace
  ``pallas_local_attention_halo`` (``pallas_attention.py:731``): the same
  three kernels with two more operands, ``halo_k`` and ``halo_v`` (b, h,
  w, d), which take the place of window 0's phantom zero keys. A sequence
  shard gets them from its left neighbour
  (``parallel/ring_attention.py``). Both backwards leave the halo's
  previous half of row 0 out of dk and dv, as the TPU kernels do; the
  halo's own gradient is ``halo_grads``, a recompute of window 0 in plain
  PyTorch on every device, as ``_halo_grads`` runs in XLA outside any
  kernel there.
* ``local_attention`` is the differentiable op (``jax.custom_vjp`` there,
  a ``torch.autograd.Function`` here): forward A1, backward A2 for
  ``bwd_impl="kv"`` or A3 for ``"halo"``; with ``halo_k`` and ``halo_v``
  the A4 forms of the three, plus ``halo_grads``, so it returns five
  gradients. The TPU's ``"kv_g<N>"`` and ``"xla"`` are scheduling choices
  with no counterpart here.

On the CPU each wrapper runs its plain version (``*_reference``); on the
card it launches its kernel or raises. In bfloat16 and float16 every
kernel (A1 to A4) runs its products on the tensor cores, where the plain
versions (and the TPU kernels) keep P and dS in float32: the backwards
round P and dS to the input dtype before the dV, dK and dQ products; the
forward carries P into P·V as two input-dtype parts (its rounding and the
rounded remainder, about 16 significant bits in bfloat16) and sums the
softmax's denominator from the float32 P. In float32 the kernels run on
the FMA units, all in float32.
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


def local_attention_fwd_reference(q, k, v, window_size, scale=None,
                                  halo_k=None, halo_v=None):
    """Plain float32 version of the kernel: (b, h, n, d) -> (b, h, n, d)
    in q.dtype. ``halo_k``/``halo_v`` (b, h, w, d), when given, are window
    0's previous keys and values (A4) in place of the phantom zeros."""
    b, h, n, d = q.shape
    w = window_size
    if scale is None:
        scale = d ** -0.5
    qw = _windows(q, w)
    k2 = with_prev_window(_windows(k, w), halo_k)
    v2 = with_prev_window(_windows(v, w), halo_v)
    p = _softmax_rows(qw, k2, w, scale)
    o = torch.einsum("bhwij,bhwjd->bhwid", p, v2)
    return o.to(q.dtype).reshape(b, h, n, d)


def local_attention_bwd_kv_reference(q, k, v, do, window_size, scale=None,
                                     halo_k=None, halo_v=None):
    """Plain version of A2, in the TPU kernel's structure: program j
    recomputes the softmax rows of windows j ([k_{j-1} | k_j]) and j+1
    ([k_j | k_{j+1}], clamped at the last window and masked out there by
    ``has_next``). Returns (dq, dk, dv), each (b, h, n, d) in its input's
    dtype; with a halo (A4), no gradient of it (see ``halo_grads``)."""
    b, h, n, d = q.shape
    w = window_size
    if scale is None:
        scale = d ** -0.5
    qw, kw, vw, dow = (_windows(t, w) for t in (q, k, v, do))
    nw = qw.shape[2]

    # row j: window 0's previous half is the halo or the phantom zero keys
    k2 = with_prev_window(kw, halo_k)
    v2 = with_prev_window(vw, halo_v)
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


def _halo_combine(d2: torch.Tensor, w: int, dtype=None) -> torch.Tensor:
    """(b, h, nw, 2w, d) [prev | cur] gradients -> (b, h, n, d) in
    ``dtype`` (d2's by default): window i gets program i's current half
    plus program i+1's previous half, summed in d2's dtype and rounded
    once; program 0's previous half (the phantom keys) is dropped. One add
    that writes the rounded sum and one copy of the last window."""
    b, h, nw, _, d = d2.shape
    out = torch.empty((b, h, nw, w, d), dtype=dtype or d2.dtype,
                      device=d2.device)
    torch.add(d2[:, :, :-1, w:], d2[:, :, 1:, :w], out=out[:, :, :-1])
    out[:, :, -1] = d2[:, :, -1, w:]
    return out.reshape(b, h, nw * w, d)


def local_attention_bwd_halo_reference(q, k, v, do, window_size,
                                       scale=None, halo_k=None, halo_v=None):
    """Plain version of A3, in the TPU kernel's structure: each window's
    dq and float32 dk2/dv2 for its [prev | cur] keys, then the shifted-add
    combine. Returns (dq, dk, dv), each (b, h, n, d) in its input's
    dtype; with a halo (A4), no gradient of it (the combine drops program
    0's previous half; see ``halo_grads``)."""
    b, h, n, d = q.shape
    w = window_size
    if scale is None:
        scale = d ** -0.5
    qw, kw, vw, dow = (_windows(t, w) for t in (q, k, v, do))
    k2 = with_prev_window(kw, halo_k)
    v2 = with_prev_window(vw, halo_v)
    p = _softmax_rows(qw, k2, w, scale)
    ds = _ds(p, dow, v2)
    dq = torch.einsum("...ij,...jd->...id", ds, k2) * scale
    dk2 = _t_product(ds, qw) * scale
    dv2 = _t_product(p, dow)
    return (dq.to(q.dtype).reshape(b, h, n, d),
            _halo_combine(dk2, w, k.dtype), _halo_combine(dv2, w, v.dtype))


def local_attention_halo_fwd_reference(q, k, v, halo_k, halo_v,
                                       window_size, scale=None):
    """Plain version of A4's forward."""
    return local_attention_fwd_reference(q, k, v, window_size, scale,
                                         halo_k, halo_v)


def local_attention_halo_bwd_kv_reference(q, k, v, halo_k, halo_v, do,
                                          window_size, scale=None):
    """Plain version of A4's kv-centric backward: (dq, dk, dv)."""
    return local_attention_bwd_kv_reference(q, k, v, do, window_size, scale,
                                            halo_k, halo_v)


def local_attention_halo_bwd_halo_reference(q, k, v, halo_k, halo_v, do,
                                            window_size, scale=None):
    """Plain version of A4's q-centric backward: (dq, dk, dv)."""
    return local_attention_bwd_halo_reference(q, k, v, do, window_size,
                                              scale, halo_k, halo_v)


def halo_grads(q, k, v, halo_k, halo_v, do, window_size, scale=None):
    """(d halo_k, d halo_v), each (b, h, w, d) in its halo's dtype: only
    window 0's softmax row reads the halo, so its gradient is one (w, 2w)
    float32 recompute of that row, as ``_halo_grads``
    (``pallas_attention.py:570``) computes it in XLA outside the kernels.
    Plain PyTorch on the CPU and on the card alike."""
    w = window_size
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q0, do0 = q[:, :, :w].float(), do[:, :, :w].float()
    k2 = torch.cat((halo_k.float(), k[:, :, :w].float()), dim=2)
    v2 = torch.cat((halo_v.float(), v[:, :, :w].float()), dim=2)
    p = _softmax_rows(q0, k2, w, scale)
    ds = _ds(p, do0, v2)
    return ((_t_product(ds[..., :w], q0) * scale).to(halo_k.dtype),
            _t_product(p[..., :w], do0).to(halo_v.dtype))


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


def _check_halo(q, halo_k, halo_v, window_size):
    """Both halos or neither; each (b, h, w, d) in q's dtype and device."""
    if (halo_k is None) != (halo_v is None):
        raise ValueError("give both halo_k and halo_v, or neither")
    if halo_k is None:
        return
    b, h, _, d = q.shape
    for t in (halo_k, halo_v):
        if t.shape != (b, h, window_size, d):
            raise ValueError(f"halo must be ({b}, {h}, {window_size}, {d}), "
                             f"got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError("halo must have q's dtype")
    check_same_device(q, halo_k, halo_v)


def _ptrs(*ts):
    """Each tensor's data pointer; None (NULL) for an absent halo."""
    return [None if t is None else t.data_ptr() for t in ts]


def _fwd(q, k, v, window_size, scale, halo_k=None, halo_v=None):
    """Launch A1 (no halo) or A4's forward."""
    b, h, n, d = _check_operands(window_size, q, k, v)
    _check_halo(q, halo_k, halo_v, window_size)
    if scale is None:
        scale = d ** -0.5
    q, k, v = (_build.aligned16(t) for t in (q, k, v))
    hk, hv = (None if t is None else _build.aligned16(t)
              for t in (halo_k, halo_v))
    out = torch.empty_like(q)
    _build.launch(
        "local_attention_fwd", q.device,
        *_ptrs(q, k, v, hk, hv, out),
        b * h, n, window_size, d, float(scale), _build.dtype_code(q),
    )
    return out


def local_attention_fwd(q, k, v, window_size, scale=None):
    """q, k, v: (batch, heads, n, dim_head), one dtype, n % window == 0.
    Returns (batch, heads, n, dim_head) in q.dtype."""
    if not takes_kernel(q):
        return local_attention_fwd_reference(q, k, v, window_size, scale)
    out = _fwd(q, k, v, window_size, scale)
    local_attention_fwd.launches += 1
    return out


local_attention_fwd.launches = 0


def local_attention_halo_fwd(q, k, v, halo_k, halo_v, window_size,
                             scale=None):
    """A4's forward: ``local_attention_fwd`` with window 0's previous keys
    and values ``halo_k``, ``halo_v`` (batch, heads, window, dim_head) in
    q's dtype."""
    if not takes_kernel(q):
        return local_attention_halo_fwd_reference(q, k, v, halo_k, halo_v,
                                                  window_size, scale)
    out = _fwd(q, k, v, window_size, scale, halo_k, halo_v)
    local_attention_halo_fwd.launches += 1
    return out


local_attention_halo_fwd.launches = 0


def _bwd(name, q, k, v, do, window_size, scale, halo_k=None, halo_v=None):
    """Launch A2 or A3 (``name``), without or with a halo. Returns dq and
    the kernel's dk, dv outputs (A3: the float32 scratch, not combined)."""
    b, h, n, d = _check_operands(window_size, q, k, v, do)
    _check_halo(q, halo_k, halo_v, window_size)
    if scale is None:
        scale = d ** -0.5
    w, nw = window_size, n // window_size
    q, k, v, do = (_build.aligned16(t) for t in (q, k, v, do))
    hk, hv = (None if t is None else _build.aligned16(t)
              for t in (halo_k, halo_v))
    dq = torch.empty_like(q)
    if name == "local_attention_bwd_kv":
        dk, dv = torch.empty_like(k), torch.empty_like(v)
    else:
        dk, dv = (torch.empty((b, h, nw, 2 * w, d), dtype=torch.float32,
                              device=q.device) for _ in range(2))
    stats = torch.empty((b * h, n, 4), dtype=torch.float32, device=q.device)
    _build.launch(
        name, q.device, *_ptrs(q, k, v, hk, hv, do, dq, dk, dv, stats),
        b * h, n, w, d, float(scale), _build.dtype_code(q),
    )
    return dq, dk, dv


def local_attention_bwd_kv(q, k, v, do, window_size, scale=None):
    """A2: (dq, dk, dv) of ``local_attention_fwd`` given the output's
    gradient ``do``; all (batch, heads, n, dim_head) in one dtype."""
    if not takes_kernel(q):
        return local_attention_bwd_kv_reference(q, k, v, do, window_size,
                                                scale)
    out = _bwd("local_attention_bwd_kv", q, k, v, do, window_size, scale)
    local_attention_bwd_kv.launches += 1
    return out


local_attention_bwd_kv.launches = 0


def local_attention_halo_bwd_kv(q, k, v, halo_k, halo_v, do, window_size,
                                scale=None):
    """A4's kv-centric backward: (dq, dk, dv) of
    ``local_attention_halo_fwd``; the halo's gradient is ``halo_grads``."""
    if not takes_kernel(q):
        return local_attention_halo_bwd_kv_reference(
            q, k, v, halo_k, halo_v, do, window_size, scale)
    out = _bwd("local_attention_bwd_kv", q, k, v, do, window_size, scale,
               halo_k, halo_v)
    local_attention_halo_bwd_kv.launches += 1
    return out


local_attention_halo_bwd_kv.launches = 0


def _combined(k, v, dq, dk2, dv2, window_size):
    """A3's outputs with the float32 scratch combined and cast."""
    return (dq, _halo_combine(dk2, window_size, k.dtype),
            _halo_combine(dv2, window_size, v.dtype))


def local_attention_bwd_halo(q, k, v, do, window_size, scale=None):
    """A3: (dq, dk, dv) of ``local_attention_fwd`` through the float32
    halo scratch and the shifted-add combine."""
    if not takes_kernel(q):
        return local_attention_bwd_halo_reference(q, k, v, do, window_size,
                                                  scale)
    out = _bwd("local_attention_bwd_halo", q, k, v, do, window_size, scale)
    local_attention_bwd_halo.launches += 1
    return _combined(k, v, *out, window_size)


local_attention_bwd_halo.launches = 0


def local_attention_halo_bwd_halo(q, k, v, halo_k, halo_v, do, window_size,
                                  scale=None):
    """A4's q-centric backward: (dq, dk, dv) of
    ``local_attention_halo_fwd``; the combine drops program 0's previous
    half, and the halo's gradient is ``halo_grads``."""
    if not takes_kernel(q):
        return local_attention_halo_bwd_halo_reference(
            q, k, v, halo_k, halo_v, do, window_size, scale)
    out = _bwd("local_attention_bwd_halo", q, k, v, do, window_size, scale,
               halo_k, halo_v)
    local_attention_halo_bwd_halo.launches += 1
    return _combined(k, v, *out, window_size)


local_attention_halo_bwd_halo.launches = 0


class _LocalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, halo_k, halo_v, window_size, scale, bwd_impl):
        ctx.save_for_backward(q, k, v, halo_k, halo_v)
        ctx.window_size, ctx.scale, ctx.bwd_impl = window_size, scale, \
            bwd_impl
        if halo_k is None:
            return local_attention_fwd(q, k, v, window_size, scale)
        return local_attention_halo_fwd(q, k, v, halo_k, halo_v, window_size,
                                        scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v, hk, hv = ctx.saved_tensors
        w, scale = ctx.window_size, ctx.scale
        if hk is None:
            bwd = (local_attention_bwd_kv if ctx.bwd_impl == "kv"
                   else local_attention_bwd_halo)
            return (*bwd(q, k, v, do, w, scale), None, None, None, None,
                    None)
        bwd = (local_attention_halo_bwd_kv if ctx.bwd_impl == "kv"
               else local_attention_halo_bwd_halo)
        return (*bwd(q, k, v, hk, hv, do, w, scale),
                *halo_grads(q, k, v, hk, hv, do, w, scale), None, None, None)


def local_attention(q, k, v, window_size, scale=None, bwd_impl="kv",
                    halo_k=None, halo_v=None):
    """Differentiable windowed causal local attention: q, k, v (batch,
    heads, n, dim_head) -> (batch, heads, n, dim_head) in q.dtype. The
    forward is A1; the backward A2 (``bwd_impl="kv"``, the JAX package's
    default) or A3 (``"halo"``). With ``halo_k`` and ``halo_v`` (batch,
    heads, window, dim_head), window 0's previous keys and values, the
    three run as A4 and the halos get their gradients too."""
    if bwd_impl not in BWD_IMPLS:
        # at the call site, not at the first backward
        raise ValueError(f"unknown bwd_impl {bwd_impl!r}")
    if (halo_k is None) != (halo_v is None):
        raise ValueError("give both halo_k and halo_v, or neither")
    return _LocalAttention.apply(q, k, v, halo_k, halo_v, window_size, scale,
                                 bwd_impl)

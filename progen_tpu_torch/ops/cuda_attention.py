"""Windowed causal local-attention forward: the CUDA kernel and its plain
version.

``local_attention_fwd`` replaces the TPU kernel
``progen_tpu/ops/pallas_attention.py:_fwd`` (body ``_fwd_kernel``). It
computes exactly what that kernel computes: query window i sees
[window i-1 | window i] with the mask ``j <= i + w``; window 0's previous
window is zeros that still count in the softmax; scores, softmax and P·V
in float32 (P is NOT rounded to the input dtype, unlike the plain
``ops/attention.py:local_attention``); the output in q's dtype.

The kernel is ``csrc/local_attention_fwd.cu``. On the CPU the wrapper
runs ``local_attention_fwd_reference``.
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


def local_attention_fwd_reference(q, k, v, window_size, scale=None):
    """Plain float32 version of the kernel: (b, h, n, d) -> (b, h, n, d)
    in q.dtype."""
    b, h, n, d = q.shape
    w = window_size
    if n % w != 0:
        raise ValueError(f"sequence length {n} not divisible by window {w}")
    nw = n // w
    if scale is None:
        scale = d ** -0.5
    qw = q.float().reshape(b, h, nw, w, d)
    k2 = with_prev_window(k.float().reshape(b, h, nw, w, d), None)
    v2 = with_prev_window(v.float().reshape(b, h, nw, w, d), None)
    s = torch.einsum("bhwid,bhwjd->bhwij", qw, k2) * scale
    s = s.masked_fill(~_window_mask(w, q.device), ATTN_MASK_VALUE)
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = e / e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhwij,bhwjd->bhwid", p, v2)
    return o.to(q.dtype).reshape(b, h, n, d)


def local_attention_fwd(q, k, v, window_size, scale=None):
    """q, k, v: (batch, heads, n, dim_head), one dtype, n % window == 0.
    Returns (batch, heads, n, dim_head) in q.dtype."""
    if not takes_kernel(q):
        return local_attention_fwd_reference(q, k, v, window_size, scale)
    b, h, n, d = q.shape
    w = window_size
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must have one shape")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must have one dtype")
    check_same_device(q, k, v)
    if n % w != 0:
        raise ValueError(f"sequence length {n} not divisible by window {w}")
    if d not in KERNEL_DIM_HEADS:
        raise ValueError(f"kernel takes dim_head in {KERNEL_DIM_HEADS}, "
                         f"got {d}")
    if scale is None:
        scale = d ** -0.5
    q, k, v = (t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    _build.launch(
        "local_attention_fwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b * h, n, w, d, float(scale), _build.dtype_code(q),
    )
    local_attention_fwd.launches += 1
    return out


local_attention_fwd.launches = 0

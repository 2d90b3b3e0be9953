"""Fused layer kernels: norm + token shift, and the SGU tail.

* ``norm_shift`` replaces ``progen_tpu/ops/pallas_layers.py:
  _norm_shift_pallas`` (body ``_norm_shift_kernel``): scale-only
  LayerNorm with float32 stats and ``var = max(0, E[x^2] - E[x]^2)``,
  then the first ``d - d//2`` channels shifted down one row (row 0
  zero). Kernel: ``csrc/norm_shift.cu``, one pass that reads each row
  once and writes its two halves to their two output rows.
* ``sgu_mix_gate`` replaces ``pallas_layers.py:_sgu_pallas`` (body
  ``_sgu_kernel``): normalise the gate, round it to the output dtype,
  causal mix ``sum_{j<=m} W[m, j] g[j]`` with float32 W and float32
  accumulation, add the bias, cast, then ``x * gate``. Kernel:
  ``csrc/sgu_mix_gate.cu``: in bfloat16 the mix runs on the tensor cores
  with W split into two bfloat16 parts (exact products, float32 sums),
  in float16 and float32 on the FMA units.

Sequence shards (``parallel/``): ``norm_shift`` takes ``prev``, the
last pre-norm row of the left neighbour's shard, which row 0 then takes
its shifted half from (normalised, as any previous row is);
``sgu_mix_gate`` takes ``row_offset`` with the shard's rows of x, the
weights and the biases and the whole gate, as the TPU path shards the
weight's output rows over seq (``partition.py``'s ``sgu_seq_out``). With
``prev=None`` and ``row_offset=0`` both are the unsharded layer.

Both are differentiable (``torch.autograd.Function``): the forward is
the kernel, and the backward recomputes the plain composition
(``norm_shift_reference``, ``sgu_mix_gate_reference``) under autograd
and returns its gradient. That is exactly what the JAX package does
(``pallas_layers.py:239-249, 310-321``): neither layer has a Pallas
backward, so this is the counterpart, not a fallback.

On the CPU each forward runs its plain version below instead of the
kernel.
"""

from __future__ import annotations

import torch

from progen_tpu_torch.ops import _build
from progen_tpu_torch.ops.dispatch import check_same_device, takes_kernel
from progen_tpu_torch.ops.sgu import causal_sgu_mix
from progen_tpu_torch.ops.shift import shift_tokens

NORM_SHIFT_MAX_DIM = 2048


def norm_reference(x, scale, epsilon, out_dtype):
    """Scale-only LayerNorm over the last axis as flax computes it: f32
    stats, biased variance ``max(0, E[x^2] - E[x]^2)``, the rsqrt*scale
    product formed first."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    mu2 = (x32 * x32).mean(dim=-1, keepdim=True)
    var = torch.clamp(mu2 - mu * mu, min=0.0)
    y = (x32 - mu) * (torch.rsqrt(var + epsilon) * scale.float())
    return y.to(out_dtype)


def norm_shift_reference(x, scale, epsilon, out_dtype, prev=None):
    """``prev`` (batch, 1, d): the pre-norm row before row 0, or None."""
    state = None
    if prev is not None:
        split = x.shape[-1] - x.shape[-1] // 2
        state = norm_reference(prev, scale, epsilon, out_dtype)[..., :split]
    return shift_tokens(norm_reference(x, scale, epsilon, out_dtype),
                        shift_state=state)


def sgu_mix_gate_reference(x, gate, weights, biases, scale, epsilon,
                           out_dtype, row_offset=0):
    g = norm_reference(gate, scale, epsilon, out_dtype)
    g = causal_sgu_mix(g, weights, biases, row_offset=row_offset)
    return x * g.to(x.dtype)


def _reference_grads(fn, tensors, args, g):
    """The gradient of the plain composition ``fn(*tensors, *args)``
    against ``g``, recomputed under autograd: the backward of both
    layers, as ``jax.vjp`` of the reference is in the JAX package. A
    tensor that is None stays None and gets no gradient."""
    with torch.enable_grad():
        inputs = [None if t is None else t.detach().requires_grad_(True)
                  for t in tensors]
        out = fn(*inputs, *args)
        live = [t for t in inputs if t is not None]
        grads = iter(torch.autograd.grad(out, live, g))
        return [None if t is None else next(grads) for t in inputs]


def _norm_shift_kernel(x, scale, epsilon, out_dtype, prev):
    if x.ndim != 3:
        raise ValueError(f"x must be (batch, n, d), got {tuple(x.shape)}")
    b, n, d = x.shape
    if not 2 <= d <= NORM_SHIFT_MAX_DIM:
        raise ValueError(f"kernel takes 2 <= d <= {NORM_SHIFT_MAX_DIM}, "
                         f"got {d}")
    if scale.shape != (d,):
        raise ValueError(f"scale must be ({d},), got {tuple(scale.shape)}")
    if out_dtype != x.dtype:
        raise TypeError("kernel writes x's dtype")
    if prev is not None:
        if prev.shape != (b, 1, d) or prev.dtype != x.dtype:
            raise ValueError(f"prev must be ({b}, 1, {d}) in x's dtype")
        check_same_device(x, prev)
        prev = _build.aligned16(prev)
    check_same_device(x, scale)
    x = _build.aligned16(x)
    scale = scale.float().contiguous()
    out = torch.empty_like(x)
    _build.launch(
        "norm_shift", x.device,
        x.data_ptr(), None if prev is None else prev.data_ptr(),
        scale.data_ptr(), out.data_ptr(),
        b * n, n, d, float(epsilon), _build.dtype_code(x),
    )
    norm_shift.launches += 1
    return out


class _NormShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, prev, epsilon, out_dtype):
        ctx.save_for_backward(x, scale, prev)
        ctx.args = (epsilon, out_dtype)
        if not takes_kernel(x):
            return norm_shift_reference(x, scale, epsilon, out_dtype, prev)
        return _norm_shift_kernel(x, scale, epsilon, out_dtype, prev)

    @staticmethod
    def backward(ctx, g):
        x, scale, prev = ctx.saved_tensors
        eps, dt = ctx.args
        grads = _reference_grads(
            lambda x_, s_, p_: norm_shift_reference(x_, s_, eps, dt, p_),
            (x, scale, prev), (), g)
        return (*grads, None, None)


def norm_shift(x, scale, epsilon, out_dtype, prev=None):
    """x: (batch, n, d); scale: (d,). Returns (batch, n, d) in
    ``out_dtype``. ``prev`` (batch, 1, d), in x's dtype: the pre-norm row
    before row 0 (a sequence shard's left neighbour's last row), which
    row 0 shifts in; None shifts in zeros."""
    return _NormShift.apply(x, scale, prev, epsilon, out_dtype)


norm_shift.launches = 0


def _sgu_scratch(b, n, d, dtype, device):
    """The kernel's scratch: in bfloat16 the normalised gate, (b, n, d
    rounded up to 8) bfloat16 (the tensor-core kernel's B operand); in
    float16 and float32 the gate's statistics, (b * n, 2) float32."""
    if dtype == torch.bfloat16:
        return torch.empty((b, n, -(-d // 8) * 8), dtype=dtype,
                           device=device)
    return torch.empty((b * n, 2), dtype=torch.float32, device=device)


def _sgu_mix_gate_kernel(x, gate, weights, biases, scale, epsilon,
                         out_dtype, row_offset):
    if gate.ndim != 3 or x.ndim != 3 or x.shape[::2] != gate.shape[::2]:
        raise ValueError("x and gate must be (batch, rows, d) and "
                         "(batch, n, d)")
    b, n, d = gate.shape
    rows = x.shape[1]
    if not 0 <= row_offset <= n - rows:
        raise ValueError(f"rows [{row_offset}, {row_offset + rows}) are "
                         f"not within the gate's {n}")
    if weights.shape != (rows, n) or biases.shape != (rows, 1) or \
            scale.shape != (d,):
        raise ValueError("weights must be (rows, n), biases (rows, 1) and "
                         "scale (d,)")
    if not (x.dtype == gate.dtype == out_dtype):
        raise TypeError("kernel takes x and gate in the output dtype")
    check_same_device(x, gate, weights, biases, scale)
    x, gate = _build.aligned16(x), _build.aligned16(gate)
    weights = weights.float()
    if x.dtype == torch.bfloat16 and n % 4:
        # the tensor-core mix reads W's rows 16 bytes at a time: pad them
        # with zero columns to a multiple of 4
        weights = torch.nn.functional.pad(weights, (0, -n % 4))
    weights = _build.aligned16(weights)
    biases = biases.float().contiguous()
    scale = scale.float().contiguous()
    out = torch.empty_like(x)
    scratch = _sgu_scratch(b, n, d, x.dtype, x.device)
    _build.launch(
        "sgu_mix_gate", x.device,
        x.data_ptr(), gate.data_ptr(), weights.data_ptr(),
        biases.data_ptr(), scale.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), b, n, weights.stride(0), row_offset, rows, d,
        float(epsilon),
        _build.dtype_code(x),
    )
    sgu_mix_gate.launches += 1
    return out


class _SguMixGate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gate, weights, biases, scale, epsilon, out_dtype,
                row_offset):
        ctx.save_for_backward(x, gate, weights, biases, scale)
        ctx.args = (epsilon, out_dtype, row_offset)
        if not takes_kernel(gate):
            return sgu_mix_gate_reference(x, gate, weights, biases, scale,
                                          epsilon, out_dtype, row_offset)
        # a float32 gate holds values of the output dtype (see
        # sgu_mix_gate), so this cast is exact
        return _sgu_mix_gate_kernel(x, gate.to(out_dtype), weights, biases,
                                    scale, epsilon, out_dtype, row_offset)

    @staticmethod
    def backward(ctx, g):
        grads = _reference_grads(sgu_mix_gate_reference, ctx.saved_tensors,
                                 ctx.args, g)
        return (*grads, None, None, None)


def sgu_mix_gate(x, gate, weights, biases, scale, epsilon, out_dtype,
                 row_offset=0):
    """x, gate: (batch, n, d) halves of the feed-forward hidden; weights
    (n, n) and biases (n, 1) float32; scale (d,). Returns (batch, n, d)
    in x's dtype. A sequence shard passes its rows [r0, r0 + rows) of x,
    the weights and the biases, the whole gate and ``row_offset=r0``, and
    gets those rows: (batch, rows, d). The gate may come in float32
    holding values of x's dtype (a shard's gathered gate, upcast so that
    its gradient, summed over the shards, is rounded once); the kernel
    reads it in x's dtype."""
    return _SguMixGate.apply(x, gate, weights, biases, scale, epsilon,
                             out_dtype, row_offset)


sgu_mix_gate.launches = 0

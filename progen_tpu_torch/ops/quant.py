"""Per-channel symmetric int8 weight quantisation for the serving path,
the port of the JAX package's ``ops/quant.py``.

Scheme: for each matrix-product weight, one scale per OUTPUT channel,
``scale[o] = max_i |W[o, i]| / 127``, ``Q = round(W / scale)`` clipped to
[-127, 127] (symmetric: no zero point, so the dequantisation is one
multiply). The port stores a ``Dense`` weight as (out, in), the
transpose of flax's (in, out) kernel, so the JAX package's ``amax`` over
axis 0 is the port's over dim 1; the operations run in the JAX order
(``w32 / scale`` with ``scale = where(amax > 0, amax, 1) / 127``, and
both ``round`` functions round half to even), so Q is bit-equal to the
JAX package's, transposed.

Quantised: exactly the leaves the JAX package quantises, its 2-D
``kernel`` leaves, which are the port's ``Dense`` weights; the list comes
from the weight bridge's leaf map (``convert.py``), not a name pattern.
The embedding, the norm scales, the biases and the SGU's
``spatial_weights`` stay in full precision (the spatial weights' ±eps/n
init sits inside one int8 step).

The calibration report records each quantised leaf's max-abs-error and
bytes, keyed by its JAX path with its (in, out) shape, so the two
packages' reports compare leaf by leaf.
"""

from __future__ import annotations

import torch

from progen_tpu_torch.config import ProGenConfig
from progen_tpu_torch.convert import _leaves


def quantized_leaves(config: ProGenConfig) -> dict:
    """Port state-dict name -> the JAX path string
    (``jax.tree_util.keystr`` of the unrolled tree) of every leaf that
    int8 serving quantises: the bridge's transposed leaves, flax's
    ``kernel``s."""
    return {key: "".join(f"['{k}']" for k in path)
            for path, key, transposed in _leaves(config) if transposed}


def quantize_leaf(w: torch.Tensor):
    """(q int8 (out, in), scale float32 (out,), max_abs_err float32) for
    one (out, in) weight."""
    w32 = w.float()
    amax = w32.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax, 1.0) / 127.0
    q = torch.clamp(torch.round(w32 / scale[:, None]), -127, 127).to(
        torch.int8)
    err = (q.float() * scale[:, None] - w32).abs().max()
    return q, scale, err


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[:, None]).to(dtype)


def quantize_tree(state_dict: dict, config: ProGenConfig):
    """Quantise every matrix-product weight of a state dict.

    Returns ``(q_state, scales, report)``: ``q_state`` is the state dict
    with the quantised entries replaced by int8 (every other entry the
    same tensor, not copied), ``scales`` maps a quantised entry's name to
    its (out,) float32 scales, and ``report`` lists one calibration dict
    a leaf (``path``, ``shape`` (in, out), ``max_abs_err``, ``bytes_fp``,
    ``bytes_int8``)."""
    q_state, scales, report = dict(state_dict), {}, []
    for key, path in quantized_leaves(config).items():
        w = state_dict[key]
        q, scale, err = quantize_leaf(w)
        q_state[key], scales[key] = q, scale
        report.append({
            "path": path,
            "shape": (int(w.shape[1]), int(w.shape[0])),
            "max_abs_err": float(err),
            "bytes_fp": int(w.numel() * w.element_size()),
            "bytes_int8": int(q.numel() + scale.numel() * 4),
        })
    return q_state, scales, report


def dequantize_tree(q_state: dict, scales: dict, dtype: torch.dtype) -> dict:
    """The inverse of ``quantize_tree`` for the quantised entries
    (identity on the rest)."""
    return {k: dequantize_leaf(v, scales[k], dtype) if k in scales else v
            for k, v in q_state.items()}

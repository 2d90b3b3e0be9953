"""The plain ProGen of the yardstick, in float32.

Written from the architecture's equations with plain PyTorch operations
and no kernels, caches or batching tricks; it imports nothing of the
program. Parameters are a dict keyed by the program's ``state_dict``
names (``families/progen.py``'s ``Spec.parameter_shapes``).

The model: token embedding; ``depth`` x (pre-norm windowed local
attention + pre-norm feed-forward) with residual adds; a scale-only
final norm and a linear head. Each block's head is a scale-only
LayerNorm followed by a token shift (the first d - d//2 channels delayed
one position, zeros at the front). Attention: one q|k|v projection, the
GPT-J rotary embedding on q, k and v, and windows of w queries that see
their own window causally and the whole previous one; window 0's
previous window is w zero keys and values that still take part in the
softmax. Feed-forward: tanh-GELU GLU, or in the last
``global_mlp_depth`` layers tanh-GELU then the spatial gating unit:
(x | gate) halves, gate normalised and mixed over positions by the
lower triangle of an (n, n) matrix plus a per-position bias, times x,
then projected. The loss of a sequence is the mean negative
log-likelihood over its tokens and the first pad (its EOS).

``linear`` is the one product with weights; the control passes a
lower-precision one in its place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def layer_norm(x, scale, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale


def shift(x):
    split = x.shape[-1] - x.shape[-1] // 2
    moved = F.pad(x[..., :-1, :split], (0, 0, 1, 0))
    return torch.cat((moved, x[..., split:]), dim=-1)


def rope_tables(n: int, dim: int, device):
    inv_freq = 1.0 / 10000 ** (torch.arange(0, dim, 2, device=device,
                                            dtype=torch.float32) / dim)
    angles = torch.outer(torch.arange(n, device=device,
                                      dtype=torch.float32), inv_freq)
    angles = angles.repeat_interleave(2, dim=-1)
    return angles.sin(), angles.cos()


def rotate(x, sin, cos):
    pairs = x.unflatten(-1, (-1, 2))
    turned = torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1)
    return x * cos + turned.flatten(-2) * sin


def local_attention(q, k, v, w: int):
    """q, k, v (b, h, n, d) -> (b, h, n, d)."""
    b, h, n, d = q.shape
    nw = n // w
    qw, kw, vw = (t.reshape(b, h, nw, w, d) for t in (q, k, v))

    def with_prev(t):
        prev = torch.cat((torch.zeros_like(t[:, :, :1]), t[:, :, :-1]), 2)
        return torch.cat((prev, t), dim=3)

    s = torch.einsum("bhnid,bhnjd->bhnij", qw, with_prev(kw)) * d ** -0.5
    i = torch.arange(w, device=q.device)[:, None]
    j = torch.arange(2 * w, device=q.device)[None, :]
    s = s.masked_fill(j > i + w, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnij,bhnjd->bhnid", p, with_prev(vw)).reshape(
        b, h, n, d)


def _head(P, name, x, spec):
    h = layer_norm(x, P[name + "norm.scale"], spec.layer_norm_epsilon)
    return shift(h) if spec.shift_tokens else h


def attention_block(P, i, x, spec, tables, linear):
    a = f"attn.{i}."
    h = _head(P, a, x, spec)
    b, n, _ = h.shape
    qkv = linear(h, P[a + "to_qkv.weight"], None)
    q, k, v = (t.reshape(b, n, spec.heads, spec.dim_head).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    sin, cos = tables
    q, k = rotate(q, sin, cos), rotate(k, sin, cos)
    if spec.rotate_value:
        v = rotate(v, sin, cos)
    out = local_attention(q, k, v, spec.window_size)
    out = out.transpose(1, 2).reshape(b, n, spec.inner_dim)
    return linear(out, P[a + "to_out.weight"], P[a + "to_out.bias"])


def feed_forward_block(P, i, x, spec, linear):
    f = f"ff.{i}."
    h = linear(_head(P, f, x, spec), P[f + "proj_in.weight"],
               P[f + "proj_in.bias"])
    if spec.is_gmlp(i):
        h = F.gelu(h, approximate="tanh")
        s = f + "sgu."
        u, gate = h.chunk(2, dim=-1)
        gate = layer_norm(gate, P[s + "norm.scale"], spec.layer_norm_epsilon)
        mix = torch.tril(P[s + "spatial_weights"])
        mixed = torch.einsum("mn,bnd->bmd", mix, gate) + P[s + "spatial_biases"]
        h = linear(u * mixed, P[s + "proj_out.weight"], P[s + "proj_out.bias"])
    elif spec.ff_glu:
        u, gate = h.chunk(2, dim=-1)
        h = u * F.gelu(gate, approximate="tanh")
    else:
        h = F.gelu(h, approximate="tanh")
    return linear(h, P[f + "proj_out.weight"], P[f + "proj_out.bias"])


def forward(P: dict, spec, tokens: torch.Tensor, linear=F.linear):
    """tokens (b, n) -> float32 logits (b, n, num_tokens)."""
    n = tokens.shape[-1]
    tables = rope_tables(n, spec.dim_head, tokens.device)
    x = P["embed"][tokens]
    for i in range(spec.depth):
        x = x + attention_block(P, i, x, spec, tables, linear)
        x = x + feed_forward_block(P, i, x, spec, linear)
    x = layer_norm(x, P["norm.scale"], spec.layer_norm_epsilon)
    return linear(x, P["to_logits.weight"], P["to_logits.bias"])


def sequence_nll(logits, targets):
    """Per-sequence mean negative log-likelihood over each sequence's
    non-pad tokens and its first pad (the EOS)."""
    nll = -torch.log_softmax(logits, dim=-1).gather(
        -1, targets[..., None])[..., 0]
    pad = targets == 0
    keep = ~pad | (pad.long().cumsum(dim=-1) == 1)
    keep = keep.to(nll.dtype)
    return (nll * keep).sum(dim=-1) / keep.sum(dim=-1)


def rows_nll(P, spec, rows: torch.Tensor, linear=F.linear):
    """rows (b, n + 1) tokens with the BOS first -> (b,) per-sequence
    loss."""
    return sequence_nll(forward(P, spec, rows[:, :-1], linear), rows[:, 1:])

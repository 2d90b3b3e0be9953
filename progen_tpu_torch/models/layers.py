"""ProGen building blocks as ``nn.Module``s, batch-first.

Counterpart of ``progen_tpu/models/layers.py``: pre-norm local attention
with token shift, fused q|k|v projection and RoPE on q, k and v; the GLU
or GELU feed-forward; the spatial gating unit with its learned causal
(n, n) mix. Parameters live in ``config.param_dtype`` (float32 unless a
config says otherwise), as flax's ``param_dtype``; each block computes
in the configured dtype (weights, biases and inputs cast to it, as
flax's ``Dense(dtype=...)`` does).

The full-sequence path runs the kernels through their wrappers
(``ops/cuda_attention.py``, ``ops/cuda_layers.py``): on the card the
CUDA kernels, on the CPU their plain versions; each wrapper is
differentiable, and the attention backward is the kernel that
``ATTN_BWD_IMPL`` names. The one-token decode path runs plain PyTorch
against an explicit per-layer cache, each row at its own position
(a (batch,) tensor): RoPE is gathered per row, each row writes its own
ring slot and gate-history row, and the window-0 dilution and the SGU
row's causal mask are selected per row.

Sequence shards: given a process ``group`` (the seq group of
``parallel.Grid``), a block's input is the rank's shard of each
sequence. The token shift takes the left neighbour's last row, the
attention its last window (``parallel/ring_attention.py``, kernel A4),
and the SGU gathers the gate over the whole sequence and computes the
shard's rows of the mix (the reference's ``sgu_seq_out`` rule).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from progen_tpu_torch.config import ProGenConfig
from progen_tpu_torch.ops.attention import ATTN_MASK_VALUE
from progen_tpu_torch.ops.cuda_attention import local_attention
from progen_tpu_torch.ops.cuda_layers import (
    norm_reference,
    norm_shift,
    sgu_mix_gate,
)
from progen_tpu_torch.ops.rotary import apply_rotary_pos_emb
from progen_tpu_torch.ops.shift import shift_tokens
from progen_tpu_torch.parallel.collectives import gather_seq, halo_from_left
from progen_tpu_torch.parallel.ring_attention import ring_local_attention

# The attention backward: A2 ("kv"), the JAX package's default and its
# policy's choice at window 512 (pallas_attention.py:355-360), or A3
# ("halo"). The port takes no entry from the TPU's pallas_policy.json.
ATTN_BWD_IMPL = "kv"


class Dense(nn.Module):
    """``y = x W^T + b`` computed in ``dtype``: flax ``Dense(dtype=...)``
    with the weight stored as (out, in) in ``param_dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, param_dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               dtype=param_dtype))
        self.bias = (nn.Parameter(torch.zeros(out_features,
                                              dtype=param_dtype))
                     if bias else None)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = F.linear(x.to(dtype), self.weight.to(dtype))
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


class ScaleNorm(nn.Module):
    """Scale-only LayerNorm with flax's arithmetic (``norm_reference``)."""

    def __init__(self, dim: int, epsilon: float,
                 param_dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=param_dtype))
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return norm_reference(x, self.scale, self.epsilon, dtype)


class DecodeAt(NamedTuple):
    """One decode step's row positions and what every layer derives from
    them, computed once a step (``of``) rather than in each layer."""

    pos: torch.Tensor  # (b,) int64
    slot: torch.Tensor  # (b,) the ring slot, pos % 2w
    block: torch.Tensor  # (b, 1) the window index, pos // w
    first_window: torch.Tensor  # (b, 1, 1, 1) bool, pos < w
    rope: tuple  # sin, cos at each row's position, (b, 1, 1, dim_head)

    @classmethod
    def of(cls, pos: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
           window: int) -> "DecodeAt":
        """``sin``/``cos``: the full (seq_len, dim_head) tables."""
        return cls(pos, pos % (2 * window), (pos // window)[:, None],
                   (pos < window)[:, None, None, None],
                   (sin[pos][:, None, None], cos[pos][:, None, None]))


@dataclasses.dataclass
class AttnCache:
    """Decode state of one attention block, updated in place by each
    step: a rolling ring of 2w keys and values per row (slot ``p % 2w``
    holds position p), the position each row's slot holds (-1 = empty),
    and the previous position's post-norm features for the token
    shift."""

    k: torch.Tensor  # (b, heads, 2w, dim_head)
    v: torch.Tensor
    slot_pos: torch.Tensor  # (b, 2w) int64
    shift_state: torch.Tensor | None  # (b, 1, d - d//2)


@dataclasses.dataclass
class FFCache:
    """Decode state of one feed-forward block, updated in place: the
    token-shift state and, for gMLP blocks, the float32 history of the
    normalised SGU gates (b, seq_len, half)."""

    shift_state: torch.Tensor | None
    gate_history: torch.Tensor | None


def _head(norm: ScaleNorm, c: ProGenConfig, x: torch.Tensor, group=None):
    """Pre-norm + token shift of the full sequence, or of a sequence
    shard whose row 0 shifts in the left neighbour's last row: one fused
    kernel."""
    if c.shift_tokens:
        prev = None if group is None else halo_from_left(x[:, -1:], group)
        return norm_shift(x, norm.scale, norm.epsilon, c.compute_dtype, prev)
    return norm(x, c.compute_dtype)


def _cached_shift(x: torch.Tensor, cache) -> torch.Tensor:
    """Token shift for one-token decode: the shifted-in half comes from
    ``cache.shift_state`` (the previous position's post-norm features),
    which is then overwritten in place with this position's."""
    split = x.shape[-1] - x.shape[-1] // 2
    shifted = shift_tokens(x, shift_state=cache.shift_state)
    cache.shift_state.copy_(x[..., :split])
    return shifted


def _cached_head(norm: ScaleNorm, c: ProGenConfig, x: torch.Tensor,
                 cache) -> torch.Tensor:
    """Pre-norm + token shift of one decode position."""
    x = norm(x, c.compute_dtype)
    return _cached_shift(x, cache) if c.shift_tokens else x


class LocalAttentionBlock(nn.Module):
    def __init__(self, c: ProGenConfig):
        super().__init__()
        self.config = c
        pd = c.params_dtype
        self.norm = ScaleNorm(c.dim, c.layer_norm_epsilon, pd)
        self.to_qkv = Dense(c.dim, 3 * c.inner_dim, bias=False,
                            param_dtype=pd)
        self.to_out = Dense(c.inner_dim, c.dim, param_dtype=pd)

    def _qkv(self, x, sin, cos):
        c = self.config
        b, n, _ = x.shape
        qkv = self.to_qkv(x, c.compute_dtype)

        def split_heads(t):  # (b, n, h*dh) -> (b, h, n, dh)
            return t.reshape(b, n, c.heads, c.dim_head).transpose(1, 2)

        q, k, v = map(split_heads, qkv.chunk(3, dim=-1))
        q = apply_rotary_pos_emb(q, sin, cos)
        k = apply_rotary_pos_emb(k, sin, cos)
        if c.rotate_value:
            v = apply_rotary_pos_emb(v, sin, cos)
        return q, k, v

    def _out(self, out):
        b, _, n, _ = out.shape
        out = out.transpose(1, 2).reshape(b, n, self.config.inner_dim)
        return self.to_out(out, self.config.compute_dtype)

    def forward(self, x, sin, cos, group=None):
        c = self.config
        q, k, v = self._qkv(_head(self.norm, c, x, group), sin, cos)
        if group is None:
            out = local_attention(q, k, v, c.window_size,
                                  bwd_impl=ATTN_BWD_IMPL)
        else:
            out = ring_local_attention(q, k, v, c.window_size, group,
                                       bwd_impl=ATTN_BWD_IMPL)
        return self._out(out)

    def new_cache(self, batch: int, device) -> AttnCache:
        c = self.config
        dt, ring = c.compute_dtype, 2 * c.window_size
        shape = (batch, c.heads, ring, c.dim_head)
        split = c.dim - c.dim // 2
        return AttnCache(
            k=torch.zeros(shape, dtype=dt, device=device),
            v=torch.zeros(shape, dtype=dt, device=device),
            slot_pos=torch.full((batch, ring), -1, dtype=torch.int64,
                                device=device),
            shift_state=(torch.zeros((batch, 1, split), dtype=dt,
                                     device=device)
                         if c.shift_tokens else None),
        )

    def decode(self, x, at: DecodeAt, cache: AttnCache):
        """One position per row: x (b, 1, dim) at the rows' positions
        ``at``."""
        c = self.config
        h = _cached_head(self.norm, c, x, cache)
        q, k, v = self._qkv(h, *at.rope)
        return self._out(self._decode_attend(q, k, v, at, cache))

    def _decode_attend(self, q, k, v, at: DecodeAt, cache: AttnCache):
        """One-token attention of each row against its ring. Visibility
        comes from the stored positions; a window-0 query's softmax is
        diluted by exactly w phantom zero-score, zero-value keys through
        an analytic term in the denominator, selected per row."""
        c = self.config
        w, dh = c.window_size, c.dim_head
        # in place: each row's key and value enter its ring
        idx = at.slot.view(-1, 1, 1, 1).expand_as(k)
        cache.k.scatter_(2, idx, k.to(cache.k.dtype))
        cache.v.scatter_(2, idx, v.to(cache.v.dtype))
        cache.slot_pos.scatter_(1, at.slot[:, None], at.pos[:, None])
        sp, p = cache.slot_pos, at.pos[:, None]
        visible = (sp >= 0) & (sp <= p) & (at.block - sp // w <= 1)
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                              cache.k.float()) * (dh ** -0.5)
        scores = scores.masked_fill(~visible[:, None, None, :],
                                    ATTN_MASK_VALUE)
        m = scores.amax(dim=-1, keepdim=True)
        first_window = at.first_window
        m = torch.where(first_window, torch.clamp(m, min=0.0), m)
        e = torch.exp(scores - m)
        denom = e.sum(dim=-1, keepdim=True)
        denom = denom + torch.where(first_window, w * torch.exp(-m), 0.0)
        out = torch.einsum("bhqk,bhkd->bhqd", e, cache.v.float()) / denom
        return out.to(q.dtype)


class SpatialGatingUnit(nn.Module):
    def __init__(self, c: ProGenConfig, dim_in: int, dim_out: int):
        super().__init__()
        self.config = c
        half = dim_in // 2
        n, pd = c.seq_len, c.params_dtype
        self.norm = ScaleNorm(half, c.layer_norm_epsilon, pd)
        # read as float32 by the mix, as the TPU kernel reads them
        self.spatial_weights = nn.Parameter(torch.empty(n, n, dtype=pd))
        self.spatial_biases = nn.Parameter(torch.ones(n, 1, dtype=pd))
        self.proj_out = Dense(half, dim_out, param_dtype=pd)

    def forward(self, h, group=None):
        c = self.config
        x, gate = h.chunk(2, dim=-1)
        w, b, r0 = self.spatial_weights, self.spatial_biases, 0
        if group is not None:  # this shard's rows against the whole gate
            # gathered in float32, so the shards' partial gradients of the
            # gate are summed before they are rounded to the compute dtype
            gate = gather_seq(gate.float(), -2, group)
            rows = x.shape[-2]
            r0 = dist.get_rank(group) * rows
            w, b = w[r0:r0 + rows], b[r0:r0 + rows]
        if gate.shape[-2] != c.seq_len:
            raise ValueError(f"SGU is bound to seq_len={c.seq_len}, got "
                             f"sequence {gate.shape[-2]}")
        x = sgu_mix_gate(x, gate, w, b, self.norm.scale, self.norm.epsilon,
                         c.compute_dtype, r0)
        return self.proj_out(x, c.compute_dtype)

    def new_gate_history(self, batch: int, device) -> torch.Tensor:
        return torch.zeros((batch, self.config.seq_len,
                            self.norm.scale.shape[0]),
                           dtype=torch.float32, device=device)

    def decode(self, h, at: DecodeAt, gate_history: torch.Tensor):
        """out[p] = sum_{j<=p} W[p, j] gate[j] + b[p] for each row's
        position p, against the history of normalised gates, which this
        step extends in place."""
        c = self.config
        x, gate = h.chunk(2, dim=-1)
        gate = self.norm(gate, c.compute_dtype)
        pos = at.pos
        gate_history.scatter_(
            1, pos.view(-1, 1, 1).expand(-1, 1, gate.shape[-1]),
            gate.float())
        cols = torch.arange(c.seq_len, device=pos.device)
        row = torch.where(cols <= pos[:, None],
                          self.spatial_weights[pos].float(), 0.0)
        mixed = torch.einsum("bnd,bn->bd", gate_history, row)
        mixed = mixed + self.spatial_biases[pos].float()
        x = x * mixed[:, None, :].to(x.dtype)
        return self.proj_out(x, c.compute_dtype)


class FeedForwardBlock(nn.Module):
    def __init__(self, c: ProGenConfig, glu: bool = False,
                 spatial_gate: bool = False):
        super().__init__()
        if glu and spatial_gate:
            raise ValueError("glu and sgu cannot be turned on at once")
        self.config = c
        self.glu = glu
        hidden = c.dim * c.ff_mult * (2 if glu else 1)
        pd = c.params_dtype
        self.norm = ScaleNorm(c.dim, c.layer_norm_epsilon, pd)
        self.proj_in = Dense(c.dim, hidden, param_dtype=pd)
        self.sgu = (SpatialGatingUnit(c, hidden, hidden // 2)
                    if spatial_gate else None)
        inner = hidden // 2 if (glu or spatial_gate) else hidden
        self.proj_out = Dense(inner, c.dim, param_dtype=pd)

    def _activate(self, h):
        h = self.proj_in(h, self.config.compute_dtype)
        if self.glu:
            h, gate = h.chunk(2, dim=-1)
            return h * F.gelu(gate, approximate="tanh")
        return F.gelu(h, approximate="tanh")

    def forward(self, x, group=None):
        h = self._activate(_head(self.norm, self.config, x, group))
        if self.sgu is not None:
            h = self.sgu(h, group)
        return self.proj_out(h, self.config.compute_dtype)

    def new_cache(self, batch: int, device) -> FFCache:
        c = self.config
        split = c.dim - c.dim // 2
        return FFCache(
            shift_state=(torch.zeros((batch, 1, split),
                                     dtype=c.compute_dtype, device=device)
                         if c.shift_tokens else None),
            gate_history=(self.sgu.new_gate_history(batch, device)
                          if self.sgu is not None else None),
        )

    def decode(self, x, at: DecodeAt, cache: FFCache):
        h = self._activate(_cached_head(self.norm, self.config, x, cache))
        if self.sgu is not None:
            h = self.sgu.decode(h, at, cache.gate_history)
        return self.proj_out(h, self.config.compute_dtype)

"""The ProGen model: a decoder-only protein language model, batch-first.

Counterpart of ``progen_tpu/models/progen.py``: token embedding ->
``depth`` x (local attention + feed-forward) with residual adds, the last
``global_mlp_depth`` layers using gMLP feed-forwards (spatial gate, no
GLU), then a scale-only norm and a linear logits head. Params in
``config.param_dtype`` (float32 by default), compute in ``config.dtype``,
logits in float32.

``forward`` runs the full sequence through the kernels; given a
``parallel.Grid`` whose seq axis is above 1, it runs this rank's shard of
each sequence (see ``models/layers.py``). A model built with a grid
whose model axis is above 1 holds this rank's tensor-parallel shards
(``parallel/tensor.py``): the embedding's vocabulary rows (looked up
masked, summed over the model group) and the logits head's columns, so
its forward returns this rank's vocab/model columns of the logits. With
``config.remat`` set and autograd recording, each attention and each
feed-forward block is recomputed in the backward
(``torch.utils.checkpoint``), the counterpart of ``nn.remat`` per block.
``decode_step``
takes one token per row and carries a ``DecodeCache`` (rolling 2-window
K/V ring, token-shift states, SGU gate history, and each row's
position), as the JAX model's ``config.decode`` mode does; its logits at
each position equal the full forward's. Rows may stand at different
positions, so one cache can hold requests admitted at different times
(the serving engine's slot pool). ``features`` returns the final-norm
states that embeddings pool.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from progen_tpu_torch._device import resolve_device
from progen_tpu_torch.config import ProGenConfig
from progen_tpu_torch.models.layers import (
    AttnCache,
    DecodeAt,
    Dense,
    FFCache,
    FeedForwardBlock,
    LocalAttentionBlock,
    ScaleNorm,
)
from progen_tpu_torch.ops.rotary import fixed_pos_embedding
from progen_tpu_torch.parallel.collectives import _all_gather
from progen_tpu_torch.parallel.tensor import (
    TP,
    check_divisible,
    layout,
    shard,
    unshard,
    vocab_embedding,
)


def _fields(c) -> list:
    """A layer cache's tensors (or None) in field order, not copied."""
    return [getattr(c, f.name) for f in dataclasses.fields(c)]


class DecodeCache:
    """Per-layer decode state plus each row's position; ``decode_step``
    updates every tensor in place and advances every row by one. The
    row helpers move whole rows between caches of any batch: every
    tensor's leading axis is the row.

    ``pos`` lives on the device; ``top`` is the host's bound on its
    largest entry, kept without reading the device, so the seq_len check
    costs a decode step no synchronisation. ``cache.pos = p`` places
    every row at p; ``place_`` sets the rows from a device tensor."""

    def __init__(self, attn: list, ff: list, pos: torch.Tensor,
                 top: int = 0):
        self.attn, self.ff = attn, ff
        self._pos = pos  # (batch,) int64
        self.top = int(top)

    @property
    def pos(self) -> torch.Tensor:
        return self._pos

    @pos.setter
    def pos(self, value: int) -> None:
        if isinstance(value, torch.Tensor):
            raise TypeError("set positions from a tensor with place_, "
                            "which takes the host's bound on them")
        self._pos.fill_(int(value))
        self.top = int(value)

    def place_(self, pos: torch.Tensor, top: int) -> None:
        """Each row's position from ``pos`` (batch,), no entry above
        ``top``."""
        self._pos.copy_(pos)
        self.top = int(top)

    def tensors(self) -> list:
        """Every tensor of the state, in a fixed order."""
        out = [t for c in self.attn + self.ff for t in _fields(c)
               if t is not None]
        return out + [self._pos]

    def _map(self, fn) -> "DecodeCache":
        def each(c):
            return type(c)(*(None if t is None else fn(t)
                             for t in _fields(c)))
        return DecodeCache([each(c) for c in self.attn],
                           [each(c) for c in self.ff], fn(self._pos),
                           self.top)

    def clone(self) -> "DecodeCache":
        """A copy that shares no storage with this cache."""
        return self._map(torch.clone)

    def row(self, s: int) -> "DecodeCache":
        """Row ``s`` as a batch-1 cache that shares no storage."""
        return self._map(lambda t: t[s:s + 1].clone())

    def set_row_(self, s: int, src: "DecodeCache") -> None:
        """Copy the batch-1 cache ``src`` into row ``s``, in place. From a
        fresh ``init_cache(1)`` this resets the row: its ring slots hold
        position -1 again (zeroing would make them hold position 0)."""
        for dst, t in zip(self.tensors(), src.tensors(), strict=True):
            dst[s] = t[0]
        self.top = max(self.top, src.top)

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in self.tensors())


def _truncated_normal(shape, stddev: float, gen: torch.Generator):
    """Normal truncated to [-2, 2] standard deviations, times ``stddev``
    (jax.random.truncated_normal(-2, 2) * stddev)."""
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
        (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.rand(shape, generator=gen)
    x = math.sqrt(2) * torch.erfinv(2 * (lo + u * (hi - lo)) - 1)
    return x.clamp(-2, 2) * stddev


def _lecun_normal(out_features: int, in_features: int,
                  gen: torch.Generator):
    # variance_scaling(1, fan_in, truncated_normal): the std of a
    # [-2, 2]-truncated unit normal is .87962566103423978
    std = math.sqrt(1.0 / in_features) / .87962566103423978
    return _truncated_normal((out_features, in_features), std, gen)


def whole_parameter_shapes(config: ProGenConfig) -> list:
    """(name, shape) of every parameter of the whole model (no shards),
    in ``named_parameters`` order: the order the initialiser draws in."""
    with torch.device("meta"):
        skeleton = ProGen(config, device="meta", seed=None)
    return [(n, p.shape) for n, p in skeleton.named_parameters()]


@torch.no_grad()
def init_parameters(module: nn.Module, config: ProGenConfig, seed: int,
                    tp: TP | None = None) -> None:
    """Seeded initialisers that mirror flax's: truncated normal 0.02 for
    the embedding, lecun-normal for every Dense weight, zeros for Dense
    biases, ones for norm scales and SGU biases, uniform
    +-sgu_init_eps/seq_len for the SGU weights. Drawn on the CPU in a
    fixed order over the whole model's tensors, so a seed gives the same
    weights on any device, and a module holding some of them (a pipeline
    stage) or shards of them (``tp``) gets its part of the same
    values."""
    c = config
    own = dict(module.named_parameters())
    gen = torch.Generator().manual_seed(int(seed))
    eps = c.sgu_init_eps / c.seq_len
    for name, shape in whole_parameter_shapes(c):
        leaf = name.rsplit(".", 1)[-1]
        if name == "embed":
            value = _truncated_normal(shape, 0.02, gen)
        elif leaf == "weight":
            value = _lecun_normal(shape[0], shape[1], gen)
        elif leaf == "spatial_weights":
            value = (torch.rand(shape, generator=gen) * 2 - 1) * eps
        elif leaf in ("scale", "spatial_biases"):
            value = torch.ones(shape)
        elif leaf == "bias":
            value = torch.zeros(shape)
        else:
            raise AssertionError(f"no initialiser for {name}")
        if name in own:
            if tp is not None:
                value = shard(value, layout(name, c), tp.size, tp.index)
            own[name].copy_(value.to(own[name].dtype))


def run_blocks(pairs, x, sin, cos, group, remat: bool):
    """The residual stack over (attention, feed-forward) block pairs. With
    ``remat``, each block is recomputed in the backward; the recompute
    runs the block's collectives again, on every rank in the same
    order. The blocks draw no random numbers, so the recompute restores
    no generator state, and a captured step reads none."""
    for attn, ff in pairs:
        if remat:
            x = x + checkpoint(attn, x, sin, cos, group, use_reentrant=False,
                               preserve_rng_state=False)
            x = x + checkpoint(ff, x, group, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            x = x + attn(x, sin, cos, group)
            x = x + ff(x, group)
    return x


class ProGen(nn.Module):
    def __init__(self, config: ProGenConfig, *, device="cuda",
                 seed: int | None = 0, grid=None):
        super().__init__()
        dev = resolve_device(device)
        c = config
        self.config = c
        self.grid = grid
        self.tp = tp = TP.of(grid)
        if tp is not None:
            check_divisible(c, tp.size)
        pd = c.params_dtype
        vocab = c.num_tokens // (tp.size if tp else 1)
        self.embed = nn.Parameter(torch.empty(vocab, c.dim, dtype=pd))
        self.attn = nn.ModuleList()
        self.ff = nn.ModuleList()
        for i in range(c.depth):
            use_gmlp = (c.depth - i) <= c.global_mlp_depth
            self.attn.append(LocalAttentionBlock(c, tp))
            self.ff.append(FeedForwardBlock(
                c, glu=(not use_gmlp) and c.ff_glu, spatial_gate=use_gmlp,
                tp=tp))
        self.norm = ScaleNorm(c.dim, c.layer_norm_epsilon, pd)
        self.to_logits = Dense(c.dim, c.num_tokens, param_dtype=pd, tp=tp,
                               parallel="column")
        if seed is not None:  # None: the caller loads a state dict next
            self.reset_parameters(seed)
        self.to(dev)
        self._rope: dict = {}

    def reset_parameters(self, seed: int) -> None:
        """``init_parameters`` (seeded, drawn on the CPU in a fixed
        order); a tensor-parallel model takes its shards of the whole
        model's values."""
        init_parameters(self, self.config, seed, self.tp)

    def shard_tree(self, whole: dict) -> dict:
        """This rank's part of a whole tree keyed like the parameters
        (parameters or moments): its tensor-parallel shards."""
        if self.tp is None:
            return whole
        return {n: shard(t, layout(n, self.config), self.tp.size,
                         self.tp.index) for n, t in whole.items()}

    @torch.no_grad()
    def gather_tree(self, tree: dict, device=None, keep: bool = True) -> dict:
        """The whole tree from this rank's part of it: every rank of the
        model group calls this together, tensor by tensor; those with
        ``keep`` get the whole tensors, moved to ``device`` one at a
        time, the others an empty dict."""
        out = {}
        for n, t in tree.items():
            spec = None if self.tp is None else layout(n, self.config)
            if spec is not None:
                t = unshard(_all_gather(t, self.tp.group), spec)
            if keep:
                out[n] = t.to(device) if device is not None else t
        return out

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _tables(self, n: int):
        key = (n, self.device)
        if key not in self._rope:
            self._rope[key] = fixed_pos_embedding(
                n, self.config.dim_head, device=self.device
            )
        return self._rope[key]

    def _embed(self, tokens):
        weight = self.embed.to(self.config.compute_dtype)
        if self.tp is not None:
            return vocab_embedding(tokens.long(), weight, self.tp)
        return F.embedding(tokens.long(), weight)

    def _logits(self, x):
        c = self.config
        return self.to_logits(self.norm(x, c.compute_dtype),
                              c.compute_dtype).float()

    def forward(self, tokens: torch.Tensor, grid=None) -> torch.Tensor:
        """tokens (batch, n) ints -> float32 logits (batch, n, num_tokens),
        or this rank's num_tokens/model columns of them in a
        tensor-parallel model.

        With ``grid`` (``parallel.Grid``; a tensor-parallel model always
        runs on the one it was built with) of seq size S > 1, ``tokens``
        are this rank's
        positions ``grid.seq_slice(S * n)`` of each sequence, and the
        logits are theirs; every rank of the grid's groups calls forward
        together, as its collectives need."""
        return self._logits(self._blocks(tokens, grid))

    def features(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (batch, n) ints -> the final norm's output (batch, n,
        dim) in the compute dtype: the states before the logits head."""
        return self.norm(self._blocks(tokens), self.config.compute_dtype)

    def _blocks(self, tokens: torch.Tensor, grid=None) -> torch.Tensor:
        """The embedding and every block, up to the final norm."""
        n = tokens.shape[-1]
        if n % self.config.window_size:
            raise ValueError("sequence length must be a multiple of "
                             f"window_size={self.config.window_size}")
        if self.tp is not None:
            if grid is not None and grid is not self.grid:
                raise ValueError("a tensor-parallel model runs on its own "
                                 "grid")
            grid = self.grid
        group = grid.seq_group if grid is not None and grid.seq > 1 else None
        x = self._embed(tokens)
        if group is None:
            sin, cos = self._tables(n)
        else:  # this shard's rows of the whole sequence's tables
            rows = grid.seq_slice(n * grid.seq)
            sin, cos = (t[rows] for t in self._tables(n * grid.seq))
        remat = self.config.remat and torch.is_grad_enabled()
        return run_blocks(zip(self.attn, self.ff), x, sin, cos, group, remat)

    def init_cache(self, batch: int) -> DecodeCache:
        """A fresh decode state for ``batch`` rows, each at position 0."""
        dev = self.device
        return DecodeCache(
            attn=[a.new_cache(batch, dev) for a in self.attn],
            ff=[f.new_cache(batch, dev) for f in self.ff],
            pos=torch.zeros(batch, dtype=torch.int64, device=dev),
        )

    def decode_step(self, tokens: torch.Tensor,
                    cache: DecodeCache) -> torch.Tensor:
        """Feed the token at each row's ``cache.pos``: tokens (batch,) or
        (batch, 1) -> float32 logits (batch, num_tokens) for each row's
        next position. Updates ``cache`` in place and advances every
        row's position by one."""
        c = self.config
        if self.tp is not None:
            raise NotImplementedError("decode_step runs on a whole model; "
                                      "gather a tensor-parallel one first")
        if cache.top >= c.seq_len:
            raise ValueError(f"decode position {cache.top} is past seq_len")
        x = self._embed(tokens.reshape(-1, 1))
        at = DecodeAt.of(cache.pos, *self._tables(c.seq_len), c.window_size)
        for attn, ff, ac, fc in zip(self.attn, self.ff, cache.attn,
                                    cache.ff):
            x = x + attn.decode(x, at, ac)
            x = x + ff.decode(x, at, fc)
        cache.pos.add_(1)
        cache.top += 1
        return self._logits(x)[:, 0]

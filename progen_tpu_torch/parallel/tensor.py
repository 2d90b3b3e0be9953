"""Tensor parallelism over the model group: the Megatron form of the
reference's rule table (``progen_tpu/parallel/partition.py:64-78``).

The rule table, as this port lays it on the state_dict (``layout``):
  * ``qkv`` over model: ``to_qkv`` is column-parallel, each rank holding
    q, k and v of its own heads (heads must divide over model);
    ``to_out`` is row-parallel;
  * ``mlp`` over model: ``proj_in`` is column-parallel (a GLU's x half
    and gate half each cut alike), the feed-forward's ``proj_out``
    row-parallel; the SGU's ``proj_out`` (``("sgu_hidden", "mlp")``) is
    column-parallel;
  * ``vocab`` over model: the embedding's rows and the logits head's
    columns;
  * ``embed``, the norm scales, the row-parallel biases and the SGU's
    spatial weights and biases (``sgu_hidden``, ``sgu_seq_*``) are
    replicated.
Each attention block and each feed-forward block so ends in one
all-reduce over the model group (``row_parallel_linear``). A
column-parallel layer's replicated input gets the sum over the group of
the ranks' input gradients (``column_parallel_linear``'s backward):
without it the gradients of the norm scales, the embedding and the
residual stream would be one rank's part. Both sums are taken over
float32 partial products (the operands in the compute dtype, the
products accumulated and returned in float32) and rounded once, as one
process rounds the whole product once: a rank that rounded its partial
first would round twice. In the two gMLP layers, ``proj_in``'s output is
gathered over the model group (``gather_from_model``), so the gate norm
and the SGU mix run on whole rows on every rank, as the reference's
replicated ``sgu_hidden`` has them.

``shard`` and ``unshard`` are the one place that knows a rank's slice
of each tensor: the model's init, ``convert.shard_state_dict`` and
``convert.gather_state_dict`` all go through them.

Every collective here is ``all_reduce`` or ``all_gather``, which NCCL
and gloo both carry for CUDA tensors; sums run in float32 and are
rounded once to the operand's dtype.
"""

from __future__ import annotations

import re

import torch
import torch.distributed as dist

from progen_tpu_torch.config import ProGenConfig
from progen_tpu_torch.parallel.collectives import _all_gather

# parameter name -> (dim cut in the torch layout (out, in), parts cut
# alike); None: replicated
_LAYOUT = [
    (r"embed", (0, 1)),
    (r"to_logits\.(weight|bias)", (0, 1)),
    (r"attn\.\d+\.to_qkv\.weight", (0, 3)),
    (r"attn\.\d+\.to_out\.weight", (1, 1)),
    (r"ff\.\d+\.proj_out\.weight", (1, 1)),
    (r"ff\.\d+\.sgu\.proj_out\.(weight|bias)", (0, 1)),
]
_PROJ_IN = re.compile(r"ff\.(\d+)\.proj_in\.(weight|bias)")


def layout(name: str, config: ProGenConfig):
    """(dim, parts) along which parameter ``name`` is cut over the model
    group, or None when it is replicated. ``parts`` > 1: the dim holds
    that many equal parts (q | k | v, or a GLU's x | gate), each cut
    alike, so a rank's shard is its slice of every part."""
    m = _PROJ_IN.fullmatch(name)
    if m:
        i = int(m.group(1))
        use_gmlp = (config.depth - i) <= config.global_mlp_depth
        return (0, 2 if (config.ff_glu and not use_gmlp) else 1)
    for pattern, spec in _LAYOUT:
        if re.fullmatch(pattern, name):
            return spec
    return None


def check_divisible(config: ProGenConfig, model: int) -> None:
    """Refuse a model axis the widths do not divide."""
    if model == 1:
        return
    hidden = config.dim * config.ff_mult
    for what, n in (("heads", config.heads), ("num_tokens",
                                              config.num_tokens),
                    ("dim * ff_mult", hidden), ("(dim * ff_mult) / 2",
                                                hidden // 2)):
        if n % model:
            raise ValueError(f"{what} = {n} does not divide over model "
                             f"{model}")


def shard(t: torch.Tensor, spec, model: int, index: int) -> torch.Tensor:
    """Rank ``index``'s shard of the whole tensor ``t`` (a view where it
    can be one)."""
    if spec is None or model == 1:
        return t
    dim, parts = spec
    size = t.shape[dim] // parts
    if size % model:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide "
                         f"into {parts} parts over model {model}")
    local = size // model
    pieces = [t.narrow(dim, p * size + index * local, local)
              for p in range(parts)]
    return pieces[0] if parts == 1 else torch.cat(pieces, dim)


def unshard(shards, spec) -> torch.Tensor:
    """The whole tensor from every rank's shard, in rank order."""
    if spec is None or len(shards) == 1:
        return shards[0]
    dim, parts = spec
    split = [s.chunk(parts, dim) for s in shards]
    return torch.cat([piece[p] for p in range(parts) for piece in split],
                     dim)


def all_reduce_f32(t: torch.Tensor, group, op=dist.ReduceOp.SUM):
    """The sum (or ``op``) over ``group`` of ``t``, taken in float32 and
    rounded once to ``t``'s dtype; a new tensor."""
    total = t.float().contiguous()
    if total.data_ptr() == t.data_ptr():
        total = total.clone()
    dist.all_reduce(total, op=op, group=group)
    return total.to(t.dtype)


# device type and dtype -> how ``matmul_f32`` takes a product of that
# dtype there: "out_dtype" (torch.mm's float32 output) or "float32"
# (float32 copies of the operands)
MATMUL_F32_ROUTE: dict = {}


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (m, k) @ b (k, n) accumulated and returned in float32. Operands
    in a 16-bit dtype go through ``torch.mm(..., out_dtype=float32)``
    (cuBLAS with float32 output) where this torch has it, else through
    float32 copies; float32 operands as they are."""
    if a.dtype == torch.float32:
        return a @ b
    key = (a.device.type, a.dtype)
    if MATMUL_F32_ROUTE.get(key, "out_dtype") == "out_dtype":
        try:
            out = torch.mm(a, b, out_dtype=torch.float32)
            MATMUL_F32_ROUTE[key] = "out_dtype"
            return out
        except (TypeError, RuntimeError, NotImplementedError):
            MATMUL_F32_ROUTE[key] = "float32"
    return a.float() @ b.float()


def _reduced(partial: torch.Tensor, group, dtype) -> torch.Tensor:
    dist.all_reduce(partial, group=group)
    return partial.to(dtype)


class _ColumnParallelLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        ctx.group = group
        return torch.nn.functional.linear(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        # the input is replicated: its gradient is the group's sum
        gx = _reduced(matmul_f32(g2, w), ctx.group, x.dtype)
        gw = g2.t() @ x.reshape(-1, x.shape[-1])
        return gx.view_as(x), gw, None


class _RowParallelLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        y = _reduced(matmul_f32(x.reshape(-1, x.shape[-1]), w.t()), group,
                     x.dtype)
        return y.view(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        gx = g2 @ w
        gw = g2.t() @ x.reshape(-1, x.shape[-1])
        return gx.view_as(x), gw, None


def column_parallel_linear(x: torch.Tensor, w: torch.Tensor,
                           group) -> torch.Tensor:
    """``x W^T`` for a replicated ``x`` and this rank's output rows ``W``;
    the backward sums ``x``'s gradient over ``group``."""
    return _ColumnParallelLinear.apply(x, w, group)


def row_parallel_linear(x: torch.Tensor, w: torch.Tensor,
                        group) -> torch.Tensor:
    """The sum over ``group`` of ``x W^T`` for this rank's input columns
    ``x`` and ``W``: a replicated output."""
    return _RowParallelLinear.apply(x, w, group)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
        return torch.cat(_all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        # every rank holds the whole gradient (what follows the gather
        # is replicated): keep this rank's slice
        start = dist.get_rank(ctx.group) * ctx.size
        return g.narrow(ctx.dim, start, ctx.size).contiguous(), None, None


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` forward; identity backward: a sum of the
    ranks' parts of a replicated value."""
    return _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards of ``x`` concatenated along ``dim`` in rank
    order; the backward keeps this rank's slice."""
    return _GatherFromModel.apply(x, dim, group)


class TP:
    """A module's tensor-parallel place: the model group, its size and
    this rank's index in it."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index

    @classmethod
    def of(cls, grid) -> "TP | None":
        if grid is None or grid.model == 1:
            return None
        return cls(grid.model_group, grid.model, grid.model_index)

    def __deepcopy__(self, memo) -> "TP":
        return self  # a copied module keeps its place in the group


def vocab_embedding(tokens: torch.Tensor, weight: torch.Tensor,
                    tp: TP) -> torch.Tensor:
    """The embedding of a vocab-parallel table: each rank looks up the ids
    in its rows (zeros elsewhere) and the sum over the group is the
    whole lookup."""
    rows = weight.shape[0]
    local = tokens - tp.index * rows
    mine = (local >= 0) & (local < rows)
    out = torch.nn.functional.embedding(local.clamp(0, rows - 1), weight)
    out = out * mine[..., None].to(out.dtype)
    return reduce_from_model(out, tp.group)


def vocab_token_logprobs(logits: torch.Tensor, targets: torch.Tensor,
                         tp: TP) -> torch.Tensor:
    """``log p(target)`` per position from vocab-parallel logits: logits
    (..., n, vocab / model) this rank's columns, targets (..., n) global
    ids -> (..., n) float32. The max and the sum of exponentials are
    reduced over the model group, as is the target's logit (held by one
    rank)."""
    logits = logits.float()
    cols = logits.shape[-1]
    with torch.no_grad():
        m = all_reduce_f32(logits.amax(dim=-1), tp.group, dist.ReduceOp.MAX)
    shifted = logits - m[..., None]
    sumexp = reduce_from_model(shifted.exp().sum(dim=-1), tp.group)
    local = targets.long() - tp.index * cols
    mine = (local >= 0) & (local < cols)
    picked = torch.gather(shifted, -1, local.clamp(0, cols - 1)[..., None])
    picked = reduce_from_model(picked[..., 0] * mine.to(shifted.dtype),
                               tp.group)
    return picked - torch.log(sumexp)

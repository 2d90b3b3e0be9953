"""GPipe pipeline parallelism over the stages of a grid's model axis.

Counterpart of ``progen_tpu/parallel/pipeline.py:40-262``
(``pipeline_apply``, ``pipeline_forward``, ``make_pipeline_train_step``).
As there, the model axis of the grid holds the stages (so it does not
also hold tensor-parallel shards), and stage p of P holds the uniform
layers ``[p * U / P, (p + 1) * U / P)`` of the U = depth -
global_mlp_depth uniform layers. Here each stage is a process that holds
only its own parameters (``PipelineStage``, named as the whole model's
state_dict names them): the embedding runs on stage 0; the gMLP layers,
the final norm, the logits head and the loss run on the last stage.

Schedule (GPipe): each micro-step's rows are cut into M microbatches;
every stage runs all M forwards, handing each boundary activation one
stage right, then all M backwards (the last microbatch first), handing
each boundary gradient one stage left. A stage keeps its M microbatches'
autograd graphs until its backwards (with ``config.remat``, each block
keeps only its input). With a data axis above 1, each data index runs
its own pipeline on its rows (``shard_batch``), and the stage's
gradients are summed over the data group.

The stage hop is a ``broadcast`` in the two-rank group of neighbouring
stages (NCCL and gloo both carry it for CUDA tensors; ranks that share a
card use gloo); a one-hop ``send``/``recv`` over NCCL is later work.

The step keeps the plain step's semantics (``training/step.py``): the
per-sequence loss averaged over the rows, gradients averaged over the
accumulation axis, the global norm over every stage's gradients, the
clip, masked AdamW and the finite gate, and the same metrics.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from progen_tpu_torch._device import resolve_device
from progen_tpu_torch.config import ProGenConfig
from progen_tpu_torch.models.layers import (
    Dense,
    FeedForwardBlock,
    LocalAttentionBlock,
    ScaleNorm,
)
from progen_tpu_torch.models.progen import (
    init_parameters,
    run_blocks,
    whole_parameter_shapes,
)
from progen_tpu_torch.ops.rotary import fixed_pos_embedding
from progen_tpu_torch.parallel.collectives import all_reduce_, broadcast_
from progen_tpu_torch.parallel.groups import Grid, shard_batch
from progen_tpu_torch.parallel.partition import Zero1
from progen_tpu_torch.training.loss import cross_entropy
from progen_tpu_torch.training.optimizer import (
    MaskedAdamW,
    OptimizerConfig,
    global_norm,
)
from progen_tpu_torch.training.state import TrainState


def check_stages(config: ProGenConfig, stages: int) -> int:
    """The uniform layers a stage holds; raises unless they divide."""
    n_uniform = config.depth - config.global_mlp_depth
    if n_uniform % stages:
        raise ValueError(f"{n_uniform} uniform layers not divisible by "
                         f"{stages} pipeline stages")
    return n_uniform // stages


def stage_of(name: str, config: ProGenConfig, stages: int) -> int:
    """The stage that holds parameter ``name``."""
    head = name.split(".", 1)[0]
    if head == "embed":
        return 0
    if head in ("attn", "ff"):
        i = int(name.split(".")[1])
        n_uniform = config.depth - config.global_mlp_depth
        if i < n_uniform:
            return i // check_stages(config, stages)
    return stages - 1


class PipelineStage(nn.Module):
    """Stage ``grid.model_index`` of ``grid.model``: its uniform layers,
    the embedding on stage 0, and the gMLP layers, the final norm and the
    logits head on the last. Parameters keep the whole model's names and
    take its seeded values (``init_parameters``)."""

    tp = None  # a stage holds whole tensors

    def __init__(self, config: ProGenConfig, grid: Grid, *, device="cuda",
                 seed: int | None = 0):
        super().__init__()
        if grid.seq != 1:
            raise ValueError("the pipeline runs with seq 1")
        c = config
        self.config, self.grid = c, grid
        self.stages, self.index = grid.model, grid.model_index
        per = check_stages(c, self.stages)
        self.first = self.index == 0
        self.last = self.index == self.stages - 1
        self.uniform = list(range(self.index * per, (self.index + 1) * per))
        tail = list(range(c.depth - c.global_mlp_depth, c.depth))
        pd = c.params_dtype
        if self.first:
            self.embed = nn.Parameter(torch.empty(c.num_tokens, c.dim,
                                                  dtype=pd))
        self.attn, self.ff = nn.ModuleDict(), nn.ModuleDict()
        for i in self.uniform + (tail if self.last else []):
            use_gmlp = (c.depth - i) <= c.global_mlp_depth
            self.attn[str(i)] = LocalAttentionBlock(c)
            self.ff[str(i)] = FeedForwardBlock(
                c, glu=(not use_gmlp) and c.ff_glu, spatial_gate=use_gmlp)
        self.tail = tail if self.last else []
        if self.last:
            self.norm = ScaleNorm(c.dim, c.layer_norm_epsilon, pd)
            self.to_logits = Dense(c.dim, c.num_tokens, param_dtype=pd)
        if seed is not None:
            init_parameters(self, c, seed)
        self.to(resolve_device(device))
        self._rope: dict = {}

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _tables(self, n: int):
        if n not in self._rope:
            self._rope[n] = fixed_pos_embedding(n, self.config.dim_head,
                                                device=self.device)
        return self._rope[n]

    def _run(self, layers, x):
        sin, cos = self._tables(x.shape[-2])
        remat = self.config.remat and torch.is_grad_enabled()
        pairs = [(self.attn[str(i)], self.ff[str(i)]) for i in layers]
        return run_blocks(pairs, x, sin, cos, None, remat)

    def embed_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        """Stage 0: the embedding of ids (rows, n)."""
        return F.embedding(ids.long(),
                           self.embed.to(self.config.compute_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """This stage's uniform layers on the boundary activation."""
        return self._run(self.uniform, x)

    def head_loss(self, h: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
        """The last stage: the gMLP layers, the final norm, the logits and
        the mean per-sequence loss of ``data`` (rows, n + 1)."""
        c = self.config
        x = self.norm(self._run(self.tail, h), c.compute_dtype)
        logits = self.to_logits(x, c.compute_dtype).float()
        return cross_entropy(logits, data[..., 1:]).mean()

    def shard_tree(self, whole: dict) -> dict:
        """This stage's tensors of a whole tree keyed like the
        parameters."""
        return {n: whole[n] for n, _ in self.named_parameters()}

    @torch.no_grad()
    def gather_tree(self, tree: dict, device=None, keep: bool = True) -> dict:
        """The whole tree from every stage's part (each rank of the model
        group calls this together): each tensor broadcast by the stage
        that holds it, in the whole model's order; ranks with ``keep`` get
        them (moved to ``device``), the others an empty dict."""
        g, out = self.grid, {}
        dtype = next(iter(tree.values())).dtype
        for name, shape in whole_parameter_shapes(self.config):
            owner = stage_of(name, self.config, self.stages)
            t = tree[name] if owner == self.index else torch.empty(
                shape, dtype=dtype, device=self.device)
            t = t.contiguous()
            dist.broadcast(t, src=g.rank_of(g.data_index, 0, owner),
                           group=g.model_group)
            if keep:
                out[name] = t.to(device) if device is not None else t
        return out


class StageLinks:
    """The two-rank groups of neighbouring stages: ``left`` with stage p -
    1 and ``right`` with stage p + 1 of this data index's pipeline (None
    at the ends). Every rank creates every pair, in the same order."""

    def __init__(self, grid: Grid):
        self.grid = grid
        self.left = self.right = None
        p = grid.model_index
        for d in range(grid.data):
            for q in range(grid.model - 1):
                pair = dist.new_group([grid.rank_of(d, 0, q),
                                       grid.rank_of(d, 0, q + 1)])
                if d == grid.data_index and q == p - 1:
                    self.left = pair
                if d == grid.data_index and q == p:
                    self.right = pair

    def _rank(self, stage: int) -> int:
        return self.grid.rank_of(self.grid.data_index, 0, stage)

    def send_right(self, t: torch.Tensor) -> None:
        dist.broadcast(t.detach().contiguous(),
                       src=self._rank(self.grid.model_index),
                       group=self.right)

    def recv_left(self, like: torch.Tensor) -> torch.Tensor:
        buf = torch.empty_like(like)
        dist.broadcast(buf, src=self._rank(self.grid.model_index - 1),
                       group=self.left)
        return buf

    def send_left(self, t: torch.Tensor) -> None:
        dist.broadcast(t.detach().contiguous(),
                       src=self._rank(self.grid.model_index),
                       group=self.left)

    def recv_right(self, like: torch.Tensor) -> torch.Tensor:
        buf = torch.empty_like(like)
        dist.broadcast(buf, src=self._rank(self.grid.model_index + 1),
                       group=self.right)
        return buf


def boundary_like(model: PipelineStage, rows: int) -> torch.Tensor:
    """A buffer of a boundary activation's shape and dtype."""
    c = model.config
    return torch.empty(rows, c.seq_len, c.dim, dtype=c.compute_dtype,
                       device=model.device)


def gpipe_micro_step(model: PipelineStage, links: StageLinks,
                     chunks) -> torch.Tensor:
    """One micro-step's forwards and backwards over the microbatches
    ``chunks`` (each (rows, n + 1)); gradients accumulate in ``.grad``.
    Returns the micro-step's mean loss on the last stage, 0 elsewhere."""
    m = len(chunks)
    saved, total = [], torch.zeros((), device=model.device)
    for data in chunks:
        if model.first:
            x = model.embed_tokens(data[..., :-1])
        else:
            x = links.recv_left(boundary_like(model, data.shape[0]))
            x.requires_grad_(True)
        y = model(x)
        if model.last:
            y = model.head_loss(y, data) / m
        else:
            links.send_right(y)
        saved.append((x, y))
    for x, y in reversed(saved):
        if model.last:
            y.backward()
            total = total + y.detach()
        else:
            y.backward(links.recv_right(y))
        if not model.first:
            links.send_left(x.grad)
    return total


def pipeline_forward_loss(model: PipelineStage, links: StageLinks,
                          chunks) -> torch.Tensor:
    """The forward alone (no gradient): the mean loss over ``chunks`` on
    the last stage, 0 elsewhere."""
    total = torch.zeros((), device=model.device)
    with torch.no_grad():
        for data in chunks:
            if model.first:
                x = model.embed_tokens(data[..., :-1])
            else:
                x = links.recv_left(boundary_like(model, data.shape[0]))
            y = model(x)
            if model.last:
                total = total + model.head_loss(y, data) / len(chunks)
            else:
                links.send_right(y)
    return total


def _microbatches(micro: torch.Tensor, m: int):
    if micro.shape[0] % m:
        raise ValueError(f"{micro.shape[0]} rows not divisible by {m} "
                         "pipeline microbatches")
    return micro.chunk(m)


def _local_batch(model, batch, grid):
    batch = torch.as_tensor(batch).to(model.device)
    if batch.ndim != 3:
        raise ValueError("batch must be (grad_accum, micro_batch, "
                         f"seq_len + 1), got {tuple(batch.shape)}")
    return shard_batch(batch, grid)


def reduce_stage_grads(params: dict, losses: torch.Tensor,
                       grid: Grid) -> None:
    """In place: each stage's gradients summed over its data group, the
    losses (held by the last stage) over every rank, both divided by the
    data size."""
    if grid.data > 1:
        all_reduce_([p.grad for p in params.values()], grid.replica_group,
                    1.0 / grid.data)
    all_reduce_([losses], grid.world_group, 1.0 / grid.data)


def make_pipeline_train_step(grid: Grid, n_microbatches: int
                             ) -> Callable[[TrainState, torch.Tensor],
                                           tuple[TrainState, dict]]:
    """train_step(state, batch) -> (state, metrics) through the GPipe
    schedule, for a state from ``init_pipeline_state`` on ``grid``. Every
    rank gets the whole global batch (grad_accum, rows, seq_len + 1) and
    steps together."""
    links = StageLinks(grid)

    def train_step(state: TrainState, batch: torch.Tensor):
        model, opt = state.model, state.optimizer
        batch = _local_batch(model, batch, grid)
        params = opt.params
        for p in params.values():
            p.grad = None
        losses = torch.stack([
            gpipe_micro_step(model, links,
                             _microbatches(micro, n_microbatches))
            for micro in batch])
        reduce_stage_grads(params, losses, grid)
        grads = {n: p.grad.div_(batch.shape[0]) for n, p in params.items()}
        grad_norm = global_norm([], grads.values(), grid.model_group)
        ok = bool(torch.isfinite(losses).all() & torch.isfinite(grad_norm))
        if ok:
            opt.update(grads, grad_norm)
        for p in params.values():
            p.grad = None
        state.step += 1
        return state, {
            "loss": losses.mean(), "last_micro_loss": losses[-1],
            "grad_norm": grad_norm,
            "skipped": torch.tensor(int(not ok), dtype=torch.int32)}

    return train_step


def make_pipeline_eval_step(grid: Grid, n_microbatches: int
                            ) -> Callable[[TrainState, torch.Tensor],
                                          torch.Tensor]:
    """eval_step(state, data (rows, seq_len + 1)) -> the grid's scalar
    loss on every rank: the GPipe forward alone."""
    links = StageLinks(grid)

    def eval_step(state: TrainState, data: torch.Tensor) -> torch.Tensor:
        model = state.model
        rows = _local_batch(model, torch.as_tensor(data)[None], grid)[0]
        loss = pipeline_forward_loss(model, links,
                                     _microbatches(rows, n_microbatches))
        all_reduce_([loss], grid.world_group, 1.0 / grid.data)
        return loss

    return eval_step


def init_pipeline_state(config: ProGenConfig,
                        optimizer: OptimizerConfig | None = None, *,
                        seed: int | None = 0, device="cuda", grid: Grid,
                        zero1: bool = False) -> TrainState:
    """A fresh state of this rank's stage: its part of the seeded whole
    model (``seed`` None: left for a state dict), zero moments (cut over
    the data group with ``zero1``), count 0, step 0. Every rank calls it;
    the ranks of one stage start from the first data index's values."""
    model = PipelineStage(config, grid, device=device, seed=seed)
    if seed is not None and grid.data > 1:
        broadcast_(list(model.parameters()), grid.replica_group,
                   src=grid.rank_of(0, 0, grid.model_index))
    opt = MaskedAdamW(model, optimizer or OptimizerConfig(),
                      Zero1.of(grid) if zero1 else None)
    return TrainState(step=0, model=model, optimizer=opt)

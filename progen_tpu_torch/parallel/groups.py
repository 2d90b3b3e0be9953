"""The process grid of data-, sequence- and tensor-parallel training, and
the multi-process bootstrap.

Counterpart of ``progen_tpu/parallel/partition.py``'s
``initialize_distributed`` (:135), ``is_coordinator`` (:211), ``make_mesh``
(:216) and ``put_batch`` (:367). The ranks are laid out as that mesh lays
out its devices over its axes ``(data, seq, model)``, model innermost:
``rank = (data_index * seq + seq_index) * model + model_index``, so the
ranks of one tensor-parallel group are neighbours, then those of one
sequence.

Groups (every rank belongs to one of each):
  * model: the ranks that hold the tensor-parallel shards of one layer
    for the same rows and positions (same data and seq index);
  * seq: the ranks that hold the sequence shards of the same rows (same
    data and model index);
  * data: the ranks that hold different rows (same seq and model index);
    ZeRO-1 cuts the optimizer's moments over it;
  * replica: the ranks that hold the same parameter shard (same model
    index), over which the gradients are summed.

The reference's TPU-only bootstrap cases have no counterpart here: the
GKE pod list ``TPU_WORKER_HOSTNAMES``, the GCE metadata probe and the
DCN x ICI hybrid mesh (``partition.py:127-133, 169-208, 245-252``).
``torchrun`` (one host or many) sets ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``, which is the explicit path of that
matrix.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist


def _world_size_env() -> int:
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def _default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def _init_process_group(backend: str | None, timeout: float | None) -> None:
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend or _default_backend(),
                            init_method="env://", **kw)


def initialize_distributed(backend: str | None = None, *,
                           timeout: float | None = None) -> None:
    """Join the process group when launched as one of several processes.

    Safe to call unconditionally. The matrix:
      1. already joined -> nothing;
      2. ``WORLD_SIZE`` > 1 (torchrun, or a launcher that exports the
         same variables) -> join over ``env://``. A failure RAISES: N
         processes that silently run as N independent single-process
         jobs is the worst outcome;
      3. anything else -> nothing (one process).
    ``backend``: "nccl" or "gloo" (by default nccl where a card is
    present, else gloo); ``timeout`` (seconds) bounds every collective.
    """
    if dist.is_initialized():
        return
    world = _world_size_env()
    if world <= 1:
        return
    try:
        _init_process_group(backend, timeout)
    except Exception as e:  # blind on purpose: converted to a loud abort
        raise RuntimeError(
            f"WORLD_SIZE={world} but torch.distributed.init_process_group "
            f"failed; refusing to run as {world} independent single-process "
            "jobs") from e


def is_coordinator() -> bool:
    """Rank 0 of a joined process group, or the only process: the one
    that logs, checkpoints and samples."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in the (data, seq, model) grid and its process
    groups."""

    data: int
    seq: int
    model: int
    rank: int
    data_index: int
    seq_index: int
    model_index: int
    world_group: dist.ProcessGroup
    data_group: dist.ProcessGroup
    seq_group: dist.ProcessGroup
    model_group: dist.ProcessGroup
    replica_group: dist.ProcessGroup

    @property
    def world(self) -> int:
        return self.data * self.seq * self.model

    def __deepcopy__(self, memo) -> "Grid":
        # the process groups are this process's membership, not data: a
        # copied model or train state runs on the same grid
        return self

    def seq_slice(self, n: int) -> slice:
        """This rank's positions of a whole sequence of length ``n``:
        [seq_index * n / seq, (seq_index + 1) * n / seq)."""
        if n % self.seq:
            raise ValueError(f"sequence length {n} does not divide into "
                             f"{self.seq} shards")
        local = n // self.seq
        return slice(self.seq_index * local, (self.seq_index + 1) * local)

    def rank_of(self, data_index: int, seq_index: int,
                model_index: int) -> int:
        """The global rank at grid coordinates (data, seq, model)."""
        return (data_index * self.seq + seq_index) * self.model + model_index


def init_grid(data: int, seq: int = 1, backend: str | None = None, *,
              model: int = 1, timeout: float | None = None) -> Grid:
    """Join the process group (unless joined already) and build the grid.

    Reads the usual ``torch.distributed`` environment: RANK, WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT. ``data`` = -1 takes the world size over
    ``seq * model``. ``backend``: "nccl" or "gloo"; by default "nccl"
    where a card is present, else "gloo". Several ranks that share one
    card need "gloo" (NCCL puts one rank on a card). ``timeout``
    (seconds) bounds every collective of the group. Every rank makes the
    same calls, in the same order, as ``dist.new_group`` requires."""
    if not dist.is_initialized():
        _init_process_group(backend, timeout)
    world, rank = dist.get_world_size(), dist.get_rank()
    if data == -1 and seq >= 1 and model >= 1:
        if world % (seq * model):
            raise ValueError(f"{world} processes not divisible by "
                             f"seq*model={seq * model}")
        data = world // (seq * model)
    if data < 1 or seq < 1 or model < 1:
        raise ValueError(f"grid ({data}, {seq}, {model}) must be positive")
    if world != data * seq * model:
        raise ValueError(f"world size {world} is not data {data} x seq "
                         f"{seq} x model {model} "
                         f"(WORLD_SIZE={os.environ.get('WORLD_SIZE')})")
    rest, model_index = divmod(rank, model)
    data_index, seq_index = divmod(rest, seq)

    def at(d, s, m):
        return (d * seq + s) * model + m

    mine = {}

    def groups(name, members):
        # every rank creates every group, in the same order
        for ranks in members:
            g = dist.new_group(ranks)
            if rank in ranks:
                mine[name] = g

    groups("model", [[at(d, s, m) for m in range(model)]
                     for d in range(data) for s in range(seq)])
    groups("seq", [[at(d, s, m) for s in range(seq)]
                   for d in range(data) for m in range(model)])
    groups("data", [[at(d, s, m) for d in range(data)]
                    for s in range(seq) for m in range(model)])
    groups("replica", [[at(d, s, m) for d in range(data)
                        for s in range(seq)] for m in range(model)])
    return Grid(data=data, seq=seq, model=model, rank=rank,
                data_index=data_index, seq_index=seq_index,
                model_index=model_index, world_group=dist.group.WORLD,
                data_group=mine["data"], seq_group=mine["seq"],
                model_group=mine["model"], replica_group=mine["replica"])


def shard_batch(batch: torch.Tensor, grid: Grid) -> torch.Tensor:
    """This rank's rows of a global batch ``(..., rows, seq_len + 1)``:
    rows ``[data_index * rows / data, ...)``, each whole. A rank needs the
    whole token row even where it computes only its positions, because
    the loss mask of a sequence (non-pad plus the first pad) depends on
    all of it; the model and the loss take the rank's positions. The
    ranks of one model group take the same rows."""
    rows = batch.shape[-2]
    if rows % grid.data:
        raise ValueError(f"{rows} batch rows do not divide over data "
                         f"{grid.data}")
    local = rows // grid.data
    return batch[..., grid.data_index * local:(grid.data_index + 1) * local,
                 :]

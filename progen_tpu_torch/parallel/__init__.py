"""Data- and sequence-parallel training on ``torch.distributed``.

Counterpart of the data and seq axes of ``progen_tpu/parallel/``: the
process grid (``groups.py``), the collectives the sequence-sharded model
runs as autograd functions (``collectives.py``) and the ring-halo local
attention (``ring_attention.py``). Tensor parallelism, ZeRO-1 and the
pipelines are not ported yet.
"""

from progen_tpu_torch.parallel.groups import Grid, init_grid, shard_batch

__all__ = ["Grid", "init_grid", "shard_batch"]

"""One rank of ``tests/test_torch_parallel.py``: the port's data- and
sequence-parallel path on the CPU over gloo.

``spawn_ranks`` starts ``data * seq`` ranks of ``run_rank`` and waits for
them within a time limit. Each rank loads the test's inputs, runs the
sequence-sharded forward, the gradients of the summed logits (remat off
and on, summed over the grid) and one ``make_train_step(grid)`` step, and
saves what the test compares. It imports torch and the port only.
"""

from __future__ import annotations

import os
import socket
from pathlib import Path

import torch
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(data: int, seq: int, workdir: Path, timeout: float) -> list:
    """Run the ranks of a (data, seq) grid; their results in rank order.
    Fails when a rank fails or the ranks outlast ``timeout`` seconds (the
    ranks are then killed)."""
    world, port = data * seq, _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=run_rank,
                         args=(r, data, seq, port, str(workdir), timeout))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
    finally:
        late = [p for p in procs if p.is_alive()]
        for p in late:
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if late or any(codes):
        raise AssertionError(f"ranks of grid ({data}, {seq}) failed or "
                             f"hung: exit codes {codes}")
    return [torch.load(workdir / f"rank{r}.pt") for r in range(world)]


def run_rank(rank, data, seq, port, workdir, timeout) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(data * seq),
                      GLOO_SOCKET_IFNAME="lo")
    torch.set_num_threads(1)  # the ranks share the host's cores

    from progen_tpu_torch import ProGen, ProGenConfig
    from progen_tpu_torch.parallel import init_grid, shard_batch
    from progen_tpu_torch.parallel.collectives import all_reduce_
    from progen_tpu_torch.training.optimizer import OptimizerConfig
    from progen_tpu_torch.training.step import (
        init_train_state,
        make_train_step,
    )

    grid = init_grid(data, seq, "gloo", timeout=timeout)
    inputs = torch.load(Path(workdir) / "inputs.pt")
    n = inputs["tokens"].shape[-1]
    tokens = shard_batch(inputs["tokens"], grid)[:, grid.seq_slice(n)]
    out = {"data_index": grid.data_index, "seq_index": grid.seq_index}

    for remat in (False, True):
        cfg = ProGenConfig(remat=remat, **inputs["config"])
        model = ProGen(cfg, device="cpu", seed=None)
        model.load_state_dict(inputs["state_dict"])
        logits = model(tokens, grid)
        out["logits"] = logits.detach()
        logits.sum().backward()
        grads = [p.grad for p in model.parameters()]
        all_reduce_(grads, grid.world_group)
        out[f"grads_remat_{remat}"] = {
            name: p.grad for name, p in model.named_parameters()}

    cfg = ProGenConfig(remat=True, **inputs["config"])
    state = init_train_state(cfg, OptimizerConfig(2e-4, 1e-3, 0.5),
                             device="cpu", seed=1, grid=grid)
    state.model.load_state_dict(inputs["state_dict"])
    _, metrics = make_train_step(grid)(state, inputs["batch"])
    out["metrics"] = {k: v.item() for k, v in metrics.items()}
    out["params"] = state.model.state_dict()
    torch.save(out, Path(workdir) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()

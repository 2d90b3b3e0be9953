"""Ranks of the port's tensor-parallel, ZeRO-1, pipeline and checkpoint
tests, spawned on the CPU over gloo. Imports torch and the port only.

``spawn(world, target, workdir, timeout, *args)`` starts ``world`` ranks
of ``target(rank, workdir, *args)`` (a function of this module, after the
rank has joined the process group) and waits for them within a time
limit; each rank writes ``rank{r}.pt`` into ``workdir``, which ``spawn``
returns in rank order. The inputs come from ``workdir / "inputs.pt"``:
``config`` (ProGenConfig fields), ``state_dict`` (whole), ``tokens`` and
``batch``.
"""

from __future__ import annotations

import copy
import os
import socket
from pathlib import Path

import torch
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(world: int, target: str, workdir: Path, timeout: float,
          *args) -> list:
    """Run ``world`` ranks of ``target``; their results in rank order.
    Fails when a rank fails or the ranks outlast ``timeout`` seconds
    (they are then killed)."""
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, timeout, target,
                               str(workdir), args))
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
        raise AssertionError(f"{target} ranks failed or hung: exit codes "
                             f"{codes}")
    return [torch.load(Path(workdir) / f"rank{r}.pt")
            for r in range(world)]


def _rank_main(rank, world, port, timeout, target, workdir, args):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      GLOO_SOCKET_IFNAME="lo")
    torch.set_num_threads(1)  # the ranks share the host's cores
    import torch.distributed as dist

    from progen_tpu_torch.parallel.groups import initialize_distributed

    initialize_distributed("gloo", timeout=timeout)
    out = globals()[target](rank, Path(workdir), *args)
    torch.save(out, Path(workdir) / f"rank{rank}.pt")
    dist.destroy_process_group()


def _inputs(workdir: Path) -> dict:
    return torch.load(workdir / "inputs.pt")


def _config(inputs, **kw):
    from progen_tpu_torch import ProGenConfig

    return ProGenConfig(**{**inputs["config"], **kw})


def _opt(lr: float = 2e-4):
    from progen_tpu_torch.training.optimizer import OptimizerConfig

    return OptimizerConfig(lr, 1e-3, 0.5)


def _loaded_state(inputs, grid, *, lr=2e-4, zero1=False, **kw):
    from progen_tpu_torch.training.step import init_train_state

    state = init_train_state(_config(inputs, **kw), _opt(lr), seed=None,
                             device="cpu", grid=grid, zero1=zero1)
    state.model.load_state_dict(state.model.shard_tree(inputs["state_dict"]))
    return state


def tensor_parallel(rank, workdir, data, seq, model):
    """The sharded forward and the gradients of the summed logits (remat
    off and on) summed over the grid and gathered whole, then one
    ``make_train_step(grid)`` step."""
    from progen_tpu_torch import ProGen
    from progen_tpu_torch.parallel import init_grid, shard_batch
    from progen_tpu_torch.parallel.collectives import all_reduce_
    from progen_tpu_torch.training.step import make_train_step

    grid = init_grid(data, seq, model=model)
    inputs = _inputs(workdir)
    n = inputs["tokens"].shape[-1]
    tokens = shard_batch(inputs["tokens"], grid)[:, grid.seq_slice(n)]
    out = {"coords": (grid.data_index, grid.seq_index, grid.model_index)}
    for remat in (False, True):
        net = ProGen(_config(inputs, remat=remat), device="cpu", seed=None,
                     grid=grid)
        net.load_state_dict(net.shard_tree(inputs["state_dict"]))
        logits = net(tokens)
        out["logits"] = logits.detach()
        logits.sum().backward()
        grads = {name: p.grad for name, p in net.named_parameters()}
        all_reduce_(list(grads.values()), grid.replica_group)
        out[f"grads_remat_{remat}"] = net.gather_tree(grads)
    state = _loaded_state(inputs, grid, remat=True)
    twin = copy.deepcopy(state)  # a copy runs on the same grid
    out["twin_on_grid"] = twin.model.grid is grid
    for st in (state, twin):
        _, metrics = make_train_step(grid)(st, inputs["batch"])
    out["metrics"] = {k: v.item() for k, v in metrics.items()}
    out["params"] = state.model.gather_tree(state.model.state_dict())
    out["twin_params"] = twin.model.gather_tree(twin.model.state_dict())
    return out


def zero1(rank, workdir, data, model, steps, ckpt_dir):
    """``steps`` steps of ``make_train_step(grid)`` without and with
    ZeRO-1 from the same weights; the ZeRO-1 run's state is then saved
    by the coordinator through ``get_checkpoint_fns(..., grid=grid)``."""
    from progen_tpu_torch.checkpoint import Package, get_checkpoint_fns
    from progen_tpu_torch.parallel import init_grid
    from progen_tpu_torch.training.step import make_train_step

    grid = init_grid(data, 1, model=model)
    inputs = _inputs(workdir)
    out = {"coords": (grid.data_index, grid.seq_index, grid.model_index)}
    for cut in (False, True):
        state = _loaded_state(inputs, grid, lr=1e-3, zero1=cut)
        step, metrics = make_train_step(grid), []
        for batch in inputs["batches"][:steps]:
            _, m = step(state, batch)
            metrics.append({k: v.item() for k, v in m.items()})
        opt = state.optimizer
        out[cut] = {
            "metrics": metrics,
            "params": {k: v.clone() for k, v in
                       state.model.state_dict().items()},
            "moment_bytes": {n: opt.mu[n].nbytes + opt.nu[n].nbytes
                             for n in opt.mu},
            "cut": dict(opt.cut)}
        if cut:
            _, _, save = get_checkpoint_fns(ckpt_dir, grid=grid)
            out["saved"] = save(Package(next_seq_index=8, state=state,
                                        model_config=dict(inputs["config"]),
                                        run_id="grid", train_config=None))
            whole = state.optimizer.state_dict()
            out["whole"] = {
                "params": state.model.gather_tree(state.model.state_dict()),
                "mu": state.model.gather_tree(whole["mu"]),
                "nu": state.model.gather_tree(whole["nu"]),
                "count": whole["count"], "step": state.step}
    return out


def resume(rank, workdir, data, model, ckpt_dirs):
    """For each of ``ckpt_dirs``: restore its newest checkpoint into a
    grid, keep this rank's part of it, then take one step on ``batch``."""
    from progen_tpu_torch import ProGenConfig
    from progen_tpu_torch.checkpoint import get_checkpoint_fns
    from progen_tpu_torch.parallel import init_grid
    from progen_tpu_torch.training.step import (
        init_train_state,
        make_train_step,
    )

    grid = init_grid(data, 1, model=model)
    inputs = _inputs(workdir)
    out = {"coords": (grid.data_index, grid.seq_index, grid.model_index)}
    for ckpt_dir in ckpt_dirs:
        _, get_last, _ = get_checkpoint_fns(ckpt_dir, grid=grid)
        meta = get_last.peek()
        state = init_train_state(ProGenConfig(**meta.model_config),
                                 _opt(1e-3), seed=None, device="cpu",
                                 grid=grid)
        pkg = get_last(state)
        opt = state.optimizer.state_dict()
        res = {"next_seq_index": pkg.next_seq_index, "step": state.step,
               "count": opt["count"],
               "params": {k: v.clone() for k, v in
                          state.model.state_dict().items()},
               "mu": {k: v.clone() for k, v in opt["mu"].items()},
               "nu": {k: v.clone() for k, v in opt["nu"].items()}}
        _, m = make_train_step(grid)(state, inputs["batch"])
        res["metrics"] = {k: v.item() for k, v in m.items()}
        res["after"] = state.model.gather_tree(state.model.state_dict())
        out[ckpt_dir] = res
    return out


def pipeline(rank, workdir, data, stages, schedules, microbatches):
    """For each schedule and microbatch count: the loss and gradients of
    one micro-step (the schedule's own, summed over data), gathered
    whole, then one step of its train step from the same weights."""
    from progen_tpu_torch.parallel import init_grid
    from progen_tpu_torch.parallel.pipeline import (
        StageLinks,
        _local_batch,
        gpipe_micro_step,
        init_pipeline_state,
        make_pipeline_train_step,
    )
    from progen_tpu_torch.parallel.collectives import all_reduce_
    from progen_tpu_torch.parallel.pipeline_1f1b import (
        make_1f1b_train_step,
        pipeline_1f1b_micro_step,
    )

    grid = init_grid(data, 1, model=stages)
    inputs = _inputs(workdir)
    links = StageLinks(grid)
    out = {"coords": (grid.data_index, grid.seq_index, grid.model_index)}
    micro_fn = {"gpipe": gpipe_micro_step, "1f1b": pipeline_1f1b_micro_step}
    make = {"gpipe": make_pipeline_train_step, "1f1b": make_1f1b_train_step}
    for schedule in schedules:
        for m in microbatches:
            state = init_pipeline_state(_config(inputs), _opt(1e-3),
                                        seed=None, device="cpu", grid=grid)
            net = state.model
            net.load_state_dict(net.shard_tree(inputs["state_dict"]))
            rows = _local_batch(net, inputs["batch"], grid)[0]
            loss = micro_fn[schedule](net, links, rows.chunk(m))
            grads = {n: p.grad for n, p in net.named_parameters()}
            # summed over data (each rank's rows), the loss (the last
            # stage's) shared with every stage
            all_reduce_(list(grads.values()), grid.replica_group, 1.0 / data)
            all_reduce_([loss], grid.world_group, 1.0 / data)
            res = {"loss": loss.item(), "grads": net.gather_tree(grads)}
            net.zero_grad(set_to_none=True)
            _, metrics = make[schedule](grid, m)(state, inputs["batch"])
            res["metrics"] = {k: v.item() for k, v in metrics.items()}
            res["params"] = net.gather_tree(net.state_dict())
            out[schedule, m] = res
    return out


def cli_train(rank, workdir, argv):
    """``cli.train`` on this rank with ``argv``: its steps, valid losses,
    samples and saves."""
    from progen_tpu_torch.cli import train

    res = train.run(list(argv))
    return {k: res[k] for k in ("steps", "valid_losses", "samples", "saves",
                                "next_seq_index")}

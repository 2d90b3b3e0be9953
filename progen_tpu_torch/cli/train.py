"""Training CLI: the JAX package's ``cli/train.py``, on one process or a
grid of them.

Flag names and defaults are the JAX CLI's reference-parity core and its
grid flags (``--data_parallel``, ``--mesh_data``, ``--mesh_seq``,
``--mesh_model``, ``--ring_attn``, ``--zero1``, ``--mesh_pipe``,
``--pipe_microbatches``, ``--pipe_schedule``, with the JAX CLI's
validation and error text), plus two additions: ``--device`` (default
``cuda``; a host without a card raises unless ``--device cpu`` is given)
and ``--dist_backend`` (nccl by default on the card, gloo on the CPU;
ranks that share one card need gloo). Flags of the JAX CLI that are not
ported (the async-checkpoint, profiling, stall, anomaly, Prometheus and
flight-recorder flags) are not accepted.

The grid: under ``torchrun`` (``WORLD_SIZE`` > 1) every process joins
the process group (``parallel.groups.initialize_distributed``; a failed
join raises) and takes its place in the (data, seq, model) grid;
``--data_parallel`` and ``--mesh_data 0`` give the data axis the
processes that seq x model leaves. ``--mesh_pipe`` puts pipeline stages
on the model axis (``parallel/pipeline.py``, ``pipeline_1f1b.py``).
Each process on the card takes card ``LOCAL_RANK`` modulo the cards
present. Every rank reads the whole global batch and trains on its rows
of it (``shard_batch``), so a grid consumes the records a single process
would. Only the coordinator logs and samples (from the model gathered
whole); every rank takes part in a checkpoint, which the coordinator
writes whole (``checkpoint.py``), so any grid or one process resumes it.

Loop semantics, as the JAX CLI's:
  * resume from the newest checkpoint that verifies: its ``model_config``
    overrides the TOML, and its ``train_config`` the lr schedule, warmup,
    total steps and shuffle seed;
  * the dtype: float32 unless ``--mixed_precision`` (bfloat16); without
    the flag an explicit TOML ``dtype`` wins;
  * ``cosine`` decays over the steps the data holds, capped by
    ``--num_steps``;
  * the data cursor ``next_seq_index`` counts records; the ragged tail of
    a micro-batch is padded with 0-rows;
  * checkpoint, validate and sample when ``i % every == 0``, with ``i``
    counted from 0 in each run; the cadenced sample primes with a
    validation row;
  * the first SIGTERM or SIGINT finishes the step, saves and returns
    (exit 0); a second one raises KeyboardInterrupt;
  * a final checkpoint whose cursor counts the records consumed.

Run: python -m progen_tpu_torch.cli.train [flags]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from progen_tpu_torch._device import resolve_device
from progen_tpu_torch.checkpoint import Package, get_checkpoint_fns
from progen_tpu_torch.config import ProGenConfig, load_toml_config
from progen_tpu_torch.models.progen import ProGen
from progen_tpu_torch.parallel.groups import (
    init_grid,
    initialize_distributed,
)
from progen_tpu_torch.data.dataset import iterator_from_tfrecords_folder
from progen_tpu_torch.data.tokenizer import decode_tokens
from progen_tpu_torch.sampling import row_seed, sample, sample_fast
from progen_tpu_torch.tracking import (
    is_coordinator,
    make_tracker,
    render_sample_html,
)
from progen_tpu_torch.parallel.pipeline import (
    init_pipeline_state,
    make_pipeline_eval_step,
    make_pipeline_train_step,
)
from progen_tpu_torch.parallel.pipeline_1f1b import make_1f1b_train_step
from progen_tpu_torch.training.optimizer import SCHEDULES, OptimizerConfig
from progen_tpu_torch.training.step import (
    init_train_state,
    make_eval_step,
    make_train_step,
)


def confirm(question: str) -> bool:
    """Interactive y/n guard for --new."""
    return input(f"{question} (y/n) ").strip().lower() == "y"


def step_print(step, msg: str) -> None:
    """``[HH:MM:SS step N] msg``, the JAX CLI's console line."""
    print(f"[{time.strftime('%H:%M:%S')} step {step}] {msg}", flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    return _parser().parse_args(argv)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="progen_tpu_torch.cli.train", allow_abbrev=False,
        description="Train ProGen on TFRecord shards, with checkpoints.")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--grad_accum_every", default=4, type=int)
    p.add_argument("--learning_rate", default=2e-4, type=float)
    p.add_argument("--weight_decay", default=1e-3, type=float)
    p.add_argument("--data_parallel", action="store_true")
    p.add_argument("--max_grad_norm", default=0.5, type=float)
    p.add_argument("--validate_every", default=100, type=int)
    p.add_argument("--sample_every", default=500, type=int)
    p.add_argument("--checkpoint_every", default=1000, type=int)
    p.add_argument("--checkpoint_path", default="./ckpts")
    p.add_argument("--checkpoint_keep_n", default=500, type=int)
    p.add_argument("--config_path", default="./configs/model")
    p.add_argument("--model_name", default="default")
    p.add_argument("--prime_length", default=25, type=int)
    p.add_argument("--seq_len", default=1024, type=int)
    p.add_argument("--mixed_precision", action="store_true")
    p.add_argument("--data_path", default="./train_data")
    p.add_argument("--wandb_off", action="store_true")
    p.add_argument("--wandb_project_name", default="progen-training")
    p.add_argument("--new", action="store_true")
    p.add_argument("--mesh_data", default=0, type=int,
                   help="data-parallel grid axis size (0 = auto)")
    p.add_argument("--mesh_seq", default=1, type=int,
                   help="sequence-parallel grid axis size")
    p.add_argument("--mesh_model", default=1, type=int,
                   help="tensor-parallel grid axis size")
    p.add_argument("--num_steps", default=0, type=int,
                   help="stop after N optimizer steps (0 = the whole data)")
    p.add_argument("--epochs", default=1, type=int,
                   help="passes over the training data")
    p.add_argument("--lr_schedule", default="constant", choices=SCHEDULES,
                   help="constant, or linear warmup + cosine decay over "
                        "the run")
    p.add_argument("--warmup_steps", default=0, type=int,
                   help="linear warmup steps for --lr_schedule cosine")
    p.add_argument("--shuffle_seed", default=None, type=int,
                   help="seeded reshuffle of the training data each pass "
                        "(unset: ETL order)")
    p.add_argument("--naive_sample", action="store_true",
                   help="cadenced samples by a full forward per token "
                        "instead of the KV-cache decoder")
    p.add_argument("--ring_attn", action="store_true",
                   help="halo-exchange attention over the seq grid axis "
                        "(requires --mesh_seq > 1; the port's only "
                        "sequence-parallel attention)")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: cut the AdamW moments over the data grid "
                        "axis")
    p.add_argument("--mesh_pipe", default=0, type=int,
                   help="GPipe pipeline stages over the model grid axis "
                        "(mutually exclusive with --mesh_model > 1; needs "
                        "scan_layers=true in the model TOML)")
    p.add_argument("--pipe_microbatches", default=0, type=int,
                   help="pipeline microbatches per micro-step (0 = same "
                        "as --mesh_pipe)")
    p.add_argument("--pipe_schedule", default="gpipe",
                   choices=("gpipe", "1f1b"),
                   help="pipeline schedule: gpipe or 1f1b")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--dist_backend", default=None, choices=("nccl", "gloo"),
                   help="torch.distributed backend of a grid (default: "
                        "nccl on the card, gloo on the CPU; ranks that "
                        "share one card need gloo)")
    return p


def usage_error(msg: str):
    """The JAX CLI's usage errors: the message, exit code 2."""
    _parser().error(msg)


def check_pipeline_flags(args) -> None:
    """The JAX CLI's pipeline checks of the flags alone (its order and
    text), made before the grid is built."""
    if args.mesh_model > 1:
        usage_error("--mesh_pipe repurposes the model mesh axis as the "
                    "stage axis; it is mutually exclusive with --mesh_model "
                    "> 1")
    if args.ring_attn:
        usage_error("--mesh_pipe and --ring_attn are separate deployment "
                    "paths (stages run inside shard_map; the ring rides "
                    "the seq axis of the GSPMD step)")


def check_pipeline(args, config: ProGenConfig) -> int:
    """The JAX CLI's pipeline checks of the model config (its order and
    text); the microbatch count."""
    if not config.scan_layers:
        usage_error("--mesh_pipe needs scan_layers=true in the model TOML: "
                    "the stacked 'layers' param axis IS the stage axis "
                    "(models/progen.stack_params converts old checkpoints)")
    n_uniform = config.depth - config.global_mlp_depth
    if n_uniform % args.mesh_pipe:
        usage_error(f"{n_uniform} uniform layers not divisible by "
                    f"{args.mesh_pipe} pipeline stages")
    pipe_m = args.pipe_microbatches or args.mesh_pipe
    if args.batch_size % pipe_m:
        usage_error(f"--batch_size {args.batch_size} not divisible by "
                    f"{pipe_m} pipeline microbatches")
    return pipe_m


def make_grid(args, dev: torch.device, pipe: bool):
    """Join the process group (under torchrun) and build the grid the
    flags ask for; None for one process without grid flags."""
    backend = args.dist_backend or ("nccl" if dev.type == "cuda"
                                    else "gloo")
    initialize_distributed(backend)
    world = dist.get_world_size() if dist.is_initialized() else 1
    seq, model = args.mesh_seq, args.mesh_pipe if pipe else args.mesh_model
    data = args.mesh_data
    if data == 0:
        data = -1 if (args.data_parallel or seq * model > 1) else 1
    if data == -1:
        if world % (seq * model):
            usage_error(f"{world} devices not divisible by "
                        f"seq*model={seq * model}")
        data = world // (seq * model)
    shape = (data, seq, model)
    if data * seq * model > world:
        usage_error(f"mesh shape {shape} needs {data * seq * model} > "
                    f"{world} devices")
    if data * seq * model < world:
        usage_error(f"mesh shape {shape} leaves {world} processes idle")
    if world == 1:
        return None
    return init_grid(data, seq, backend, model=model)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(argv=None) -> dict:
    """Train as the flags say. Returns what the run did: ``state`` (the
    TrainState), ``config``, ``steps`` (per step: loss, grad norm,
    skipped, ms, tokens/s), ``valid_losses``, ``samples``, ``saves``
    (each checkpoint's path and seconds), ``first_batch`` (the first
    batch trained on, on the CPU), ``start_seq_index`` and
    ``next_seq_index``; ``{"aborted": True}`` when --new is declined."""
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            torch.cuda.is_available() and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"])
                              % torch.cuda.device_count())
    dev = resolve_device(args.device)
    pipe = args.mesh_pipe > 1
    if pipe:
        check_pipeline_flags(args)
    if args.ring_attn and not pipe and args.mesh_seq < 2:
        usage_error("--ring_attn needs a sequence-parallel mesh "
                    "(--mesh_seq > 1)")
    grid = make_grid(args, dev, pipe)
    reset_ckpt, get_last, save_ckpt = get_checkpoint_fns(
        args.checkpoint_path, keep_last_n=args.checkpoint_keep_n, grid=grid)
    if args.new:
        answer = [confirm("are you sure you want to clear all your "
                          "checkpoints and restart training?")
                  if is_coordinator() else None]
        if grid is not None:
            dist.broadcast_object_list(answer, src=0)
        if not answer[0]:
            return {"aborted": True}
        reset_ckpt()

    # the model config: a resumed checkpoint's overrides the TOML
    last_meta = get_last.peek()
    if last_meta is None:
        toml_path = Path(args.config_path) / f"{args.model_name}.toml"
        if not toml_path.exists():
            raise SystemExit(f"model config not found: {toml_path}")
        model_kwargs = load_toml_config(str(toml_path))
    else:
        model_kwargs = dict(last_meta.model_config)
    model_kwargs.setdefault("seq_len", args.seq_len)
    config = ProGenConfig.from_dict(
        {**model_kwargs, "dtype": "bfloat16" if args.mixed_precision
         else model_kwargs.get("dtype", "float32")})
    pipe_m = check_pipeline(args, config) if pipe else 0
    if pipe and (args.batch_size // pipe_m) % (grid.data if grid else 1):
        usage_error(f"PPxDP composition shards each "
                    f"{args.batch_size // pipe_m}-row microbatch over the "
                    f"data axis; not divisible by data={grid.data}")
    if args.ring_attn or config.use_ring_attn:
        # the seq axis always runs the halo-exchange attention here; the
        # flag is kept in the config, as the JAX CLI keeps it
        config = dataclasses.replace(config, use_ring_attn=True)

    # the optimizer's schedule and the data order follow the checkpoint
    lr_schedule, warmup_steps = args.lr_schedule, args.warmup_steps
    shuffle_seed, total_steps = args.shuffle_seed, 0
    saved_tc = last_meta.train_config if last_meta else None
    if saved_tc:
        lr_schedule = saved_tc.get("lr_schedule", lr_schedule)
        warmup_steps = saved_tc.get("warmup_steps", warmup_steps)
        total_steps = saved_tc.get("total_steps", 0)
        shuffle_seed = saved_tc.get("shuffle_seed", shuffle_seed)
    effective_batch = args.batch_size * args.grad_accum_every
    if lr_schedule == "cosine" and not total_steps:
        n_total, _ = iterator_from_tfrecords_folder(args.data_path)
        total_steps = max(n_total * max(args.epochs, 1) // effective_batch, 1)
        if args.num_steps:
            total_steps = min(total_steps, args.num_steps)
    opt_config = OptimizerConfig(
        args.learning_rate, args.weight_decay, args.max_grad_norm,
        schedule=lr_schedule, warmup_steps=warmup_steps,
        total_steps=total_steps)
    train_config = {"lr_schedule": lr_schedule, "warmup_steps": warmup_steps,
                    "total_steps": total_steps, "shuffle_seed": shuffle_seed}

    # the state: a seeded init, or the checkpoint loaded into an empty one
    init = init_pipeline_state if pipe else init_train_state
    kw = dict(device=dev, grid=grid, zero1=args.zero1)
    start_seq_index, run_id = 0, None
    if last_meta is None:
        state = init(config, opt_config, seed=args.seed, **kw)
    else:
        state = init(config, opt_config, seed=None, **kw)
        pkg = get_last(state)
        start_seq_index, run_id = pkg.next_seq_index, pkg.run_id

    tracker = make_tracker(args.wandb_project_name, run_id,
                           disabled=args.wandb_off)
    run_id = tracker.run_id or run_id
    num_params = config.num_params()
    tracker.set_config({**config.to_dict(), "num_params": num_params})

    num_train, train_iter_fn = iterator_from_tfrecords_folder(args.data_path)
    num_valid, valid_iter_fn = iterator_from_tfrecords_folder(
        args.data_path, "valid")
    if not (num_train > 0 and num_valid > 0):
        raise SystemExit(f"no training/validation data under {args.data_path}")
    if is_coordinator():
        print(f"params: {num_params:,}")
        print(f"train sequences: {num_train:,}  valid: {num_valid:,}")

    def pad_rows(m: np.ndarray) -> np.ndarray:
        # a ragged tail is padded to the batch with 0-rows (each adds one
        # EOS position to the loss)
        return np.pad(m, ((0, args.batch_size - m.shape[0]), (0, 0)))

    def next_super_batch() -> torch.Tensor:
        micro = [pad_rows(next(train_ds))
                 for _ in range(args.grad_accum_every)]
        return torch.from_numpy(np.stack(micro))

    sample_tokens = sample if args.naive_sample else sample_fast
    if pipe:
        make = (make_1f1b_train_step if args.pipe_schedule == "1f1b"
                else make_pipeline_train_step)
        train_step = make(grid, pipe_m)
        eval_step = make_pipeline_eval_step(grid, pipe_m)
    else:
        train_step, eval_step = make_train_step(grid), make_eval_step(grid)
    saves, steps, valid_losses, samples = [], [], [], []

    def whole_model():
        """The model to sample from: the state's own, or on a tensor- or
        pipeline-parallel grid, the whole model gathered onto the
        coordinator (every rank takes part; the others get None)."""
        model = state.model
        if grid is None or (model.tp is None and not pipe):
            return model if is_coordinator() else None
        sd = model.gather_tree(model.state_dict(), keep=is_coordinator())
        if not is_coordinator():
            return None
        whole = ProGen(config, device=dev, seed=None)
        whole.load_state_dict(sd)
        return whole

    def save(next_seq_index: int) -> None:
        t = time.perf_counter()
        path = save_ckpt(Package(next_seq_index=next_seq_index, state=state,
                                 model_config=config.to_dict(),
                                 run_id=run_id, train_config=train_config))
        saves.append({"path": path, "seconds": time.perf_counter() - t})

    stop_requested = [False]

    def request_stop(signum, frame):
        if stop_requested[0]:
            raise KeyboardInterrupt
        stop_requested[0] = True
        if is_coordinator():
            print(f"signal {signum}: finishing step, then checkpoint+exit",
                  flush=True)

    handlers = {s: signal.signal(s, request_stop)
                for s in (signal.SIGTERM, signal.SIGINT)}
    # one pass over the data unless --epochs; the iterator's record index
    # is global across passes, so the cursor resumes into any pass
    num_total = num_train * max(args.epochs, 1)
    seq_cursor = start_seq_index
    start_step = state.step
    first_batch = None
    train_ds = train_iter_fn(config.seq_len, args.batch_size,
                             skip=start_seq_index, loop=True,
                             shuffle_seed=shuffle_seed)
    try:
        valid_ds = valid_iter_fn(config.seq_len, args.batch_size, loop=True)
        try:
            if seq_cursor < num_total:
                batch = next_super_batch()
                first_batch = batch
            i = 0
            while seq_cursor < num_total and not stop_requested[0]:
                if args.num_steps and i >= args.num_steps:
                    break
                t = time.perf_counter()
                state, metrics = train_step(state, batch)
                loss = float(metrics["last_micro_loss"])
                grad_norm = float(metrics["grad_norm"])
                skipped = int(metrics.get("skipped", 0))  # 1f1b: no gate
                _sync(dev)
                ms = (time.perf_counter() - t) * 1e3
                global_step = start_step + i + 1
                next_seq_index = seq_cursor + effective_batch
                is_last = ((args.num_steps and i + 1 >= args.num_steps)
                           or next_seq_index >= num_total)
                if not is_last:
                    batch = next_super_batch()
                tokens_per_s = effective_batch * config.seq_len / (ms / 1e3)
                steps.append({"step": global_step, "loss": loss,
                              "grad_norm": grad_norm, "skipped": skipped,
                              "ms": ms, "tokens_per_s": tokens_per_s})
                if is_coordinator():
                    if skipped:
                        step_print(global_step,
                                   f"anomaly: loss {loss:.4g} grad_norm "
                                   f"{grad_norm:.4g} (update refused)")
                    step_print(global_step, f"loss: {loss:.4f}")
                tracker.log({"loss": loss, "grad_norm": grad_norm,
                             "step_ms": ms, "tokens_per_sec": tokens_per_s},
                            step=global_step)

                if i % args.checkpoint_every == 0:
                    save(next_seq_index)
                if i % args.validate_every == 0:
                    vloss = float(eval_step(state, pad_rows(next(valid_ds))))
                    valid_losses.append({"step": global_step, "loss": vloss})
                    if is_coordinator():
                        step_print(global_step, f"valid_loss: {vloss:.4f}")
                    tracker.log({"valid_loss": vloss}, step=global_step)
                if i % args.sample_every == 0:
                    prime = next(valid_ds)[0, 1:args.prime_length + 1]
                    model = whole_model()
                    if model is not None:  # the coordinator
                        sampled = sample_tokens(
                            row_seed(args.seed + 1, i), model, prime,
                            config.seq_len, top_k=25, add_bos=True,
                            device=dev)
                        del model
                        prime_str = decode_tokens(prime)
                        sampled_str = decode_tokens(
                            sampled.cpu().numpy()[args.prime_length + 1:])
                        samples.append({"step": global_step,
                                        "prime": prime_str,
                                        "sample": sampled_str})
                        step_print(global_step,
                                   f"sample: {sampled_str[:120]}")
                        tracker.log_html(
                            "samples",
                            render_sample_html(prime_str, sampled_str),
                            step=global_step)
                seq_cursor = next_seq_index
                i += 1
        finally:
            valid_ds.close()
    finally:
        train_ds.close()
        for s, h in handlers.items():
            signal.signal(s, h)

    # the final checkpoint: the cursor counts the records consumed
    save(seq_cursor)
    tracker.finish()
    return {"state": state, "config": config, "steps": steps,
            "valid_losses": valid_losses, "samples": samples,
            "saves": saves, "first_batch": first_batch,
            "start_seq_index": start_seq_index,
            "next_seq_index": seq_cursor, "run_id": run_id}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Training CLI: the JAX package's ``cli/train.py`` on one device.

Flag names and defaults are the JAX CLI's reference-parity core, plus
``--device`` (default ``cuda``; a host without a card raises unless
``--device cpu`` is given). Flags of the JAX CLI that are not ported (the
mesh, ZeRO-1, pipeline, async-checkpoint, profiling, stall, anomaly,
Prometheus and flight-recorder flags) are not accepted.

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
import signal
import time
from pathlib import Path

import numpy as np
import torch

from progen_tpu_torch._device import resolve_device
from progen_tpu_torch.checkpoint import Package, get_checkpoint_fns
from progen_tpu_torch.config import ProGenConfig, load_toml_config
from progen_tpu_torch.data.dataset import iterator_from_tfrecords_folder
from progen_tpu_torch.data.tokenizer import decode_tokens
from progen_tpu_torch.sampling import row_seed, sample, sample_fast
from progen_tpu_torch.tracking import (
    is_coordinator,
    make_tracker,
    render_sample_html,
)
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
    p = argparse.ArgumentParser(
        prog="progen_tpu_torch.cli.train", allow_abbrev=False,
        description="Train ProGen on TFRecord shards, with checkpoints.")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--grad_accum_every", default=4, type=int)
    p.add_argument("--learning_rate", default=2e-4, type=float)
    p.add_argument("--weight_decay", default=1e-3, type=float)
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
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


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
    dev = resolve_device(args.device)
    reset_ckpt, get_last, save_ckpt = get_checkpoint_fns(
        args.checkpoint_path, keep_last_n=args.checkpoint_keep_n)
    if args.new:
        if not confirm("are you sure you want to clear all your checkpoints "
                       "and restart training?"):
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
    start_seq_index, run_id = 0, None
    if last_meta is None:
        state = init_train_state(config, opt_config, seed=args.seed,
                                 device=dev)
    else:
        state = init_train_state(config, opt_config, seed=None, device=dev)
        pkg = get_last(state)
        start_seq_index, run_id = pkg.next_seq_index, pkg.run_id

    tracker = make_tracker(args.wandb_project_name, run_id,
                           disabled=args.wandb_off)
    run_id = tracker.run_id or run_id
    num_params = state.num_params()
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
    train_step, eval_step = make_train_step(), make_eval_step()
    saves, steps, valid_losses, samples = [], [], [], []

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
                skipped = int(metrics["skipped"])
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
                    sampled = sample_tokens(
                        row_seed(args.seed + 1, i), state.model, prime,
                        config.seq_len, top_k=25, add_bos=True, device=dev)
                    prime_str = decode_tokens(prime)
                    sampled_str = decode_tokens(
                        sampled.cpu().numpy()[args.prime_length + 1:])
                    samples.append({"step": global_step, "prime": prime_str,
                                    "sample": sampled_str})
                    if is_coordinator():
                        step_print(global_step,
                                   f"sample: {sampled_str[:120]}")
                    tracker.log_html(
                        "samples", render_sample_html(prime_str, sampled_str),
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

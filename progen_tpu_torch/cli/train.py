"""Training CLI: the JAX package's ``cli/train.py``, on one process or a
grid of them.

Flag names and defaults are the JAX CLI's reference-parity core and its
grid flags (``--data_parallel``, ``--mesh_data``, ``--mesh_seq``,
``--mesh_model``, ``--ring_attn``, ``--zero1``, ``--mesh_pipe``,
``--pipe_microbatches``, ``--pipe_schedule``, with the JAX CLI's
validation and error text), plus two additions: ``--device`` (default
``cuda``; a host without a card raises unless ``--device cpu`` is given)
and ``--dist_backend`` (nccl by default on the card, gloo on the CPU;
ranks that share one card need gloo). The JAX CLI's telemetry and
resilience flags are the JAX CLI's, with its defaults:
``--async_checkpoint`` (the state copied to host buffers, the write in a
background thread, polled every step), ``--profile_dir`` (a
``torch.profiler`` trace of steps 2-4, CPU and CUDA activities, written
there as a Chrome trace), ``--stall_timeout``/``--stall_escalate_after``
(the stall watchdog), ``--anomaly_factor``/``--anomaly_patience`` (the
loss sentinel and its rollback) and ``--prom_file``/``--prom_port`` (the
registry's Prometheus exposition, prefix ``progen_train_``, on the
coordinator). Not accepted yet: ``--flight_dir``, ``--profile_pin`` and
the clock beacons (ROADMAP queue 1 item 3), and ``--hardware_rng`` (a
JAX PRNG switch, nothing to port).

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
  * the step's metrics are read one step late (``flush_metrics``), and
    at once before any cadence work, as the JAX CLI's are;
  * a loss the sentinel (``resilience/anomaly.py``) calls anomalous is
    skipped and logged (an ``anomaly`` event); ``--anomaly_patience`` in
    a row roll the state back to the newest checkpoint and skip the data
    ahead by ``PoisonBisector``'s offset into the window (an
    ``anomaly_rollback`` event), at most 3 windows; ``PROGEN_CHAOS``'s
    ``train/loss`` perturbs the loss the sentinel sees;
  * the wall clock goes into the goodput ledger's buckets (``compile`` is
    the first step, which builds or loads the kernels), reported at the
    end with the per-process table; ``StepTimer`` gives
    ``tokens_per_sec_per_chip`` and, on a card of known peak, ``mfu``
    (left out otherwise), logged with ``hbm/*`` on each step's line and
    set as registry gauges;
  * a final checkpoint whose cursor counts the records consumed.

Run: python -m progen_tpu_torch.cli.train [flags]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from progen_tpu_torch import profiling, telemetry
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
from progen_tpu_torch.resilience import chaos
from progen_tpu_torch.resilience.anomaly import (
    ROLLBACK,
    SPIKE,
    LossSentinel,
    PoisonBisector,
    consistent_flag,
)
from progen_tpu_torch.telemetry import (
    GoodputLedger,
    StallWatchdog,
    emit_per_host_goodput,
    get_registry,
    goodput_skew,
    hbm_gauges,
    prometheus_text,
    start_prometheus_server,
    step_print,
    write_prometheus,
)
from progen_tpu_torch.training.optimizer import SCHEDULES, OptimizerConfig
from progen_tpu_torch.training.step import (
    init_train_state,
    make_eval_step,
    make_train_step,
)


# the registry's resilience families, declared at 0 on every run so the
# exposition always carries them (an absent counter and a zero counter
# are different dashboards)
RESILIENCE_COUNTERS = (
    "retries", "anomalies", "anomaly_rollbacks", "chaos_injections",
    "stalls", "stall_escalations", "ckpt_quarantines",
    "ckpt_commit_failures",
)
MAX_ROLLBACKS = 3  # distinct poison windows; a third relapse is fatal


def confirm(question: str) -> bool:
    """Interactive y/n guard for --new."""
    return input(f"{question} (y/n) ").strip().lower() == "y"


class AnomalyRollback(Exception):
    """Raised by the metrics flush when the loss sentinel escalates
    (``patience`` consecutive anomalies); caught by the train loop, which
    restores the newest checkpoint and skips ahead in the data stream
    into the offending window."""


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
    p.add_argument("--profile_dir", default="",
                   help="torch.profiler trace dir for steps 2-4")
    p.add_argument("--async_checkpoint", action="store_true",
                   help="overlap checkpoint writes with training (the "
                        "state is copied to host buffers synchronously; "
                        "the write runs in the background and finalizes "
                        "at the next save)")
    p.add_argument("--stall_timeout", default=900.0, type=float,
                   help="stall-watchdog deadline (seconds): when no "
                        "optimizer step completes within it, dump "
                        "all-thread stacks and the open/recent telemetry "
                        "spans to stderr, then keep running (0 = off)")
    p.add_argument("--stall_escalate_after", default=3, type=int,
                   help="after N consecutive stall reports for ONE stall, "
                        "snapshot per-card memory_stats + the open-span "
                        "list into the event stream before the surrounding "
                        "timeout kills the run (0 = a single report per "
                        "stall)")
    p.add_argument("--anomaly_factor", default=6.0, type=float,
                   help="loss-spike threshold: anomalous when loss exceeds "
                        "the EMA baseline by this many deviations (0 = "
                        "non-finite detection only)")
    p.add_argument("--anomaly_patience", default=3, type=int,
                   help="consecutive anomalous steps before rolling back "
                        "to the last good checkpoint and skipping ahead in "
                        "the data stream; isolated spikes are skipped (the "
                        "train step's finite gate already refused any "
                        "non-finite update)")
    p.add_argument("--prom_file", default=None,
                   help="write train-loop Prometheus text exposition here "
                        "(goodput %%, step_ms quantiles, tokens/s/chip, "
                        "MFU, HBM gauges, resilience counters; atomic "
                        "rewrite on the --validate_every cadence and at "
                        "exit; node-exporter textfile-collector "
                        "compatible)")
    p.add_argument("--prom_port", default=0, type=int,
                   help="serve the same train-loop exposition over HTTP on "
                        "this localhost port (0 = off)")
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
    TrainState), ``config``, ``steps`` (per step whose metrics were read:
    loss as the sentinel saw it, grad norm, skipped, ms, tokens/s, and
    the StepTimer's numbers once it measures), ``valid_losses``,
    ``samples``, ``saves`` (each checkpoint's path and seconds),
    ``rollbacks`` (the anomaly_rollback records), ``goodput`` (the
    ledger's final report), ``profile`` (the trace's path and seconds,
    with --profile_dir), ``first_batch`` (the first batch trained on, on
    the CPU), ``start_seq_index`` and ``next_seq_index``; ``{"aborted":
    True}`` when --new is declined."""
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
    # fault injection (PROGEN_CHAOS="ckpt/save:0.3,data/read:kill"): a no-op
    # unless the environment asks; uninstalled on the way out, so an
    # in-process caller never leaks rules into its next run
    chaos.install_from_env()
    # the shared registry: reset, so in-process reruns do not bleed
    # counts, and every resilience family declared at 0
    reg = get_registry()
    reg.reset()
    for name in RESILIENCE_COUNTERS:
        reg.inc(name, 0)
    reset_ckpt, get_last, save_ckpt = get_checkpoint_fns(
        args.checkpoint_path, keep_last_n=args.checkpoint_keep_n, grid=grid,
        async_save=args.async_checkpoint)
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

    # spans ride the tracker's event stream (events.jsonl beside
    # metrics.jsonl; dropped by a NoopTracker); the ledger classifies the
    # loop's wall clock from here on
    telemetry.configure(sink=tracker.log_event)
    ledger = GoodputLedger()

    def render_prom() -> str:
        # goodput and the card's memory enter as gauges at render time,
        # so the file and the HTTP exposition agree
        reg.set_gauges({k.replace("/", "_"): v
                        for k, v in ledger.report().items()
                        if isinstance(v, (int, float))})
        reg.set_gauges(hbm_gauges(dev))
        return prometheus_text(reg, prefix="progen_train_")

    def publish_prom() -> None:
        if args.prom_file and is_coordinator():
            write_prometheus(args.prom_file, render_prom())

    prom_srv = None
    if args.prom_port and is_coordinator():
        prom_srv = start_prometheus_server(render_prom, port=args.prom_port)
        print(f"prometheus on http://127.0.0.1:"
              f"{prom_srv.server_address[1]}/metrics", file=sys.stderr)

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
        with ledger.track("data"):
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
    saves, steps, valid_losses, samples, rollbacks = [], [], [], [], []

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
    world = dist.get_world_size() if grid is not None else 1
    timer = profiling.StepTimer(
        n_chips=world, flops_per_tok=profiling.flops_per_token(config),
        peak=profiling.peak_flops(dev))
    # one pass over the data unless --epochs; the iterator's record index
    # is global across passes, so the cursor resumes into any pass. The
    # cursor is a variable: a rollback skips it ahead.
    num_total = num_train * max(args.epochs, 1)
    seq_cursor = start_seq_index
    start_step = state.step
    steps_done = 0
    rollbacks_done = 0  # distinct poison windows rolled back
    total_rollbacks = 0  # bisection probes included
    max_total_rollbacks = MAX_ROLLBACKS * 4
    bisector, bisect_start = None, 0
    sentinel = LossSentinel(factor=args.anomaly_factor,
                            patience=args.anomaly_patience)
    prof, profile = None, {}
    first_batch = None
    train_ds = train_iter_fn(config.seq_len, args.batch_size,
                             skip=start_seq_index, loop=True,
                             shuffle_seed=shuffle_seed)
    valid_ds = watchdog = None

    def stop_profile() -> None:
        """End the trace window and write it as a Chrome trace."""
        nonlocal prof
        t = time.perf_counter()
        prof.__exit__(None, None, None)
        path = os.path.join(args.profile_dir,
                            f"progen_train_{os.getpid()}.pt.trace.json")
        prof.export_chrome_trace(path)
        prof = None
        profile.update(path=path, seconds=profile["seconds"]
                       + time.perf_counter() - t)
        timer.exclude(time.perf_counter() - t)
        if is_coordinator():
            print(f"profile: {path} ({profile['seconds']:.1f} s)",
                  flush=True)

    try:
        # beaten once a step: a wedged step leaves stacks and open spans
        if args.stall_timeout > 0:
            watchdog = StallWatchdog(
                args.stall_timeout,
                escalate_after=args.stall_escalate_after).start()
        valid_ds = valid_iter_fn(config.seq_len, args.batch_size, loop=True)
        if seq_cursor < num_total:
            batch = next_super_batch()
            first_batch = batch

        # deferred metrics: step N's are read after step N + 1 is taken,
        # and at once before cadence work (so the sentinel always judges a
        # state before a checkpoint holds it), as the JAX CLI does
        pending = None

        def flush_metrics():
            nonlocal pending
            if pending is None:
                return
            p_step, p_metrics, p_bucket, p_ms = pending
            pending = None
            with ledger.track(p_bucket):
                loss = float(p_metrics["last_micro_loss"])
            grad_norm = float(p_metrics["grad_norm"])
            skipped = int(p_metrics.get("skipped", 0))  # 1f1b: no gate
            # the chaos perturbation point: PROGEN_CHAOS="train/loss:nan@3"
            # feeds the sentinel a poisoned value, the state untouched
            loss = chaos.perturb("train/loss", loss)
            verdict = sentinel.observe(loss, grad_norm)
            # one rank rolling back alone deadlocks the next collective:
            # any rank's verdict binds every rank
            if consistent_flag(verdict == ROLLBACK):
                raise AnomalyRollback(p_step, loss)
            if verdict == SPIKE or skipped:
                if is_coordinator():
                    step_print(p_step,
                               f"anomaly: loss {loss:.4g} grad_norm "
                               f"{grad_norm:.4g}"
                               + (" (update refused on-device)" if skipped
                                  else "")
                               + f"; {sentinel.consecutive}/"
                               f"{sentinel.patience} consecutive before "
                               "rollback")
                reg.inc("anomalies")
                telemetry.get_telemetry().emit({
                    "ev": "anomaly", "ts": time.time(), "step": p_step,
                    "loss": loss, "grad_norm": grad_norm,
                    "skipped": skipped,
                    "consecutive": sentinel.consecutive})
            perf = timer.tick(effective_batch * config.seq_len)
            if perf is not None:
                # the step_s reservoir feeds the exposition's quantiles
                reg.observe("step_s", perf["step_ms"] / 1000.0)
                reg.set_gauges({k: perf[k] for k in (
                    "tokens_per_sec_per_chip", "mfu") if k in perf})
            steps.append({"step": p_step, "loss": loss,
                          "grad_norm": grad_norm, "skipped": skipped,
                          "ms": p_ms,
                          "tokens_per_s": effective_batch * config.seq_len
                          / (p_ms / 1e3), **(perf or {})})
            with ledger.track("log"):
                if is_coordinator():
                    step_print(p_step, f"loss: {loss:.4f}")
                tracker.log({"loss": loss, "grad_norm": grad_norm,
                             **({"anomaly": 1} if verdict != "ok" else {}),
                             **(perf or {}), **hbm_gauges(dev)},
                            step=p_step)

        i = 0
        while seq_cursor < num_total:
            try:
                seq_index = seq_cursor
                if stop_requested[0]:
                    break
                if args.num_steps and steps_done >= args.num_steps:
                    break
                if args.profile_dir and i == 2 and not profile:
                    os.makedirs(args.profile_dir, exist_ok=True)
                    t = time.perf_counter()
                    acts = [torch.profiler.ProfilerActivity.CPU]
                    if dev.type == "cuda":
                        acts.append(torch.profiler.ProfilerActivity.CUDA)
                    prof = torch.profiler.profile(activities=acts)
                    prof.__enter__()
                    profile.update(first_step=start_step + steps_done + 1,
                                   seconds=time.perf_counter() - t)
                # the first step builds or loads the kernels and warms
                # the libraries: compile time, not step time
                step_bucket = "compile" if steps_done == 0 else "step"
                t = time.perf_counter()
                with ledger.track(step_bucket), \
                        telemetry.span("train/step"):
                    state, metrics = train_step(state, batch)
                    _sync(dev)
                ms = (time.perf_counter() - t) * 1e3
                steps_done += 1
                # the next batch is read while the metrics wait
                is_last = ((args.num_steps and steps_done >= args.num_steps)
                           or seq_index + effective_batch >= num_total)
                if not is_last:
                    batch = next_super_batch()
                global_step = start_step + steps_done
                flush_metrics()  # the previous step's
                pending = (global_step, metrics, step_bucket, ms)
                if watchdog is not None:
                    watchdog.beat()
                if args.async_checkpoint:
                    # a failed background write raises here, at the next
                    # step, with a ckpt_commit_failed event
                    save_ckpt.check_error()
                # every condition that writes a checkpoint below is
                # covered, so no unjudged state enters the rotation
                do_ckpt = i % args.checkpoint_every == 0
                do_valid = i % args.validate_every == 0
                do_sample = i % args.sample_every == 0
                if is_last or prof is not None or do_ckpt or do_valid \
                        or do_sample:
                    flush_metrics()
                if prof is not None and i >= 4:
                    stop_profile()

                next_seq_index = seq_index + effective_batch
                # cadence work between step timings: each block bills its
                # goodput bucket and is excluded from the StepTimer window
                if do_ckpt:
                    with telemetry.span("train/ckpt", step=global_step), \
                            ledger.track("checkpoint") as tr:
                        save(next_seq_index)
                    timer.exclude(tr.seconds)
                if do_valid:
                    with telemetry.span("train/eval", step=global_step), \
                            ledger.track("eval") as tr:
                        vloss = float(eval_step(state,
                                                pad_rows(next(valid_ds))))
                    timer.exclude(tr.seconds)
                    valid_losses.append({"step": global_step,
                                         "loss": vloss})
                    if is_coordinator():
                        step_print(global_step, f"valid_loss: {vloss:.4f}")
                    tracker.log({"valid_loss": vloss, **ledger.report()},
                                step=global_step)
                    publish_prom()  # the goodput log line's cadence
                if do_sample:
                    with telemetry.span("train/sample", step=global_step), \
                            ledger.track("sample") as tr:
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
                                sampled.cpu().numpy()[args.prime_length
                                                      + 1:])
                            samples.append({"step": global_step,
                                            "prime": prime_str,
                                            "sample": sampled_str})
                            step_print(global_step,
                                       f"sample: {sampled_str[:120]}")
                            tracker.log_html(
                                "samples",
                                render_sample_html(prime_str, sampled_str),
                                step=global_step)
                    timer.exclude(tr.seconds)
                seq_cursor = next_seq_index
                i += 1
            except AnomalyRollback as exc:
                total_rollbacks += 1
                pending = None  # the queued step's metrics are discarded
                step_at, bad_loss = exc.args
                # the same window re-spiking feeds the bisector; anything
                # else opens a fresh window
                same_window = (bisector is not None
                               and not bisector.exhausted
                               and seq_cursor
                               < bisect_start + 3 * effective_batch)
                if same_window:
                    bisector.observe_respike()
                else:
                    rollbacks_done += 1
                    bisect_start = seq_cursor
                    bisector = PoisonBisector(effective_batch,
                                              min_step=args.batch_size)
                if (rollbacks_done > MAX_ROLLBACKS
                        or total_rollbacks > max_total_rollbacks):
                    raise RuntimeError(
                        f"{total_rollbacks} anomaly rollbacks without "
                        f"recovery (last loss {bad_loss} at step "
                        f"{step_at}); skipping data is not fixing this — "
                        "inspect the stream/hparams") from exc
                with telemetry.span("train/rollback", step=step_at), \
                        ledger.track("checkpoint") as tr:
                    # get_last finalizes an in-flight asynchronous save
                    # first, so the walk sees the newest checkpoint
                    if get_last(state) is None:
                        raise RuntimeError(
                            f"anomaly rollback requested at step {step_at} "
                            "but no checkpoint exists to roll back to"
                        ) from exc
                    # skip into the offending window, not past it: the
                    # bisector's offset (whole window once exhausted)
                    skip = bisector.propose()
                    seq_cursor = bisect_start + skip
                    train_ds.close()
                    train_ds = train_iter_fn(config.seq_len, args.batch_size,
                                             skip=seq_cursor, loop=True,
                                             shuffle_seed=shuffle_seed)
                    sentinel.reset()
                    if seq_cursor < num_total:
                        batch = next_super_batch()
                timer.exclude(tr.seconds)
                restored_step = state.step
                if is_coordinator():
                    step_print(
                        step_at,
                        f"anomaly rollback {rollbacks_done}/{MAX_ROLLBACKS}: "
                        f"restored checkpoint (state step {restored_step}), "
                        f"data skipped ahead to sequence {seq_cursor} "
                        f"(bisect: {skip}/{bisector.window} of the window "
                        f"discarded, {bisector.salvaged} salvaged)")
                reg.inc("anomaly_rollbacks")
                record = {
                    "ev": "anomaly_rollback", "ts": time.time(),
                    "step": step_at, "loss": bad_loss,
                    "restored_step": restored_step,
                    "next_seq_index": seq_cursor,
                    "rollbacks_done": rollbacks_done,
                    "total_rollbacks": total_rollbacks,
                    "bisect_skip": skip,
                    "bisect_window": bisector.window,
                    "bisect_salvaged": bisector.salvaged}
                rollbacks.append(record)
                telemetry.get_telemetry().emit(dict(record))
                if watchdog is not None:
                    watchdog.beat()
        # a stop or the data's end leaves the last step queued: its
        # verdict lands before the final save; a rollback verdict here just
        # ends the run (that state passed the finite gate)
        try:
            flush_metrics()
        except AnomalyRollback:
            pass
        report = ledger.report()
        tracker.log(report, step=start_step + steps_done)
        if is_coordinator():
            step_print(start_step + steps_done,
                       f"goodput: {report['goodput_pct']:.1f}% of "
                       f"{report['wall_s']:.1f}s wall "
                       f"(attributed {report['coverage_pct']:.1f}%)")
        # per-process goodput (collective: every rank reaches this line)
        host_reports = emit_per_host_goodput(ledger)
        if is_coordinator() and len(host_reports) > 1:
            skew = goodput_skew(host_reports)
            worst = max(((row["skew"], name, row["straggler"])
                         for name, row in skew.items()
                         if isinstance(row, dict) and name != "goodput_pct"),
                        default=None)
            if worst is not None:
                step_print(start_step + steps_done,
                           f"goodput skew across {skew['hosts']} hosts: "
                           f"worst bucket '{worst[1]}' +{worst[0]:.2f}s on "
                           f"host {worst[2]}")
        publish_prom()  # the final exposition carries the run's books
    finally:
        # nested, so each clean-up runs even when an earlier one raises
        try:
            chaos.uninstall()
            if prom_srv is not None:
                prom_srv.shutdown()
            if watchdog is not None:
                watchdog.stop()
            if prof is not None:
                stop_profile()
            # detach the span sink before the tracker closes its files
            telemetry.configure()
        finally:
            try:
                # publish a finished background write, even on an abort:
                # every cadenced save's state was judged by the sentinel
                save_ckpt.close()
            finally:
                try:
                    train_ds.close()
                finally:
                    if valid_ds is not None:
                        valid_ds.close()
                    for s, h in handlers.items():
                        signal.signal(s, h)

    # the final checkpoint: the cursor counts the records consumed plus
    # any rollback's skip, so a resume re-reads neither
    save(seq_cursor)
    save_ckpt.close()  # asynchronous: publish the final save before exit
    tracker.finish()
    return {"state": state, "config": config, "steps": steps,
            "valid_losses": valid_losses, "samples": samples,
            "saves": saves, "rollbacks": rollbacks, "goodput": report,
            "profile": profile, "first_batch": first_batch,
            "start_seq_index": start_seq_index,
            "next_seq_index": seq_cursor, "run_id": run_id}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

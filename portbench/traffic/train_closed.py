"""Closed-loop training: the program's ``make_train_step`` called back to
back on fresh batches of synthetic proteins, one step after another.

Set-up builds one training state (the configuration's family's
``program_train_state``, filled with the benchmark's seeded weights),
drives it through its first steps with the window's own call and feed,
and hands that same state to the window. The reference follows those
first steps from the same weights on the same batches once the window
has closed and the program's state is freed; the numbers compared are
each step's loss, the first gradient as the optimizer took it (its
first moment over 1 - b1) and the change of every tensor over the first
steps.

The window runs whole optimizer steps until ``--seconds`` have passed;
its rate is the tokens of every row of every step (each protein with
its BOS and EOS, pad left out) over the time from the window's start to
the end of its last step, synchronised. With ``--trace 1`` each step's
span ends with its loss read; after the window, the profiler's two
sessions (``trace.py``) each trace ``profile_steps`` steps (the cell's
file), which fall outside the window and its rate.

The model, its seeded weights, its kernels' work and its reference are
the configuration's family's (``families/``).
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from portbench import compare, proteins
from portbench.harness import Outcome, Readings, release
from portbench.reference import fp8, no_tf32
from portbench.reference import train as plain_train
from portbench.trace import traced

B1 = plain_train.B1


def _optimizer(params: dict) -> plain_train.Optimizer:
    keys = ("learning_rate", "weight_decay", "max_grad_norm")
    return plain_train.Optimizer(**{k: params[k] for k in keys
                                    if k in params})


def batches(ctx):
    """The cell's feed: a function giving the next (grad_accum,
    micro_batch, seq_len + 1) batch of fresh rows and its tokens."""
    p, spec = ctx.cell.params, ctx.cell.spec
    shape = (p["grad_accum"], p["micro_batch"], spec.seq_len + 1)
    stream = proteins.Proteins(ctx.seed, p, shape[0] * shape[1])

    def next_batch() -> tuple:
        seqs = [stream.next()[1] for _ in range(shape[0] * shape[1])]
        return (proteins.encode_rows(seqs, shape[2]).reshape(shape),
                proteins.row_tokens(seqs))

    return next_batch


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _norms(tensors: dict, scale: float = 1.0) -> dict:
    return {n: float(torch.linalg.vector_norm(t.detach().double())) * scale
            for n, t in tensors.items()}


def _program(ctx, first: list):
    """The program's state and step, driven through the first batches.
    Returns (state, step, readings of those steps)."""
    from progen_tpu_torch.training.optimizer import OptimizerConfig
    from progen_tpu_torch.training.step import make_train_step

    cell = ctx.cell
    opt = _optimizer(cell.params)
    state = cell.family.program_train_state(
        cell.raw_config, OptimizerConfig(opt.learning_rate, opt.weight_decay,
                                         opt.max_grad_norm), ctx.device)
    state.model.load_state_dict(cell.weights(ctx.seed, ctx.device))
    ctx.mark("weights")
    step = make_train_step()
    got = {"losses": []}
    for k, batch in enumerate(first):
        state, metrics = step(state, torch.from_numpy(batch))
        got["losses"].append(float(metrics["loss"]))
        if k == 0:  # the first moment holds (1 - b1) x the clipped grad
            got["grad_norms"] = _norms(state.optimizer.mu, 1 / (1 - B1))
    start = cell.weights(ctx.seed, ctx.device)
    with torch.no_grad():
        got["change_norms"] = {
            n: float(torch.linalg.vector_norm((p - start[n]).double()))
            for n, p in state.model.named_parameters()}
    del start
    ctx.mark("first_steps")
    return state, step, got


def _window(ctx, state, step, next_batch) -> dict:
    """The measured window, and with ``--trace 1`` the profiled steps
    after it; returns the window's counts and times, and the trace."""
    step_spans = []

    def traced_step(state, spans=True):
        with torch.autograd.profiler.record_function("portbench.data"):
            batch, n = next_batch()
            batch = torch.from_numpy(batch)
        ts = time.perf_counter()
        with torch.autograd.profiler.record_function(
                "portbench.train_step"):
            state, metrics = step(state, batch)
            float(metrics["loss"])  # the span ends with the loss read
        if spans:
            step_spans.append(time.perf_counter() - ts)
        return state, metrics, n

    from progen_tpu_torch.ops import launches

    launches.reset_counts()
    steps = skipped = tokens = 0
    ctx.window_opens()
    t0 = time.perf_counter()
    marks = [t0]  # the host's return from each step
    while True:
        if ctx.trace:
            state, metrics, n = traced_step(state)
        else:
            batch, n = next_batch()
            state, metrics = step(state, torch.from_numpy(batch))
        steps += 1
        tokens += n
        skipped += int(metrics["skipped"])
        marks.append(time.perf_counter())
        if marks[-1] - t0 >= ctx.seconds:
            break
    _sync(ctx.device)
    elapsed = time.perf_counter() - t0
    counted = launches.launch_counts()
    summary = trace_s = None
    if ctx.trace:
        def drive(sessions):
            nonlocal state
            for i in range(sessions.total):
                sessions.before(i)
                state = traced_step(state, spans=False)[0]
            sessions.before(sessions.total)

        t = time.perf_counter()
        summary = traced(ctx.device, ctx.cell.settings["profile_steps"],
                         drive, ctx.cell.family.KERNEL_NAMES)
        trace_s = time.perf_counter() - t
    return dict(steps=steps, skipped=skipped, tokens=tokens,
                elapsed=elapsed, step_spans=step_spans,
                launches=counted, summary=summary, trace_s=trace_s,
                returns_ms=[round(1e3 * (b - a), 1)
                            for a, b in zip(marks, marks[1:])])


def run(ctx) -> Outcome:
    cell, spec, p = ctx.cell, ctx.cell.spec, ctx.cell.params
    family = cell.family
    next_batch = batches(ctx)
    first = [next_batch()[0] for _ in range(int(p["first_steps"]))]
    rows = int(cell.settings["reference_rows"])
    opt = _optimizer(p)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    info, rates, readings = {}, {}, None
    if ctx.variant == "control":
        with no_tf32():
            got = plain_train.train(cell.weights(ctx.seed, ctx.device),
                                    spec, first, opt,
                                    rows_nll=family.rows_nll,
                                    rows_per_block=rows, linear=fp8.linear)
        attempted = failed = 0
        peak = 0
    else:
        state, step, got = _program(ctx, first)
        w = _window(ctx, state, step, next_batch)
        peak = (torch.cuda.max_memory_allocated(ctx.device)
                if ctx.device.type == "cuda" else 0)
        del state, step
        release()
        rates["train_tokens_per_s"] = w["tokens"] / w["elapsed"]
        attempted, failed = w["steps"], w["skipped"]
        summary = w["summary"]
        if ctx.trace:
            info["trace_s"] = w["trace_s"]
        traced = int(cell.settings["profile_steps"]) if ctx.trace else 0
        readings = Readings(
            cell=cell,
            spans={"train_step": w["step_spans"]},
            values={"tokens_per_s": rates["train_tokens_per_s"],
                    "traced_steps_window_s": traced * w["elapsed"]
                    / w["steps"],
                    "traced_passes": dict(
                        rows=p["micro_batch"],
                        **{k: traced * n for k, n in
                           family.train_step_passes(
                               spec, p["grad_accum"]).items()}),
                    "device_name": _device_name(ctx.device)},
            trace=summary)
        positions = p["grad_accum"] * p["micro_batch"] * spec.seq_len
        info.update(steps=w["steps"], tokens=w["tokens"],
                    positions=w["steps"] * positions, window_s=w["elapsed"],
                    launches=w["launches"], returns_ms=w["returns_ms"])
        if w["step_spans"]:
            info["step_ms_median"] = 1e3 * statistics.median(w["step_spans"])
    with no_tf32():
        want = plain_train.train(cell.weights(ctx.seed, ctx.device),
                                 spec, first, opt, rows_nll=family.rows_nll,
                                 rows_per_block=rows)
    numbers = compare.train_numbers(got, want)
    info["worst_tensor"] = numbers.pop("_worst")
    info["quiet_tensors"] = sorted(set(want["grad_norms"])
                                   - compare.moving_leaves(want["grad_norms"]))
    info["losses"] = {"program": got["losses"], "reference": want["losses"]}
    if not all(math.isfinite(x) for x in got["losses"]):
        numbers["loss_gap"] = float("inf")
    return Outcome(attempted=attempted, failed=failed, rates=rates,
                   numbers=numbers, memory_peak_bytes=peak,
                   readings=readings, info=info)


def _device_name(device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"

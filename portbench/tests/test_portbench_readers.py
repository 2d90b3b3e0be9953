"""The readers of the host's timers and of the frozen counts, on the
benchmark's own cells: each reads its number from hand-made readings,
with the FLOPs and the kernels' work those cells had before families
were files of their own. (The program's spans' readers are
``test_portbench_program_spans.py``'s, ``replay_pct.train``
``test_portbench_replay_pct.py``'s, ``idle_pct.train``
``test_portbench_trace.py``'s.)"""

import pytest

from portbench import harness
from portbench.tests.tiny import CHECKOUT
from portbench.trace import Summary

H100 = "NVIDIA H100 80GB HBM3"
# kernel id -> ms of the traced passes' work: a training step at
# micro-batch 4 (8 forwards with remat's, 4 backwards), 6 scored batches
WORK = {
    ("train-base-4x4", "train"): {
        "A1": 1.9231196847761192, "A2": 2.086549613751264,
        "L1": 1.9235891964179104, "L2": 0.2604811462686567},
    ("train-large-4x4", "train"): {
        "A1": 3.365459448358209, "A2": 3.651461824064712,
        "L1": 3.366281093731343, "L2": 0.4408029611940299},
    ("score-base-b32", "score"): {
        "A1": 11.538718108656715, "A2": 0.0, "L1": 11.539070242388059,
        "L2": 1.457408152835821},
}
FLOPS = {"train-base-4x4": 2_722_844_160, "train-large-4x4": 7_902_830_592,
         "score-base-b32": 2_722_844_160}
PASSES = {"train": dict(rows=4, forwards=8, backwards=4),
          "score": dict(rows=32, forwards=6, backwards=0)}


def readings(cell, kind, trace=None, **values):
    bench = harness.Bench(CHECKOUT)
    return bench, harness.Readings(
        cell=bench.cell(cell), spans={"train_step": [0.25, 0.5, 0.375]},
        trace=trace, values=dict(values, traced_passes=PASSES[kind],
                                 device_name=H100))


def trace_of(kernel_s, busy_s=1.0):
    return Summary(window_s=2.0, busy_s=busy_s, device_ops=[], idle_gaps=[],
                   kernel_s=kernel_s, device_s=busy_s)


@pytest.mark.parametrize("cell, kind", sorted(WORK))
def test_mfu_reads_the_frozen_flops(cell, kind):
    bench, r = readings(cell, kind, tokens_per_s=14_000.0)
    share = FLOPS[cell] * 14_000.0 / 989e12 * 100
    if kind == "score":
        share /= 3
    assert bench.reader(f"mfu.{kind}")(r) == pytest.approx(share, rel=1e-12)


@pytest.mark.parametrize("cell, kind", sorted(WORK))
def test_kernels_roofline_reads_the_frozen_work(cell, kind):
    work = WORK[cell, kind]
    spent = {rid: 4 * ms / 1e3 for rid, ms in work.items() if ms > 0}
    bench, r = readings(cell, kind, trace=trace_of(spent))
    assert bench.reader(f"kernels_roofline.{kind}")(r) == pytest.approx(
        25.0, rel=1e-12)
    assert harness.kernel_shares(r.cell, r) == pytest.approx(
        {rid: 25.0 for rid in spent}, rel=1e-12)
    r.trace = None
    assert bench.reader(f"kernels_roofline.{kind}")(r) is None


def test_the_host_timers_readers():
    bench, r = readings("train-base-4x4", "train")
    assert bench.reader("step_max_ms.train")(r) == 500.0
    bench, r = readings("score-base-b32", "score",
                        host_s_per_batch=0.0125)
    assert bench.reader("scorer_host_ms.score")(r) == 12.5
    r.values = {}
    assert bench.reader("scorer_host_ms.score")(r) is None


def test_idle_pct_score_reads_the_window_s_batches():
    bench, r = readings("score-base-b32", "score",
                        trace=trace_of({}, busy_s=0.6),
                        traced_steps_window_s=0.8)
    assert bench.reader("idle_pct.score")(r) == pytest.approx(25.0)


def test_every_reader_is_a_metric_of_the_benchmark():
    """No reader is left behind by a metric that was taken out."""
    bench = harness.Bench(CHECKOUT)
    files = {p.name.removesuffix(".py")
             for p in (CHECKOUT / "portbench" / "metrics").glob("*.py")}
    assert files == {m["name"] for m in bench.data["per_layer"]}

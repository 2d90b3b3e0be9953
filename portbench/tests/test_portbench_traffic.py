"""Each traffic runner on the CPU at a tiny size, through every part of
a run but the look for a card: the program comes out correct, and the
control and each planted fault come out not correct."""

import pytest

from portbench import faults
from portbench.tests import tiny

KINDS = ("train_closed", "score_library")


@pytest.mark.parametrize("seed", tiny.SEEDS)
@pytest.mark.parametrize("kind", KINDS)
def test_the_program_is_correct(kind, seed):
    ctx, outcome, rows, ok = tiny.execute(kind, seed)
    assert ok, rows
    assert outcome.attempted > 0 and outcome.failed == 0
    assert ctx.setup_s > 0
    (rate,) = outcome.rates.values()
    assert rate > 0


@pytest.mark.parametrize("seed", tiny.SEEDS)
@pytest.mark.parametrize("kind", KINDS)
def test_the_control_is_not_correct(kind, seed):
    """The reference in 8-bit products in the program's place."""
    _, _, rows, ok = tiny.execute(kind, seed, variant="control")
    assert not ok, rows


@pytest.mark.parametrize("kind, fault", [
    (kind, name) for kind in KINDS for name in faults.BY_KIND[kind]])
def test_a_planted_fault_is_not_correct(kind, fault):
    with faults.BY_KIND[kind][fault]():
        _, _, rows, ok = tiny.execute(kind, tiny.SEEDS[0])
    assert not ok, rows


@pytest.mark.parametrize("kind, want", [
    ("train_closed", {"step_max_ms.train", "host_wait_ms.train",
                      "update_ms.train"}),
    ("score_library", {"scorer_host_ms.score", "forward_ms.score",
                       "fetch_wait_ms.score"})])
def test_a_traced_run_reads_its_host_metrics(monkeypatch, kind, want):
    """On the CPU the profiler sees no device and no rate has a peak, so
    the trace's metrics and the shares of the peak are left out, and no
    step replays; the host's metrics and the program's spans are read,
    in a process whose ring of spans holds this run alone (as
    ``run.py``'s does)."""
    from portbench import harness
    from progen_tpu_torch.telemetry import spans

    monkeypatch.setattr(spans, "_GLOBAL", spans.Telemetry())
    ctx, outcome, rows, ok = tiny.execute(kind, tiny.SEEDS[1], trace=True)
    line = harness.result(ctx.cell, ctx, outcome, tiny.bench(),
                          harness.device_info(tiny.CPU), ok, rows)
    assert line["correct"]
    assert set(line["metrics"]) == want
    assert list(line)[-1] == "checks"


def test_the_window_counts_a_stall(monkeypatch):
    """A step that stalls inside the window lengthens the window: the
    rate is all the work over all the time."""
    import time

    from progen_tpu_torch.training import step as step_mod

    real = step_mod.make_train_step
    calls = []

    def stalling(grid=None):
        inner = real(grid)

        def step(state, batch):
            calls.append(1)
            if len(calls) == 4:  # the window's first step (3 in set-up)
                time.sleep(1.0)
            return inner(state, batch)

        return step

    monkeypatch.setattr(step_mod, "make_train_step", stalling)
    _, outcome, _, _ = tiny.execute("train_closed", tiny.SEEDS[0],
                                    seconds=0.2)
    info = outcome.info
    assert info["window_s"] >= 1.0 and info["steps"] >= 1
    assert 0 < info["tokens"] < info["positions"]  # pad is not counted
    assert outcome.rates["train_tokens_per_s"] == pytest.approx(
        info["tokens"] / info["window_s"])

"""The readers of the program's spans (``program_spans.py`` and the six
metrics that read it): the window sliced from the ring, nothing where
the ring lost part of it or the program keeps none, each reader's
median, and the runners' traced runs on the CPU."""

import types

import pytest

from portbench import harness, program_spans
from portbench.tests import tiny
from progen_tpu_torch.telemetry import spans

FIRST = 3  # tiny.cell's first_steps


class Ring:
    """A synthetic ring: ``step`` and ``run`` append closed spans, their
    lengths given in ms, children first, as the program closes them."""

    def __init__(self, first_id=0):
        self.spans, self.ids, self.now = [], iter(range(first_id, 10**9)), 0

    def add(self, name, ms, parent, wait=False):
        sid, t0 = next(self.ids), self.now
        self.now += int(ms * 1e6)
        self.spans.append(spans.Closed(name, sid, parent, 1, t0, self.now,
                                       wait))

    def close(self, name, sid, parent, t0):
        self.spans.append(spans.Closed(name, sid, parent, 1, t0, self.now,
                                       False))

    def step(self, fwd, bwd, update, waits):
        """One ``step/run``: h2d, forward and backward per micro-batch,
        the gate, and an update (None: skipped) with clip and adamw
        inside."""
        root, t0 = next(self.ids), self.now
        self.add("step/h2d", waits[0], root, wait=True)
        for f, b in zip(fwd, bwd):
            self.add("step/forward", f, root)
            self.add("step/backward", b, root)
        self.add("step/gate", waits[1], root, wait=True)
        if update is not None:
            up, u0 = next(self.ids), self.now
            self.add("step/clip", update / 2, up)
            self.add("step/adamw", update / 2, up)
            self.close("step/update", up, root, u0)
        self.close("step/run", root, None, t0)

    def run(self, batches):
        """One ``score/run`` of ``batches`` (forward ms, fetch ms)."""
        run, t0 = next(self.ids), self.now
        for fwd, fetch in batches:
            flush, f0 = next(self.ids), self.now
            self.add("score/collate", 0.5, flush)
            self.add("score/forward", fwd, flush)
            self.add("score/fetch", fetch, flush, wait=True)
            self.add("score/write", 2.0, flush)
            self.close("score/flush", flush, run, f0)
        self.close("score/run", run, None, t0)


def install(monkeypatch, ring_spans, dropped=0):
    fake = types.SimpleNamespace(closed_spans=lambda: list(ring_spans),
                                 dropped=dropped)
    monkeypatch.setattr(spans, "_GLOBAL", fake)


def train_readings(window):
    cell = tiny.cell("train_closed")
    return harness.Readings(cell=cell, spans={"train_step": [1.0] * window},
                            values={})


def score_readings():
    return harness.Readings(cell=tiny.cell("score_library"), spans={},
                            values={})


def training_ring():
    """3 set-up steps, a window of 3 (one skipped by the gate), 2 traced
    steps; each phase's numbers tell the phases apart."""
    ring = Ring()
    for _ in range(FIRST):
        ring.step([100, 100], [300, 300], 90, (50, 50))
    ring.step([10, 20], [40, 50], 7, (1, 2))
    ring.step([30, 30], [60, 60], 9, (3, 4))
    ring.step([20, 20], [70, 80], None, (5, 6))
    for _ in range(2):
        ring.step([500, 500], [900, 900], 800, (400, 400))
    return ring


def scoring_ring():
    ring = Ring(first_id=10**6)
    ring.run([(99.0, 99.0)])  # the warm-up call
    ring.run([(5.0, 100.0), (7.0, 120.0), (6.0, 110.0), (8.0, 150.0)])
    ring.run([(77.0, 77.0)] * 2)  # the traced batches' call
    return ring


def test_the_training_window_is_sliced_from_the_ring(monkeypatch):
    install(monkeypatch, training_ring().spans)
    steps = program_spans.train_window(train_readings(3))
    assert len(steps) == 3
    firsts = [sorted(s.t0_ns for s in step)[0] for step in steps]
    assert firsts == sorted(firsts)
    fwd = [sum(program_spans.ms(s) for s in step
               if s.name == "step/forward") for step in steps]
    assert fwd == pytest.approx([30, 60, 40])
    # clip and adamw are a step's too, below its update
    assert [sorted({s.name for s in step}) for step in steps][0] == sorted(
        {"step/h2d", "step/forward", "step/backward", "step/gate",
         "step/update", "step/clip", "step/adamw"})


def test_the_scoring_window_is_the_second_call(monkeypatch):
    install(monkeypatch, scoring_ring().spans)
    batches = program_spans.score_window(score_readings())
    assert [sum(program_spans.ms(s) for s in b if s.name == "score/forward")
            for b in batches] == pytest.approx([5, 7, 6, 8])


@pytest.mark.parametrize("what", ["dropped", "too_few_steps",
                                  "one_call", "no_ring", "no_window"])
def test_no_window_no_number(monkeypatch, what):
    """Where the ring lost part of the window, or the program keeps no
    ring, every reader finds nothing."""
    ring = training_ring().spans + scoring_ring().spans
    window = 3
    if what == "dropped":
        install(monkeypatch, ring[5:], dropped=5)
    elif what == "too_few_steps":
        install(monkeypatch, ring)
        window = 99
    elif what == "one_call":
        one = Ring()  # the scorer's warm-up call alone, no step
        one.run([(5.0, 100.0)])
        install(monkeypatch, one.spans)
    elif what == "no_ring":  # a program whose spans keep no ring
        monkeypatch.setattr(spans, "_GLOBAL",
                            types.SimpleNamespace(recent_spans=list))
    else:
        install(monkeypatch, ring)
        window = 0
    assert program_spans.train_window(train_readings(window)) is None
    if what != "too_few_steps" and what != "no_window":
        assert program_spans.score_window(score_readings()) is None


def test_a_ring_too_small_for_the_run_gives_nothing(monkeypatch):
    """The program's own ring, pushed past its capacity by the run."""
    tel = spans.Telemetry(ring_spans=16)
    monkeypatch.setattr(spans, "_GLOBAL", tel)
    for _ in range(FIRST + 3):
        with spans.span("step/run"):
            for _ in range(3):
                with spans.span("step/forward"):
                    pass
    assert tel.dropped > 0
    assert program_spans.train_window(train_readings(3)) is None


@pytest.mark.parametrize("metric, want", [
    # medians over the window's 3 steps (the update over the 2 that ran)
    ("forward_ms.train", 40.0),
    ("backward_ms.train", 120.0),
    ("update_ms.train", 8.0),
    ("host_wait_ms.train", 7.0),
    # over the second call's 4 batches
    ("forward_ms.score", 6.5),
    ("fetch_wait_ms.score", 115.0),
])
def test_each_reader_reads_its_median(monkeypatch, metric, want):
    install(monkeypatch, training_ring().spans + scoring_ring().spans)
    readings = (train_readings(3) if metric.endswith(".train")
                else score_readings())
    got = tiny.bench().reader(metric)(readings)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("kind, names", [
    ("train_closed", {"forward_ms.train", "backward_ms.train",
                      "update_ms.train", "host_wait_ms.train"}),
    ("score_library", {"forward_ms.score", "fetch_wait_ms.score"}),
])
def test_a_traced_run_reads_the_programs_spans(monkeypatch, kind, names):
    """The runner on the CPU with trace on, in a process whose ring
    holds this run alone (as ``run.py``'s does)."""
    monkeypatch.setattr(spans, "_GLOBAL", spans.Telemetry())
    ctx, outcome, rows, ok = tiny.execute(kind, tiny.SEEDS[1], trace=True)
    assert ok, rows
    got = harness.per_layer_values(ctx.cell, outcome.readings, tiny.bench())
    assert set(got) >= names
    assert all(got[n]["value"] > 0 and got[n]["unit"] == "ms"
               for n in names)
    if kind == "train_closed":
        # the update timed from inside is the harness's wrapped update
        # less the wrapper
        assert got["update_ms.train"]["value"] <= 1.5 * got[
            "optimizer_ms.train"]["value"]

"""``replay_pct.train``: the share of the window's steps that hold a
``step/replay`` span, read from a hand-built ring of the program's
spans (``test_portbench_program_spans.Ring``)."""

import pytest

from portbench.tests import tiny
from portbench.tests.test_portbench_program_spans import (
    FIRST,
    Ring,
    install,
    train_readings,
)


def replayed_step(ring):
    """One ``step/run`` as a replayed step opens it: the batch's copy,
    graph A's replay, the gate, graph B's update."""
    root, t0 = next(ring.ids), ring.now
    ring.add("step/h2d", 0.1, root, wait=True)
    ring.add("step/replay", 2.0, root)
    ring.add("step/gate", 380.0, root, wait=True)
    ring.add("step/update", 0.3, root)
    ring.close("step/run", root, None, t0)


def eager_step(ring):
    ring.step([100, 100], [300, 300], 40, (1, 1))


def ring_of(setup, window, traced=2):
    ring = Ring()
    for kind in setup + window + ["replay"] * traced:
        (replayed_step if kind == "replay" else eager_step)(ring)
    return ring


@pytest.mark.parametrize("window, want", [
    (["replay"] * 4, 100.0),
    (["eager"] * 4, 0.0),
    (["eager", "replay", "replay", "replay"], 75.0),
])
def test_the_share_of_replayed_window_steps(monkeypatch, window, want):
    """Set-up: eager, then the capture's replay, then a replay."""
    setup = ["eager", "replay", "replay"]
    assert len(setup) == FIRST
    install(monkeypatch, ring_of(setup, window).spans)
    got = tiny.bench().reader("replay_pct.train")(train_readings(4))
    assert got == pytest.approx(want)


def test_nothing_where_the_program_replays_no_step(monkeypatch):
    """A program without the graphs (or on the CPU) opens no
    ``step/replay``: the metric is left out, not read as 0."""
    install(monkeypatch, ring_of(["eager"] * FIRST, ["eager"] * 4,
                                 traced=0).spans)
    assert tiny.bench().reader("replay_pct.train")(train_readings(4)) is None

"""The share of the window's training steps that the program replayed
from its captured CUDA graphs, in %: the steps whose ``step/run`` holds
a ``step/replay`` span (``program_spans.py``). Nothing where no span of
the ring is a ``step/replay``: a program that captures no step."""

from portbench import program_spans

REPLAY = "step/replay"


def read(r):
    ring = program_spans.closed()
    steps = program_spans.train_window(r)
    if not steps or not any(s.name == REPLAY for s in ring):
        return None
    replayed = sum(any(s.name == REPLAY for s in step) for step in steps)
    return 100.0 * replayed / len(steps)

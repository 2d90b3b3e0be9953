"""The forward of a training step, in ms: the program's ``step/forward``
spans of a step summed over its micro-batches, the median over the
window's steps (``program_spans.py``). Host time issuing the forward,
with remat's saved-for-backward bookkeeping; no synchronise."""

from portbench import program_spans


def read(r):
    return program_spans.median_ms(program_spans.train_window(r),
                                   "step/forward")

"""The backward of a training step, in ms: the program's
``step/backward`` spans of a step summed over its micro-batches (remat's
recompute inside), the median over the window's steps
(``program_spans.py``)."""

from portbench import program_spans


def read(r):
    return program_spans.median_ms(program_spans.train_window(r),
                                   "step/backward")

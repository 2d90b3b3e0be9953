"""The scorer's forward of a batch, in ms: the program's
``score/forward`` span (the forward issued, no synchronise), the median
over the window's batches (``program_spans.py``)."""

from portbench import program_spans


def read(r):
    return program_spans.median_ms(program_spans.score_window(r),
                                   "score/forward")

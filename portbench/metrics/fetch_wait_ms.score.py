"""The scorer's wait on the card a batch, in ms: the summed wait spans
of a batch (``score/fetch``, the results' copy to the host, which
waits for the forward), the median over the window's batches
(``program_spans.py``)."""

from portbench import program_spans


def read(r):
    return program_spans.median_ms(program_spans.score_window(r),
                                   wait=True)

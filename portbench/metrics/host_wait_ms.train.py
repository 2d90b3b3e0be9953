"""The host's waits on the card in a training step, in ms: the summed
wait spans of a step (the batch's copy ``step/h2d`` and the finite
gate's read ``step/gate``), the median over the window's steps
(``program_spans.py``). Long waits say the card paces the step."""

from portbench import program_spans


def read(r):
    return program_spans.median_ms(program_spans.train_window(r),
                                   wait=True)

"""The optimizer's update of a training step, in ms: the program's
``step/update`` span (the clip and AdamW, issued with no synchronise),
the median over the window's steps that updated (``program_spans.py``).
The inside counterpart of ``optimizer_ms.train``."""

from portbench import program_spans


def read(r):
    return program_spans.median_ms(program_spans.train_window(r),
                                   "step/update")

"""The longest training step of the traced run's window, in ms: the
harness's host span around each ``train_step`` call, ended by its loss
read (the profiled steps left out)."""


def read(r):
    spans = r.spans.get("train_step")
    return 1e3 * max(spans) if spans else None

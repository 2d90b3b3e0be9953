"""The mean host time of ``MaskedAdamW.update`` a step, in ms: the
harness's span around the call, with no synchronise of its own, so it
is the time the host spends issuing the update (the profiled steps left
out)."""


def read(r):
    spans = r.spans.get("optimizer.update")
    return 1e3 * sum(spans) / len(spans) if spans else None

"""The scorer's host time a batch, in ms: ``run_batch_score``'s own
``data`` (collate) and ``write`` (JSON lines, flush, fsync) times over
its batches."""


def read(r):
    value = r.values.get("host_s_per_batch")
    return None if value is None else 1e3 * value

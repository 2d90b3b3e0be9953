"""The hand-written kernels' share of their roofline in the traced
window, in %: the least time of their work (the cell's family's
``work_ms`` over the traced passes) over their device time in the
profiler's trace."""

from portbench import counts


def read(r):
    passes = r.values.get("traced_passes")
    if r.trace is None or passes is None:
        return None
    return counts.kernels_roofline(
        counts.traced_work(r.cell.family, r.cell.spec, passes),
        r.trace.kernel_s)

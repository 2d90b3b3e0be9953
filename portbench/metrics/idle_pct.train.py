"""The share of a step of the window in which no kernel, copy or fill
ran on the device, in %: the device's busy time over the traced steps
(the profiler's session that records the device's operations alone,
``trace.py``) against the window's own time for as many steps. The
traced span itself runs slower than the window's steps, since the
profiler costs the host time on every launch, so its own idle share
(``busy_s`` over ``window_s``) reads higher."""


def read(r):
    steps_s = r.values.get("traced_steps_window_s")
    if r.trace is None or not steps_s:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / steps_s)

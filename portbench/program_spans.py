"""The program's own spans over the measured window, for the per-layer
readers whose ``source`` is ``program_span``.

The program keeps its closed spans in a ring
(``get_telemetry().closed_spans()``, ``telemetry/spans.py``), each with
its parent, its stamps in ``time.time_ns()`` and whether it is a wait
(the host waiting for the card). Read after the run, the spans are
grouped under their root: a training step's ``step/run``, a scored
batch's ``score/flush``. The window is found by counting, for a
process that ran one cell (as ``run.py`` does):

* training: the ``step/run`` roots in order, the mix's ``first_steps``
  of set-up skipped, then as many as the harness's own ``train_step``
  spans (the window's steps); the traced steps come after;
* scoring: the ``score/flush`` batches of the second ``score/run`` (the
  warm-up's call comes first, the traced batches' call after).

Where the program keeps no ring, or the ring has dropped spans (so the
counting may start in the wrong place), there is no window: the
readers find nothing to read and their metric is left out.
"""

from __future__ import annotations

import statistics

STEP, BATCH, RUN = "step/run", "score/flush", "score/run"


def closed() -> list | None:
    """The program's ring of closed spans, oldest first, or None where
    the program keeps none or the ring has dropped spans."""
    from progen_tpu_torch.telemetry.spans import get_telemetry

    tel = get_telemetry()
    if not hasattr(tel, "closed_spans") or getattr(tel, "dropped", 1):
        return None
    return tel.closed_spans()


def _under(spans: list, root: str) -> dict:
    """root span id -> the spans below it, each root named ``root``."""
    by_id = {s.id: s for s in spans}
    out = {s.id: [] for s in spans if s.name == root}
    for s in spans:
        up = s.parent
        while up is not None and up not in out:
            up = by_id[up].parent if up in by_id else None
        if up is not None:
            out[up].append(s)
    return out


def _roots(spans: list, name: str, parent=None) -> list:
    return sorted((s for s in spans if s.name == name
                   and (parent is None or s.parent == parent)),
                  key=lambda s: s.t0_ns)


def train_window(r) -> list | None:
    """The window's steps, each a list of the spans below its
    ``step/run``, or None."""
    spans = closed()
    steps = len(r.spans.get("train_step") or ())
    if spans is None or not steps:
        return None
    first = int(r.cell.params["first_steps"])
    roots = _roots(spans, STEP)
    if len(roots) < first + steps:
        return None
    below = _under(spans, STEP)
    return [below[s.id] for s in roots[first:first + steps]]


def score_window(r) -> list | None:
    """The window's batches, each a list of the spans below its
    ``score/flush``, or None."""
    spans = closed()
    if spans is None:
        return None
    runs = _roots(spans, RUN)
    if len(runs) < 2:
        return None
    batches = _roots(spans, BATCH, parent=runs[1].id)
    if not batches:
        return None
    below = _under(spans, BATCH)
    return [below[s.id] for s in batches]


def ms(s) -> float:
    return (s.t1_ns - s.t0_ns) / 1e6


def median_ms(groups: list | None, name: str | None = None,
              wait: bool = False) -> float | None:
    """The median over ``groups`` of each group's summed durations (ms)
    of the spans named ``name``, or of its waits; groups with none such
    are left out."""
    if not groups:
        return None
    sums = []
    for spans in groups:
        picked = [ms(s) for s in spans
                  if (s.wait if wait else s.name == name)]
        if picked:
            sums.append(sum(picked))
    return statistics.median(sums) if sums else None

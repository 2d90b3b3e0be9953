"""The port's ``telemetry/stitch.py`` against the JAX package's: the same
seeded per-host streams with known clock skews give the same beacon
offsets, the same merged fleet trace (flow arrows, corrected metrics
rows, the fleet goodput skew) and the same per-request journeys across
router, dead replica and survivor; the train loop's beacon record has
the JAX shape."""

import json

import pytest

from progen_tpu.telemetry import stitch as jax_stitch
from progen_tpu_torch.telemetry import spans as pt_spans
from progen_tpu_torch.telemetry import stitch as pt_stitch
from progen_tpu_torch.training import emit_clock_beacon
from torch_telemetry_cases import (
    fleet_streams,
    metrics_rows,
    span_stream,
    write_jsonl,
)

SKEWS = [(0.0, 0.25), (0.0, -1.5), (0.0, 0.004, 3.0), (0.0,)]


@pytest.mark.parametrize("skews", SKEWS, ids=str)
def test_offsets_match(skews):
    streams = [span_stream(10, host=h, skew=s)
               for h, s in enumerate(skews)]
    records = [r for s in streams for r in s]
    got = pt_stitch.clock_offsets(pt_stitch.collect_beacons(records))
    want = jax_stitch.clock_offsets(jax_stitch.collect_beacons(records))
    assert got == want
    assert got[len(skews) - 1] == pytest.approx(skews[-1], abs=1e-3)


@pytest.mark.parametrize("reference", [0, 1, 7])
def test_offsets_reference_matches(reference):
    records = span_stream(1) + span_stream(2, host=1, skew=0.5)
    beacons = pt_stitch.collect_beacons(records)
    assert pt_stitch.clock_offsets(beacons, reference) == \
        jax_stitch.clock_offsets(beacons, reference)


@pytest.mark.parametrize("force_hosts", [False, True])
@pytest.mark.parametrize("skews", SKEWS[:3], ids=str)
def test_stitch_streams_match(skews, force_hosts):
    streams = [span_stream(20, host=h, skew=s)
               for h, s in enumerate(skews)]
    metrics = [(h, metrics_rows(h, n=4, prefix="", t0=1000.0 + s))
               for h, s in enumerate(skews)]
    got = pt_stitch.stitch_streams(streams, metrics,
                                   force_hosts=force_hosts)
    want = jax_stitch.stitch_streams(streams, metrics,
                                     force_hosts=force_hosts)
    assert got == want
    assert got["progenStitch"]["hosts"] == len(skews)


@pytest.mark.parametrize("force_hosts", [False, True])
def test_request_journeys_match(force_hosts):
    streams = fleet_streams()
    got = pt_stitch.stitch_streams(streams, force_hosts=force_hosts)
    want = jax_stitch.stitch_streams(streams, force_hosts=force_hosts)
    assert got == want
    if force_hosts:
        (journey,) = got["progenTraces"].values()
        assert journey["hops"] == 2 and journey["handoffs"] == 1


def test_stitch_trace_files_match(tmp_path):
    paths = [write_jsonl(tmp_path / f"h{h}" / "events.jsonl",
                         span_stream(30 + h, host=h, skew=0.1 * h),
                         torn=h == 1)
             for h in range(3)]
    mpaths = [write_jsonl(tmp_path / f"h{h}" / "metrics.jsonl",
                          metrics_rows(h, n=3, prefix=""))
              for h in range(3)]
    got = pt_stitch.stitch_trace(paths, tmp_path / "pt.json", mpaths)
    want = jax_stitch.stitch_trace(paths, tmp_path / "jax.json", mpaths)
    assert got == want
    assert got["progenDroppedLines"] == 2
    assert json.loads((tmp_path / "pt.json").read_text()) == \
        json.loads((tmp_path / "jax.json").read_text())


def test_clock_beacon_record_has_the_jax_shape():
    seen = []
    rec = pt_stitch.emit_clock_beacon(5, emit=seen.append)
    ref = jax_stitch.emit_clock_beacon(5, emit=lambda r: None)
    assert seen == [rec]
    assert set(rec) == set(ref) and rec["step"] == ref["step"] == 5
    # the default sink is the process telemetry, whose taps see it
    taps = []
    pt_spans.EMIT_TAPS.append(taps.append)
    try:
        emit_clock_beacon(6)
    finally:
        pt_spans.EMIT_TAPS.remove(taps.append)
    assert [r["step"] for r in taps] == [6]
    assert taps[0]["ev"] == "clock_beacon" and "pid" in taps[0]


def test_emit_taps_swallow_a_raising_tap():
    seen = []

    def bad(rec):
        raise RuntimeError("tap")

    pt_spans.EMIT_TAPS[:0] = [bad, seen.append]
    try:
        pt_spans.Telemetry().emit({"ev": "x"})
    finally:
        pt_spans.EMIT_TAPS.remove(bad)
        pt_spans.EMIT_TAPS.remove(seen.append)
    assert seen == [{"ev": "x", "pid": 0}]

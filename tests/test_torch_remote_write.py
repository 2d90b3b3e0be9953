"""The port's ``telemetry/remote_write.py`` against the JAX package's: the
same fleet points encode to the same remote-write timeseries and batch
payloads (which round-trip through ``parse_prom_text``), and two
bridges, one of each package, pushing the same points to loopback
receivers (one answering 503 first) send the same bodies and keep the
same spool, drop and failure counts."""

import json

import pytest

from progen_tpu.resilience.retry import RetryPolicy as JaxPolicy
from progen_tpu.telemetry import collector as jax_collector
from progen_tpu.telemetry import remote_write as jax_rw
from progen_tpu.telemetry.slo import parse_prom_text
from progen_tpu_torch.resilience.retry import RetryPolicy as PtPolicy
from progen_tpu_torch.telemetry import collector as pt_collector
from progen_tpu_torch.telemetry import remote_write as pt_rw
from torch_telemetry_cases import Receiver, fleet_samples

FAST = dict(max_attempts=3, base_delay_s=0.01, max_delay_s=0.05,
            jitter=0.0)


def _points(seed, ticks=10):
    samples = fleet_samples(pt_collector.make_sample, seed, ticks=ticks)
    series = pt_collector.fleet_series(samples)
    assert series == jax_collector.fleet_series(samples)
    return samples, series


@pytest.fixture()
def receivers():
    rs = Receiver(), Receiver()
    yield rs
    for r in rs:
        r.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encoding_matches_and_round_trips(seed):
    samples, series = _points(seed)
    kinds = pt_rw.fleet_kinds(samples)
    assert kinds == jax_rw.fleet_kinds(samples)
    points = []
    for ts, vals in series:
        got = pt_rw.encode_point(ts, vals, *kinds)
        assert got == jax_rw.encode_point(ts, vals, *kinds)
        points.append(got)
    merged = pt_rw.merge_timeseries(points)
    assert merged == jax_rw.merge_timeseries(points)
    payload = {"timeseries": pt_rw.encode_point(*series[-1], *kinds)}
    text = pt_rw.payload_to_prom_text(payload)
    assert text == jax_rw.payload_to_prom_text(payload)
    back = parse_prom_text(text)
    for key, v in series[-1][1].items():
        if not key.endswith("_mean_s"):
            assert back[key] == pytest.approx(v), key


@pytest.mark.parametrize("fail_first,spool", [(0, 240), (2, 240), (0, 3)])
def test_bridges_push_alike(receivers, fail_first, spool):
    samples, series = _points(4, ticks=12)
    kinds = pt_rw.fleet_kinds(samples)
    bridges = [
        pt_rw.RemoteWriteBridge(receivers[0].url(), spool_points=spool,
                                batch_points=4, policy=PtPolicy(**FAST)),
        jax_rw.RemoteWriteBridge(receivers[1].url(), spool_points=spool,
                                 batch_points=4, policy=JaxPolicy(**FAST)),
    ]
    for r in receivers:
        r.fail_next = fail_first
    results = [[], []]
    for i, (ts, vals) in enumerate(series):
        for b, out in zip(bridges, results):
            b.offer(ts, vals, *kinds)
            if i % 3 == 2:
                out.append(b.flush(now=float(i)))
    for b, out in zip(bridges, results):
        for k in range(8):
            out.append(b.flush(now=100.0 + k))
    assert results[0] == results[1]
    assert bridges[0].stats() == bridges[1].stats()
    assert receivers[0].bodies == receivers[1].bodies
    assert receivers[0].bodies, "nothing pushed"
    body = json.loads(receivers[0].bodies[-1])
    assert body["timeseries"]


def test_unreachable_endpoint_never_raises_alike():
    kwargs = dict(spool_points=2, batch_points=2, timeout_s=0.5)
    pt = pt_rw.RemoteWriteBridge("http://127.0.0.1:9/write",
                                 policy=PtPolicy(**FAST), **kwargs)
    jx = jax_rw.RemoteWriteBridge("http://127.0.0.1:9/write",
                                  policy=JaxPolicy(**FAST), **kwargs)
    samples, series = _points(5, ticks=4)
    kinds = pt_rw.fleet_kinds(samples)
    for ts, vals in series:
        for b in (pt, jx):
            b.offer(ts, vals, *kinds)
    assert pt.flush(0.0) == jx.flush(0.0) == "failed"
    assert pt.flush(0.0) == jx.flush(0.0) == "backoff"
    assert pt.stats() == jx.stats()
    assert pt.stats()["dropped_points"] == 2

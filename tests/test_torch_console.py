"""The port's ``telemetry/console.py`` against the JAX package's: over the
same store (a seeded fleet's samples, an alerts JSONL and a notification
ledger), ``build_snapshot`` gives the same dict and ``render`` the same
frame (colour on and off, the on-call view), up to the tool's name in
the header; the headless ``watch`` loop writes the same frames."""

import io
import json

import pytest

from progen_tpu.telemetry import collector as jax_coll
from progen_tpu.telemetry import console as jax_console
from progen_tpu.telemetry import slo as jax_slo
from progen_tpu.telemetry import tsdb as jax_tsdb
from progen_tpu_torch.telemetry import alert_router as pt_ar
from progen_tpu_torch.telemetry import alerts as pt_alerts
from progen_tpu_torch.telemetry import collector as pt_coll
from progen_tpu_torch.telemetry import console as pt_console
from progen_tpu_torch.telemetry import slo as pt_slo
from progen_tpu_torch.telemetry import tsdb as pt_tsdb
from torch_telemetry_cases import FLEET_SLO_TOML, fleet_samples


def same_frame(pt: str, jax: str) -> bool:
    """The port's console names its own tool in the header."""
    return pt.replace("progen-tpu-torch-top", "progen-tpu-top") == jax


@pytest.fixture(params=[0, 3])
def store(request, tmp_path):
    seed = request.param
    db = pt_tsdb.RingTSDB(tmp_path / "tsdb", block_bytes=3000)
    for rec in fleet_samples(pt_coll.make_sample, seed, ticks=14):
        db.append(rec)
    db.close()
    # alerts and their notifications through the sink and the router,
    # which own those records
    (tmp_path / "router.toml").write_text(
        '[route_ledger]\nsink = "file"\n'
        '[route_quiet]\nsink = "file"\nsilence_s = 900.0\n')
    severity, routes = pt_ar.load_router_config(tmp_path / "router.toml")
    router = pt_ar.AlertRouter(tmp_path / "tsdb" / "notifications.jsonl",
                               routes, severity=severity)
    sink = pt_alerts.AlertSink(tmp_path / "tsdb" / "alerts.jsonl",
                               relay=router.handle)
    sink.staleness("r1", up=False, age_s=12.0, now=1004.0)
    sink.staleness("r1", up=True, age_s=0.5, now=1005.0)
    sink.staleness("r1", up=False, age_s=9.0, now=1005.5)  # silenced
    sink.slo_transition({"objective": "ttft_p95", "state": "burning",
                         "ts": 1006.0, "burn_short": 3.0, "burn_long": 2.2,
                         "value": 0.6})
    router.handle(dict(sink.recent[-1]))  # a repeat: deduped
    sink.close()
    router.close()
    (tmp_path / "slo.toml").write_text(FLEET_SLO_TOML)
    return tmp_path


def _snapshots(store, with_slo: bool):
    kw = dict(alerts_path=store / "tsdb" / "alerts.jsonl",
              notifications_path=store / "tsdb" / "notifications.jsonl")
    pt = pt_console.build_snapshot(
        pt_tsdb.TsdbReader(store / "tsdb"),
        slo_cfg=pt_slo.load_objectives(store / "slo.toml")
        if with_slo else None, **kw)
    jax = jax_console.build_snapshot(
        jax_tsdb.TsdbReader(store / "tsdb"),
        slo_cfg=jax_slo.load_objectives(store / "slo.toml")
        if with_slo else None, **kw)
    return pt, jax


@pytest.mark.parametrize("with_slo", [False, True])
def test_snapshots_match(store, with_slo):
    pt, jax = _snapshots(store, with_slo)
    assert pt == jax
    assert pt_console.snapshot_json(pt) == jax_console.snapshot_json(jax)
    assert json.loads(pt_console.snapshot_json(pt))["sources"]


@pytest.mark.parametrize("color", [False, True])
@pytest.mark.parametrize("alerts_only", [False, True])
def test_frames_match(store, color, alerts_only):
    pt, jax = _snapshots(store, True)
    assert same_frame(
        pt_console.render(pt, color=color, alerts_only=alerts_only),
        jax_console.render(jax, color=color, alerts_only=alerts_only))


def test_headless_watch_matches(store):
    outs = []
    for console, tsdb in ((pt_console, pt_tsdb), (jax_console, jax_tsdb)):
        out = io.StringIO()
        console.watch(tsdb.TsdbReader(store / "tsdb"), refresh_s=0.0,
                      color=False, max_frames=2, out=out)
        outs.append(out.getvalue())
    assert same_frame(*outs)
    assert outs[1].count(jax_console.CLEAR_SCREEN) == 2


def test_empty_store_renders_alike(tmp_path):
    (tmp_path / "tsdb").mkdir()
    pt = pt_console.build_snapshot(pt_tsdb.TsdbReader(tmp_path / "tsdb"))
    jax = jax_console.build_snapshot(jax_tsdb.TsdbReader(tmp_path / "tsdb"))
    assert pt == jax
    assert same_frame(pt_console.render(pt, color=False),
                      jax_console.render(jax, color=False))


def test_latest_by_source_matches(store):
    recs = list(pt_tsdb.TsdbReader(store / "tsdb").read())
    assert pt_coll.latest_by_source(recs) == jax_coll.latest_by_source(recs)

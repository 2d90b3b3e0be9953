"""The port's ``telemetry/collector.py`` against the JAX package's: one
collector of each package scrapes the same seeded fleet (a router and two
replicas as exposition files, a third replica's metrics.jsonl tail, a
replica that goes stale and comes back with reset counters) on the same clock, with
fleet SLOs, an alert sink and a profile pin. Their TSDBs, alerts, SLO
transitions, fleet series and the pin written on the first ``burning``
edge must be equal; the pure helpers (source specs, the prom split,
quantile merging, fleet exemplars) must agree."""

import pytest

from progen_tpu.serving.metrics import ServingMetrics as JaxMetrics
from progen_tpu.telemetry import alerts as jax_alerts
from progen_tpu.telemetry import collector as jax_coll
from progen_tpu.telemetry import slo as jax_slo
from progen_tpu.telemetry import tsdb as jax_tsdb
from progen_tpu.telemetry.prometheus import prometheus_text as jax_text
from progen_tpu_torch.serving.metrics import ServingMetrics as PtMetrics
from progen_tpu_torch.telemetry import alerts as pt_alerts
from progen_tpu_torch.telemetry import collector as pt_coll
from progen_tpu_torch.telemetry import slo as pt_slo
from progen_tpu_torch.telemetry import tsdb as pt_tsdb
from progen_tpu_torch.telemetry.prometheus import prometheus_text as pt_text
from torch_telemetry_cases import (
    FLEET_SLO_TOML,
    fleet_samples,
    metrics_rows,
    serving_prom,
    write_jsonl,
    write_prom,
)

T0 = 1_700_000_000.0
SIDE = {"port": (pt_coll, pt_tsdb, pt_alerts, pt_slo),
        "jax": (jax_coll, jax_tsdb, jax_alerts, jax_slo)}


def _fleet_files(root, tick: int):
    """The fleet's expositions at ``tick``: r1 stops writing for ticks
    3-5 (stale at the scrape) and comes back with reset counters."""
    if not (3 <= tick <= 5):
        done = 2 + tick if tick < 3 else tick - 5
        write_prom(root / "r1.prom", serving_prom(
            PtMetrics, pt_text, tick, completed=done, queue=tick % 3,
            ttfts=[0.1 * tick + 0.05] * 3, trace_ids=[f"t:{tick}"]),
            T0 + tick)
    write_prom(root / "r0.prom", serving_prom(
        PtMetrics, pt_text, 100 + tick, completed=3 * tick, queue=1,
        ttfts=[0.2 + 0.05 * tick] * 4, trace_ids=[f"u:{tick}"]),
        T0 + tick)
    m = PtMetrics()
    m.inc("requests_submitted", 4 * tick)
    m.set_gauge("replicas_live", 2.0 if not 3 <= tick <= 5 else 1.0)
    m.set_gauge("replicas_total", 2.0)
    m.set_gauge("queue_depth", float(tick % 4))
    write_prom(root / "router.prom", pt_text(m, prefix="progen_router_"),
               T0 + tick)


def test_collectors_scrape_alike(tmp_path):
    fleet = tmp_path / "fleet"
    rows = metrics_rows(3, n=10, t0=T0, dt=1.0)
    pt_ticks, jax_ticks = _lockstep(tmp_path, fleet, rows)
    assert pt_ticks == jax_ticks
    for name in ("alerts.jsonl", "alerts.state.json"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()
    a = list(pt_tsdb.TsdbReader(tmp_path / "port" / "tsdb").read())
    b = list(jax_tsdb.TsdbReader(tmp_path / "jax" / "tsdb").read())
    assert a == b
    assert pt_coll.fleet_series(a) == jax_coll.fleet_series(b)
    assert pt_coll.latest_by_source(a) == jax_coll.latest_by_source(b)
    assert pt_coll.fleet_exemplars(a) == jax_coll.fleet_exemplars(b)
    alerts = (tmp_path / "port" / "alerts.jsonl").read_text()
    assert '"kind": "staleness"' in alerts
    assert '"state": "burning"' in alerts
    pins = [(tmp_path / s / "r0" / "profile.pin").read_text()
            for s in SIDE]
    assert pins[0] == pins[1] and pins[0].startswith("slo-")


def _lockstep(tmp_path, fleet, rows, ticks=10):
    """One collector of each package, scraping the same files tick by
    tick; each package's samples, in tick order."""
    fleet.mkdir()
    state = {}
    for side in SIDE:
        coll_mod, tsdb_mod, alerts_mod, slo_mod = SIDE[side]
        root = tmp_path / side
        root.mkdir(exist_ok=True)
        (root / "slo.toml").write_text(FLEET_SLO_TOML)
        specs = [coll_mod.parse_source_spec(s) for s in (
            f"name=router,role=router,prom={fleet / 'router.prom'}",
            f"name=r0,prom={fleet / 'r0.prom'}",
            f"name=r1,prom={fleet / 'r1.prom'}",
            f"name=r2,metrics={fleet / 'm.jsonl'}")]
        db = tsdb_mod.RingTSDB(root / "tsdb", block_bytes=4000)
        sink = alerts_mod.AlertSink(root / "alerts.jsonl")
        coll = coll_mod.Collector(
            db, specs, stale_after_s=2.5,
            slo_cfg=slo_mod.load_objectives(root / "slo.toml"),
            alerts=sink, profile_pins=[root / "r0" / "profile.pin"])
        state[side] = (coll, db, sink, [])
    for t in range(ticks):
        _fleet_files(fleet, t)
        write_jsonl(fleet / "m.jsonl", rows[:t + 1])
        for side, (coll, _, _, out) in state.items():
            out.append(coll.scrape_once(now=T0 + t + 0.5))
    for coll, db, sink, _ in state.values():
        db.close()
        sink.close()
    return state["port"][3], state["jax"][3]


@pytest.mark.parametrize("spec", [
    "name=r0,role=router,prom=/p.prom,metrics=/m.jsonl",
    "name=r1,prom=/p", "prom=/p", "name=r0", "name=r0,port=1",
    "name=r0,prom", "name=r0,role=sidecar,prom=/p"])
def test_source_specs_parse_alike(spec):
    try:
        want = jax_coll.parse_source_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pt_coll.parse_source_spec(spec)
        assert str(got.value) == str(e)
        return
    got = pt_coll.parse_source_spec(spec)
    assert (got.name, got.role, got.prom, got.metrics) == \
        (want.name, want.role, want.prom, want.metrics)


@pytest.mark.parametrize("seed", [0, 1])
def test_prom_split_matches(seed):
    text = serving_prom(JaxMetrics, jax_text, seed, completed=5, queue=2)
    vals = pt_slo.parse_prom_text(text)
    assert pt_coll.prom_families(text) == jax_coll.prom_families(text)
    assert pt_coll.split_prom_values(vals, pt_coll.prom_families(text)) \
        == jax_coll.split_prom_values(vals, jax_coll.prom_families(text))


@pytest.mark.parametrize("parts", [
    [(10, {"p50_s": 0.1, "p95_s": 0.3, "p99_s": 0.5})],
    [(10, {"p50_s": 0.1, "p95_s": 0.3, "p99_s": 0.5}),
     (30, {"p50_s": 1.0, "p95_s": 2.0, "p99_s": 4.0})],
    [(0, {"p50_s": 1.0}), (5, {"p50_s": 0.2, "p99_s": 0.9})],
    []])
def test_merge_quantiles_matches(parts):
    assert pt_coll.merge_quantiles(parts) == jax_coll.merge_quantiles(parts)


@pytest.mark.parametrize("seed", [0, 7])
def test_fleet_series_over_samples_matches(seed):
    samples = fleet_samples(pt_coll.make_sample, seed, ticks=16)
    assert pt_coll.fleet_series(samples) == jax_coll.fleet_series(samples)


def test_collector_config_loads_alike(tmp_path):
    from torch_telemetry_cases import REPO_SLO

    cfg = REPO_SLO.parent / "collector.toml"
    pt_settings, pt_sources = pt_coll.load_collector_config(cfg)
    jax_settings, jax_sources = jax_coll.load_collector_config(cfg)
    assert pt_settings == jax_settings
    assert [vars(s) for s in pt_sources] == [vars(s) for s in jax_sources]

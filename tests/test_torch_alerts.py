"""The port's ``telemetry/alerts.py`` against the JAX package's: the same
staleness, SLO and deploy-rollback transitions written through an
``AlertSink`` of each package give the same alerts JSONL, the same
persisted states (and so the same restart dedup), and each sink reads
the other's state file."""

import pytest

from progen_tpu.telemetry import alerts as jax_alerts
from progen_tpu_torch.telemetry import alerts as pt_alerts

PACKAGES = {"port": pt_alerts, "jax": jax_alerts}

EDGES = [
    ("staleness", dict(source="r0", up=False, age_s=12.5, now=10.0)),
    ("staleness", dict(source="r0", up=False, age_s=14.0, now=11.0)),
    ("slo_transition", dict(slo_rec={
        "ev": "slo", "ts": 12.0, "objective": "ttft_p95",
        "state": "burning", "prev": "ok", "burn_short": 4.0,
        "burn_long": 2.5, "value": 0.9},
        exemplars={"ttft_s": [{"value": 0.9, "trace_id": "t:7"}]})),
    ("staleness", dict(source="r0", up=True, age_s=0.2, now=13.0)),
    ("slo_transition", dict(slo_rec={
        "ev": "slo", "ts": 14.0, "objective": "ttft_p95",
        "state": "resolved", "prev": "burning"})),
    ("deploy_rollback", dict(ckpt="ckpt_9", reason="canary", now=15.0)),
    ("deploy_rollback", dict(ckpt="ckpt_9", reason="canary", now=16.0)),
]


def _drive(mod, path, edges, relay=None):
    sink = mod.AlertSink(path, relay=relay)
    out = [getattr(sink, name)(**kw) for name, kw in edges]
    sink.close()
    return sink, out


@pytest.mark.parametrize("cut", [2, 4, len(EDGES)])
def test_sinks_write_alike(tmp_path, cut):
    got_relay, want_relay = [], []
    pt, got = _drive(pt_alerts, tmp_path / "pt" / "alerts.jsonl",
                     EDGES[:cut], got_relay.append)
    jx, want = _drive(jax_alerts, tmp_path / "jax" / "alerts.jsonl",
                      EDGES[:cut], want_relay.append)
    assert got == want and got_relay == want_relay
    assert pt.suppressed == jx.suppressed
    assert (tmp_path / "pt" / "alerts.jsonl").read_text() == \
        (tmp_path / "jax" / "alerts.jsonl").read_text()
    assert pt.state_path.read_text() == jx.state_path.read_text()
    for kind in ("staleness", "slo_burn", "deploy_rollback"):
        assert pt.last_states(kind) == jx.last_states(kind)


@pytest.mark.parametrize("writer,reader", [("port", "jax"),
                                           ("jax", "port")])
def test_restart_dedup_across_packages(tmp_path, writer, reader):
    path = tmp_path / "alerts.jsonl"
    _drive(PACKAGES[writer], path, EDGES[:3])
    sink = PACKAGES[reader].AlertSink(path)
    # the same edges replayed after a restart fire nothing
    assert sink.staleness("r0", up=False, age_s=20.0, now=30.0) is None
    assert sink.last_state("slo_burn", "fleet", "ttft_p95") == "burning"
    assert sink.staleness("r0", up=True, age_s=0.1, now=31.0) is not None
    sink.close()

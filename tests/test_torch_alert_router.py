"""The port's ``telemetry/alert_router.py`` against the JAX package's: the
same router TOML loads to the same routes, and the same alert edges
routed by one router of each package (a file ledger, a webhook to a
loopback receiver, a silenced route, an escalation chain) give the same
notification ledger, counts and webhook bodies, also across a restart
that reloads the ledger."""

import dataclasses
import json
import tempfile
from pathlib import Path

import pytest

from progen_tpu.telemetry import alert_router as jax_ar
from progen_tpu_torch.telemetry import alert_router as pt_ar
from progen_tpu_torch.telemetry.alerts import AlertSink
from torch_telemetry_cases import ROUTER_TOML, Receiver

ESCALATE = """
[route_oncall]
sink = "webhook"
url = "{url}"
min_severity = "warning"
escalate_to = "pager"
escalate_after_s = 30.0

[route_pager]
sink = "file"
min_severity = "info"
"""


def _alert(kind, state, ts, source="r0", objective=""):
    # built by a fresh AlertSink, so each record is a real transition
    with tempfile.TemporaryDirectory() as d:
        sink = AlertSink(Path(d) / "alerts.jsonl")
        if kind == "staleness":
            rec = sink.staleness(source, up=state == "fresh", age_s=0.0,
                                 now=ts)
        else:
            rec = sink.slo_transition(
                {"objective": objective, "state": state, "ts": ts})
        sink.close()
    return rec


ALERTS = [
    _alert("staleness", "stale", 10.0),
    _alert("staleness", "stale", 11.0),  # a repeat: deduped
    _alert("slo_burn", "burning", 12.0, "fleet", "ttft_p95"),
    _alert("staleness", "fresh", 13.0),
    _alert("slo_burn", "warn", 14.0, "fleet", "ttft_p95"),
    _alert("staleness", "stale", 15.0),  # a fresh edge, silenced
    _alert("slo_burn", "resolved", 16.0, "fleet", "ttft_p95"),
]


@pytest.fixture()
def receivers():
    rs = Receiver(), Receiver()
    yield rs
    for r in rs:
        r.close()


def _config(tmp_path, name, url, extra=""):
    path = tmp_path / f"{name}.toml"
    path.write_text(ROUTER_TOML.format(url=url) + extra.format(url=url))
    return path


@pytest.mark.parametrize("escalate", [False, True])
def test_routers_deliver_alike(tmp_path, receivers, escalate):
    ledgers, routers = [], []
    for mod, rec, name in ((pt_ar, receivers[0], "pt"),
                           (jax_ar, receivers[1], "jax")):
        cfg = _config(tmp_path, name, rec.url("/webhook"),
                      ESCALATE if escalate else "")
        severity, routes = mod.load_router_config(cfg)
        ledger = tmp_path / name / "notifications.jsonl"
        routers.append(mod.AlertRouter(ledger, routes, severity=severity))
        ledgers.append(ledger)
    (pt_sev, pt_routes), (jax_sev, jax_routes) = (
        mod.load_router_config(_config(tmp_path, n, "http://x"))
        for mod, n in ((pt_ar, "a"), (jax_ar, "b")))
    assert pt_sev == jax_sev
    assert [dataclasses.asdict(r) for r in pt_routes] == \
        [dataclasses.asdict(r) for r in jax_routes]
    for alert in ALERTS:
        got = routers[0].handle(dict(alert))
        want = routers[1].handle(dict(alert))
        assert got == want
    assert routers[0].tick(now=100.0) == routers[1].tick(now=100.0)
    assert routers[0].counts == routers[1].counts
    for r in routers:
        r.close()
    assert ledgers[0].read_text() == ledgers[1].read_text()
    assert [json.loads(b) for b in receivers[0].bodies] == \
        [json.loads(b) for b in receivers[1].bodies]
    assert receivers[0].bodies
    assert pt_ar.read_notifications(ledgers[0], limit=3) == \
        jax_ar.read_notifications(ledgers[1], limit=3)
    # a restart reloads the ledger: the same edge again is deduped
    for mod, ledger, name, rec in ((pt_ar, ledgers[0], "pt", receivers[0]),
                                   (jax_ar, ledgers[1], "jax",
                                    receivers[1])):
        severity, routes = mod.load_router_config(
            _config(tmp_path, name, rec.url("/webhook")))
        again = mod.AlertRouter(ledger, routes, severity=severity)
        (note,) = again.handle(dict(ALERTS[-1]))
        assert note["status"] == "deduped"
        again.close()


@pytest.mark.parametrize("text", [
    "[alert_router]\nbogus = 1\n[route_a]\nsink = \"file\"\n",
    "[route_a]\nsink = \"pigeon\"\n",
    "[route_a]\nsink = \"webhook\"\n",
    "[alert_router]\n",
    "[route_a]\nsink = \"file\"\nescalate_to = \"a\"\n"
    "escalate_after_s = 1.0\n",
])
def test_bad_configs_rejected_alike(tmp_path, text):
    path = tmp_path / "bad.toml"
    path.write_text(text)
    errors = []
    for mod in (pt_ar, jax_ar):
        with pytest.raises(ValueError) as exc:
            mod.load_router_config(path)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def test_fingerprints_match():
    for alert in ALERTS:
        assert pt_ar.fingerprint(alert) == jax_ar.fingerprint(alert)

"""The port's three CLIs against the JAX package's click CLIs (through
``CliRunner``): ``cli.telemetry``'s ``export-trace``, ``stitch``,
``summarize``, ``query`` and ``slo-report`` print the same stdout, write
the same files and exit with the same codes on the same inputs;
``cli.collector --once`` scrapes the same samples; ``cli.top --once``
renders the same frame and JSON. The port's CLIs take argparse, so a
usage error exits 2 as click's does."""

import json

import pytest
from click.testing import CliRunner

from progen_tpu.cli.collector import main as jax_collector_cli
from progen_tpu.cli.telemetry import main as jax_telemetry_cli
from progen_tpu.cli.top import main as jax_top_cli
from progen_tpu_torch.cli import collector as pt_collector_cli
from progen_tpu_torch.cli import telemetry as pt_telemetry_cli
from progen_tpu_torch.cli import top as pt_top_cli
from progen_tpu_torch.serving.metrics import ServingMetrics
from progen_tpu_torch.telemetry import flight
from progen_tpu_torch.telemetry.collector import make_sample
from progen_tpu_torch.telemetry.prometheus import prometheus_text
from progen_tpu_torch.telemetry.tsdb import RingTSDB, TsdbReader
from torch_telemetry_cases import (
    FLEET_SLO_TOML,
    REPO_SLO,
    fleet_samples,
    fleet_streams,
    metrics_rows,
    serving_prom,
    span_stream,
    write_jsonl,
    write_prom,
)


def both(capsys, pt_main, jax_main, argv):
    """(port rc, port stdout, jax rc, jax stdout) for one argv."""
    try:
        rc = pt_main(argv)
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr().out
    res = CliRunner().invoke(jax_main, argv)
    return rc, out, res.exit_code, res.stdout


@pytest.fixture()
def runs(tmp_path):
    """A router and two replicas' events.jsonl (one torn), a metrics
    stream, a flight dump, a journal and an alerts ledger."""
    router, rep_a, rep_b = fleet_streams("tr-1")
    paths = {
        "router": write_jsonl(tmp_path / "router" / "events.jsonl",
                              router + span_stream(1)),
        "r0": write_jsonl(tmp_path / "r0" / "events.jsonl",
                          rep_a + span_stream(2, skew=0.2), torn=True),
        "r1": write_jsonl(tmp_path / "r1" / "events.jsonl",
                          rep_b + span_stream(3, host=1, skew=-0.1)),
        "metrics": write_jsonl(tmp_path / "router" / "metrics.jsonl",
                               metrics_rows(4, n=20, prefix="router/")),
        "journal": write_jsonl(tmp_path / "r0" / "journal.jsonl", [
            {"ev": "journal", "op": "accept", "ts": 10.06, "req": "7:q1-a",
             "trace_id": "tr-1"},
            {"ev": "journal", "op": "token", "ts": 10.2, "req": "7:q1-a",
             "index": 4}]),
    }
    rec = flight.FlightRecorder(tmp_path / "r0" / "flight", host=0,
                                clock=lambda: 10.5)
    for r in rep_a:
        rec.tap(r)
    paths["dump"] = rec.dump("chaos_kill")
    (tmp_path / "slo.toml").write_text(FLEET_SLO_TOML)
    paths["slo"] = tmp_path / "slo.toml"
    paths["root"] = tmp_path
    return paths


@pytest.mark.parametrize("which", ["router", "r0", "dump"])
def test_export_trace_matches(capsys, runs, which):
    out = runs["root"] / "trace.json"
    argv = ["export-trace", str(runs[which]), "--out", str(out)]
    rc = pt_telemetry_cli.main(argv)
    pt_out, pt_doc = capsys.readouterr().out, json.loads(out.read_text())
    res = CliRunner().invoke(jax_telemetry_cli, argv)
    assert (rc, pt_out) == (res.exit_code, res.stdout)
    assert pt_doc == json.loads(out.read_text())


@pytest.mark.parametrize("force", [False, True])
def test_stitch_matches(capsys, runs, force):
    out = runs["root"] / "stitched.json"
    argv = ["stitch", str(runs["router"]), str(runs["r0"]), str(runs["r1"]),
            str(runs["dump"]), "--out", str(out)] + (
        ["--force-hosts"] if force else [])
    rc = pt_telemetry_cli.main(argv)
    pt_out, pt_doc = capsys.readouterr().out, json.loads(out.read_text())
    res = CliRunner().invoke(jax_telemetry_cli, argv)
    assert (rc, pt_out) == (res.exit_code, res.stdout)
    assert pt_doc == json.loads(out.read_text())
    if force:
        assert len({e["pid"] for e in pt_doc["traceEvents"]}) == 4


@pytest.mark.parametrize("extra", [[], ["--slo", "SLO"],
                                   ["--spans", "3", "--traces", "1"]])
def test_summarize_matches(capsys, runs, extra):
    argv = ["summarize", str(runs["router"])] + [
        str(runs["slo"]) if a == "SLO" else a for a in extra]
    rc, pt_out, jrc, jax_out = both(capsys, pt_telemetry_cli.main,
                                    jax_telemetry_cli, argv)
    assert (rc, pt_out) == (jrc, jax_out)
    assert "== span latency (s) ==" in pt_out


@pytest.mark.parametrize("trace", ["tr-1", "never-seen"])
def test_query_matches(capsys, runs, trace):
    out = runs["root"] / "timeline.json"
    argv = ["query", "--trace", trace, "--logs", str(runs["root"]),
            "--json", str(out)]
    rc = pt_telemetry_cli.main(argv)
    pt_out, pt_doc = capsys.readouterr().out, json.loads(out.read_text())
    res = CliRunner().invoke(jax_telemetry_cli, argv)
    assert (rc, pt_out) == (res.exit_code, res.stdout)
    assert pt_doc == json.loads(out.read_text())
    assert rc == (0 if trace == "tr-1" else 1)


@pytest.mark.parametrize("objectives", ["repo", "fleet"])
def test_slo_report_over_metrics_matches(capsys, runs, objectives):
    out = runs["root"] / "slo.json"
    obj = REPO_SLO if objectives == "repo" else runs["slo"]
    argv = ["slo-report", "--objectives", str(obj), "--metrics",
            str(runs["metrics"]), "--json", str(out)]
    rc = pt_telemetry_cli.main(argv)
    pt_out, pt_doc = capsys.readouterr().out, json.loads(out.read_text())
    res = CliRunner().invoke(jax_telemetry_cli, argv)
    assert (rc, pt_out) == (res.exit_code, res.stdout)
    assert pt_doc == json.loads(out.read_text())
    assert rc in (0, 1, 2)


@pytest.fixture()
def store(tmp_path):
    db = RingTSDB(tmp_path / "tsdb", block_bytes=3000)
    for rec in fleet_samples(make_sample, 2, ticks=12):
        db.append(rec)
    db.close()
    (tmp_path / "slo.toml").write_text(FLEET_SLO_TOML)
    return tmp_path


def test_slo_report_over_a_tsdb_matches(capsys, store):
    argv = ["slo-report", "--objectives", str(store / "slo.toml"),
            "--tsdb", str(store / "tsdb"), "--events-out",
            str(store / "slo_events.jsonl")]
    rc, pt_out, jrc, jax_out = both(capsys, pt_telemetry_cli.main,
                                    jax_telemetry_cli, argv)
    assert (rc, pt_out) == (jrc, jax_out)
    lines = (store / "slo_events.jsonl").read_text().splitlines()
    assert len(lines) % 2 == 0  # each run wrote the same transitions


@pytest.mark.parametrize("argv", [
    ["--once"], ["--once", "--json"], ["--once", "--alerts-only"],
    ["--frames", "2", "--refresh", "0"], ["--once", "--slo", "SLO"]])
def test_top_matches(capsys, store, argv):
    argv = ["--tsdb", str(store / "tsdb")] + [
        str(store / "slo.toml") if a == "SLO" else a for a in argv]
    rc, pt_out, jrc, jax_out = both(capsys, pt_top_cli.main, jax_top_cli,
                                    argv)
    assert rc == jrc == 0
    assert pt_out.replace("progen-tpu-torch-top", "progen-tpu-top") == \
        jax_out


def test_top_json_needs_once_alike(capsys, store):
    argv = ["--tsdb", str(store / "tsdb"), "--json"]
    rc, _, jrc, _ = both(capsys, pt_top_cli.main, jax_top_cli, argv)
    assert rc == jrc == 2


def test_collector_once_scrapes_alike(capsys, tmp_path):
    prom = write_prom(tmp_path / "r0.prom", serving_prom(
        ServingMetrics, prometheus_text, 1, completed=4, queue=2,
        trace_ids=["t:1"]), 1e9)
    router = ServingMetrics()
    router.set_gauge("replicas_live", 2.0)
    rprom = write_prom(tmp_path / "router.prom",
                       prometheus_text(router, prefix="progen_router_"), 1e9)
    (tmp_path / "slo.toml").write_text(FLEET_SLO_TOML)
    samples = {}
    for name, run in (("port", pt_collector_cli.main),
                      ("jax", lambda a: CliRunner().invoke(
                          jax_collector_cli, a).exit_code)):
        argv = ["--tsdb", str(tmp_path / name), "--source",
                f"name=r0,prom={prom}", "--source",
                f"name=router,role=router,prom={rprom}", "--slo",
                str(tmp_path / "slo.toml"), "--stale-after", "1e12",
                "--once"]
        try:
            rc = run(argv)
        except SystemExit as e:
            rc = e.code
        assert rc == 0
        samples[name] = [
            {k: v for k, v in r.items() if k not in ("ts", "age_s")}
            for r in TsdbReader(tmp_path / name).read()]
    capsys.readouterr()
    assert samples["port"] == samples["jax"]
    assert len(samples["port"]) == 2 and all(s["up"]
                                             for s in samples["port"])


@pytest.mark.parametrize("argv", [
    ["--tsdb", "T"], ["--tsdb", "T", "--source", "prom=/p"],
    ["--tsdb", "T", "--slo", "/absent.toml", "--source", "name=a,prom=/p"]])
def test_collector_usage_errors_exit_2_alike(capsys, tmp_path, argv):
    argv = [str(tmp_path / "t") if a == "T" else a for a in argv]
    rc, _, jrc, _ = both(capsys, pt_collector_cli.main, jax_collector_cli,
                         argv)
    assert rc == jrc == 2

"""The port's ``telemetry/slo.py`` against the JAX package's: the same
objectives TOML (through the port's own ``load_toml_config``), the same
seeded metrics streams and expositions give the same burn rates, states,
payloads, report text, exit codes and ``ev:"slo"`` transition records,
and ``parse_prom_text`` reads the same values and exemplars."""

import dataclasses

import pytest

from progen_tpu.serving.metrics import ServingMetrics as JaxMetrics
from progen_tpu.telemetry import slo as jax_slo
from progen_tpu.telemetry.prometheus import prometheus_text as jax_text
from progen_tpu_torch.serving.metrics import ServingMetrics as PtMetrics
from progen_tpu_torch.telemetry import slo as pt_slo
from progen_tpu_torch.telemetry.prometheus import prometheus_text as pt_text
from torch_telemetry_cases import (
    FLEET_SLO_TOML,
    REPO_SLO,
    metrics_rows,
    serving_prom,
    write_prom,
)


def _cfgs(path):
    return pt_slo.load_objectives(path), jax_slo.load_objectives(path)


def _results(rs):
    return [dataclasses.asdict(r) for r in rs]


@pytest.fixture(params=["repo", "fleet"])
def slo_toml(request, tmp_path):
    if request.param == "repo":
        return REPO_SLO
    path = tmp_path / "slo.toml"
    path.write_text(FLEET_SLO_TOML)
    return path


def test_objectives_load_alike(slo_toml):
    pt, jx = _cfgs(slo_toml)
    assert dataclasses.asdict(pt) == dataclasses.asdict(jx)


@pytest.mark.parametrize("seed,n,now_shift", [
    (0, 30, None), (1, 5, None), (2, 60, 0.0), (3, 30, 4000.0),
    (4, 1, None)])
def test_evaluate_over_metrics_streams_matches(slo_toml, seed, n,
                                               now_shift):
    pt, jx = _cfgs(slo_toml)
    rows = [metrics_rows(seed, n=n), metrics_rows(seed + 9, n=n,
                                                  prefix="router/")]
    series = [pt_slo.samples_from_metrics(r) for r in rows]
    assert series == [jax_slo.samples_from_metrics(r) for r in rows]
    now = None if now_shift is None else series[0][-1][0] + now_shift
    got = pt_slo.evaluate(pt, series, now=now)
    want = jax_slo.evaluate(jx, series, now=now)
    assert _results(got) == _results(want)
    assert pt_slo.exit_code(got) == jax_slo.exit_code(want)
    assert pt_slo.results_payload(got) == jax_slo.results_payload(want)
    assert pt_slo.render_report(pt, got) == jax_slo.render_report(jx, want)


@pytest.mark.parametrize("age", [0.0, 45.0, 120.0])
def test_evaluate_over_prom_files_matches(tmp_path, slo_toml, age):
    pt, jx = _cfgs(slo_toml)
    text = serving_prom(PtMetrics, pt_text, 5, completed=9, queue=2)
    path = write_prom(tmp_path / "r0.prom", text, 1e9)
    proms_pt = [pt_slo.read_prom_file(path, now=1e9 + age)]
    proms_jx = [jax_slo.read_prom_file(path, now=1e9 + age)]
    assert proms_pt == proms_jx
    got = pt_slo.evaluate(pt, [], proms_pt, now=1e9 + age)
    want = jax_slo.evaluate(jx, [], proms_jx, now=1e9 + age)
    assert _results(got) == _results(want)
    assert pt_slo.read_prom_file(tmp_path / "absent.prom") is None


@pytest.mark.parametrize("metrics_cls,text_fn", [
    (PtMetrics, pt_text), (JaxMetrics, jax_text)], ids=["port", "jax"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parse_prom_text_matches(metrics_cls, text_fn, seed):
    text = serving_prom(metrics_cls, text_fn, seed, completed=seed + 3,
                        queue=seed, trace_ids=["t:1", "t:2"])
    text += 'odd_metric{label="a\\"b\\\\c"} 2.5\nbroken line\n'
    assert pt_slo.parse_prom_text(text) == jax_slo.parse_prom_text(text)
    assert pt_slo.parse_prom_exemplars(text) == \
        jax_slo.parse_prom_exemplars(text)
    assert pt_slo.parse_prom_exemplars(text)


def test_slo_watch_transitions_match(slo_toml):
    pt, jx = _cfgs(slo_toml)
    rows = metrics_rows(6, n=40)
    pw_seen, jw_seen = [], []
    pw = pt_slo.SloWatch(pt, emit=pw_seen.append)
    jw = jax_slo.SloWatch(jx, emit=jw_seen.append)
    pw.seed("latency_p99", "resolved")
    jw.seed("latency_p99", "resolved")
    for end in range(2, 41, 3):
        series = [pt_slo.samples_from_metrics(rows[:end])]
        got = pw.observe(pt_slo.evaluate(pt, series), now=float(end))
        want = jw.observe(jax_slo.evaluate(jx, series), now=float(end))
        assert got == want
    assert pw_seen == jw_seen

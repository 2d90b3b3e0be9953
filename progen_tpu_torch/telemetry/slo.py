"""Fleet SLO watchtower: objectives → multi-window burn rates → gates.

Serving telemetry so far answers "what happened" (traces, journals,
metrics streams); nothing answered "are we OK right now, and is it
getting worse fast enough to page?". This module is that layer —
MegaScale-style fleet supervision (PAPERS.md) applied to the serving
stack's own exhaust:

  * objectives load from a flat-table TOML (``configs/serving/slo.toml``
    is the shipped default): latency quantile ceilings (TTFT p95,
    request latency p99), error/shed-rate budgets, and fleet
    availability floors;
  * evidence comes from the files the fleet already writes — tracker
    ``metrics.jsonl`` rows (the windowed time series) and Prometheus
    textfiles (the freshest point sample; also the staleness signal:
    an exposition file nobody has rewritten lately means the process
    behind it is gone or wedged);
  * each objective gets a SHORT- and LONG-window burn rate (burn 1.0 =
    consuming exactly the error budget; the SRE-workbook multiwindow
    rule): ``burning`` needs BOTH windows over the hot threshold (a
    fast burn that also moved the long window — real, page), ``warn``
    is a long-window drift or a short-window spike (watch), anything
    without data is at least ``warn`` (an SLO you cannot evaluate is
    not "ok");
  * ``SloWatch`` turns per-tick states into ``ev: "slo"`` TRANSITION
    records on the telemetry stream (only edges, never steady-state
    spam; recovery emits ``state: "resolved"``) so the watchtower's own
    judgments land in the same events.jsonl the trace tooling reads;
  * ``exit_code`` maps a report to the CI contract: 0 all ok, 1 any
    warn, 2 any burning — ``progen-tpu-torch-telemetry slo-report`` is a
    gate you can put in a pipeline.

Report-mode determinism: ``evaluate`` defaults ``now`` to the newest
sample timestamp, so re-running a report over archived artifacts always
judges the run "as of its end" — live ``watch`` mode passes wall clock
instead. Latency quantiles come from cumulative reservoirs (the
registry keeps running quantiles, not windowed ones), so both windows
see the same latest value; the windowing bites on the counter-delta and
availability objectives, which is where burn-rate math matters most.

The port's copy of the JAX package's ``telemetry/slo.py``.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from progen_tpu_torch.config import load_toml_config

STATE_OK = "ok"
STATE_WARN = "warn"
STATE_BURNING = "burning"
STATE_RESOLVED = "resolved"

# exposition prefixes stripped when reading prom textfiles so objective
# metric names match the registry's raw names ("ttft_s", "replicas_up")
_PROM_PREFIXES = ("progen_router_", "progen_serve_", "progen_")

# quantile label → the snapshot()-style suffix metrics.jsonl rows use,
# so one objective key addresses both evidence sources
_QUANTILE_KEYS = {"0.5": "p50_s", "0.95": "p95_s", "0.99": "p99_s"}

# the optional tail is an OpenMetrics exemplar (`# {trace_id="..."} v`)
# — tolerated on any sample line so exemplar-bearing expositions parse
# to the same values as plain ones (the exemplars themselves are read
# by parse_prom_exemplars)
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)"
    r"(?:\s+#\s*\{.*\}\s+\S+)?\s*$"
)
_QUANT_RE = re.compile(r'quantile="([^"]+)"')
_EXEMPLAR_RE = re.compile(
    r'#\s*\{trace_id="((?:[^"\\]|\\.)*)"\}\s+(\S+)\s*$'
)


def unescape_label_value(raw: str) -> str:
    """Inverse of ``telemetry.prometheus.escape_label_value`` — the
    scrape side of the exemplar trace_id round-trip."""
    out = []
    i = 0
    while i < len(raw):
        c = raw[i]
        if c == "\\" and i + 1 < len(raw):
            nxt = raw[i + 1]
            out.append("\n" if nxt == "n" else nxt)
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def parse_prom_text(text: str) -> Dict[str, float]:
    """Prometheus exposition text → flat {metric: value}.

    Names are normalized back to registry spellings: prefixes stripped,
    ``_total`` counters bared, ``*_seconds{quantile="0.95"}`` summary
    samples become ``*_s_p95_s`` (matching ``_Timing.stats()`` keys in
    metrics.jsonl rows). Torn or garbage lines are skipped, never fatal
    — the atomic-write contract allows a reader to race a dying writer,
    and a gate that crashes on its evidence is worse than one that
    reports the evidence thin."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, labels, raw = m.groups()
        try:
            value = float(raw)
        except ValueError:
            continue
        for p in _PROM_PREFIXES:
            if name.startswith(p):
                name = name[len(p):]
                break
        if name.endswith("_seconds"):
            name = name[: -len("_seconds")] + "_s"
        elif name.endswith("_seconds_sum"):
            name = name[: -len("_seconds_sum")] + "_s_sum"
        elif name.endswith("_seconds_count"):
            name = name[: -len("_seconds_count")] + "_s_count"
        if labels:
            q = _QUANT_RE.search(labels)
            suffix = None if q is None else _QUANTILE_KEYS.get(q.group(1))
            if suffix is None:
                continue
            out[f"{name}_{suffix}"] = value
        elif name.endswith("_total"):
            out[name[: -len("_total")]] = value
        else:
            out[name] = value
    return out


def parse_prom_exemplars(text: str) -> Dict[str, list]:
    """The exemplar side-channel of an exposition: normalized
    timing-family key (``ttft_s``) → worst-first
    ``[{"value", "trace_id"}]`` parsed from the OpenMetrics
    ``# {trace_id="..."} value`` suffixes the renderer attaches to
    summary quantile lines. Families without exemplars are absent."""
    fams: Dict[str, list] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        em = _EXEMPLAR_RE.search(line)
        if em is None or _SAMPLE_RE.match(line) is None:
            continue
        name = _SAMPLE_RE.match(line).group(1)
        try:
            value = float(em.group(2))
        except ValueError:
            continue
        for p in _PROM_PREFIXES:
            if name.startswith(p):
                name = name[len(p):]
                break
        if name.endswith("_seconds"):
            name = name[: -len("_seconds")] + "_s"
        fams.setdefault(name, []).append({
            "value": value,
            "trace_id": unescape_label_value(em.group(1)),
        })
    for exs in fams.values():
        exs.sort(key=lambda e: -e["value"])
    return fams


def read_prom_file(path, now: Optional[float] = None):
    """(age_s, values) for one exposition textfile — age from the file's
    mtime (the atomic-rename write refreshes it every publish), which is
    the watchtower's liveness signal for the process behind the file.
    Returns None when the file does not exist."""
    p = Path(path)
    try:
        stat = p.stat()
        text = p.read_text()
    except OSError:
        return None
    age = max(0.0, (time.time() if now is None else now) - stat.st_mtime)
    return age, parse_prom_text(text)


def samples_from_metrics(rows: Iterable[dict]) -> List[Tuple[float, Dict[str, float]]]:
    """tracking.py metrics.jsonl rows → time-sorted (t, values) samples
    with the ``router/``/``serve/`` stream prefixes stripped (one
    objective key addresses every process's stream)."""
    out: List[Tuple[float, Dict[str, float]]] = []
    for rec in rows:
        t = rec.get("_time")
        if t is None:
            continue
        vals: Dict[str, float] = {}
        for k, v in rec.items():
            if k.startswith("_") or isinstance(v, bool) \
                    or not isinstance(v, (int, float)):
                continue
            vals[k.split("/", 1)[1] if "/" in k else k] = float(v)
        if vals:
            out.append((float(t), vals))
    out.sort(key=lambda s: s[0])
    return out


@dataclass
class Objective:
    """One SLO. ``kind`` selects the burn-rate math:

    * ``latency`` — ``metric`` quantile (``quantile`` ∈ p50/p95/p99)
      must stay under ``threshold_s``; burn = value / threshold;
    * ``ratio`` — counter ``bad`` over counter ``total`` (windowed
      deltas, reset-safe) must stay under ``budget``; burn =
      rate / budget;
    * ``availability`` — fraction of window samples with gauge
      ``metric`` >= ``min_value`` must stay over ``target``; burn =
      unavailable fraction / allowed unavailable fraction."""

    name: str
    kind: str
    metric: str = ""
    quantile: str = "p95"
    threshold_s: float = 0.0
    bad: str = ""
    total: str = ""
    budget: float = 0.0
    min_value: float = 1.0
    target: float = 0.99


@dataclass
class SloConfig:
    short_s: float = 300.0
    long_s: float = 3600.0
    warn: float = 1.0
    hot: float = 2.0
    stale_after_s: float = 60.0
    objectives: List[Objective] = field(default_factory=list)


_KINDS = ("latency", "ratio", "availability")


def load_objectives(path) -> SloConfig:
    """SloConfig from a TOML file. Flat tables only — ``[windows]``,
    ``[burn]``, and one ``[objective_<name>]`` section per objective —
    the exact subset config.py's minimal fallback parser accepts, so
    the gate works identically on pre-tomllib hosts."""
    raw = load_toml_config(str(path))
    cfg = SloConfig()
    win = raw.get("windows", {})
    if isinstance(win, dict):
        cfg.short_s = float(win.get("short_s", cfg.short_s))
        cfg.long_s = float(win.get("long_s", cfg.long_s))
    burn = raw.get("burn", {})
    if isinstance(burn, dict):
        cfg.warn = float(burn.get("warn", cfg.warn))
        cfg.hot = float(burn.get("hot", cfg.hot))
        cfg.stale_after_s = float(
            burn.get("stale_after_s", cfg.stale_after_s)
        )
    for section, table in raw.items():
        if not section.startswith("objective_") \
                or not isinstance(table, dict):
            continue
        name = section[len("objective_"):]
        kind = str(table.get("kind", ""))
        if kind not in _KINDS:
            raise ValueError(
                f"{path}: objective {name!r} has unknown kind {kind!r} "
                f"(want one of {_KINDS})"
            )
        quantile = str(table.get("quantile", "p95"))
        if kind == "latency" and quantile not in ("p50", "p95", "p99"):
            raise ValueError(
                f"{path}: objective {name!r} quantile {quantile!r} "
                "(want p50/p95/p99)"
            )
        cfg.objectives.append(Objective(
            name=name,
            kind=kind,
            metric=str(table.get("metric", table.get("gauge", ""))),
            quantile=quantile,
            threshold_s=float(table.get("threshold_s", 0.0)),
            bad=str(table.get("bad", "")),
            total=str(table.get("total", "")),
            budget=float(table.get("budget", 0.0)),
            min_value=float(table.get("min_value", 1.0)),
            target=float(table.get("target", 0.99)),
        ))
    if not cfg.objectives:
        raise ValueError(f"{path}: no [objective_*] sections")
    return cfg


@dataclass
class SloResult:
    objective: str
    kind: str
    state: str
    burn_short: Optional[float]
    burn_long: Optional[float]
    value: Optional[float] = None
    detail: str = ""


def _window_delta(samples, key: str, start: float, end: float) -> float:
    """Counter increase over (start, end]: baseline is the last sample
    at or before ``start`` (0.0 when the counter predates the series),
    endpoint the last at or before ``end``. A negative delta means the
    counter reset mid-window (process restart) — the end value is the
    floor of what actually happened since, so use it rather than 0."""
    base = 0.0
    last = None
    for t, vals in samples:
        if key not in vals or t > end:
            continue
        if t <= start:
            base = vals[key]
        last = vals[key]
    if last is None:
        return 0.0
    delta = last - base
    return last if delta < 0 else delta


def _ratio_burn(
    obj: Objective, series, start: float, end: float
) -> Optional[float]:
    """None when NO stream has an in-window sample of the ``total``
    counter — an error budget judged on zero evidence is unevaluable
    (→ warn), which is different from evidence showing zero errors."""
    if not any(
        any(start <= t <= end and obj.total in vals for t, vals in s)
        for s in series
    ):
        return None
    bad = sum(_window_delta(s, obj.bad, start, end) for s in series)
    total = sum(_window_delta(s, obj.total, start, end) for s in series)
    if total <= 0:
        return 0.0
    rate = bad / total
    if obj.budget <= 0:
        return float("inf") if rate > 0 else 0.0
    return rate / obj.budget


def _availability_burn(
    obj: Objective, series, start: float, end: float
) -> Optional[Tuple[float, float]]:
    n = ok = 0
    for samples in series:
        for t, vals in samples:
            if start <= t <= end and obj.metric in vals:
                n += 1
                if vals[obj.metric] >= obj.min_value:
                    ok += 1
    if n == 0:
        return None
    frac = ok / n
    burn = (1.0 - frac) / max(1.0 - obj.target, 1e-9)
    return burn, frac


def _latency_value(
    obj: Objective, series, proms, stale_after_s: float,
    start: float, end: float,
):
    """Worst (max) observed quantile across sources: fresh prom
    textfiles win (they are the newest reservoir snapshot), else the
    last in-window metrics sample per stream. Returns (value, stale) —
    ``stale`` flags that the ONLY evidence sat in an expired textfile,
    which is a liveness problem, not a latency number."""
    key = f"{obj.metric}_{obj.quantile}_s"
    values: List[float] = []
    stale_only = False
    for age, vals in proms:
        if key not in vals:
            continue
        if age <= stale_after_s:
            values.append(vals[key])
        else:
            stale_only = True
    for samples in series:
        last = None
        for t, vals in samples:
            if start <= t <= end and key in vals:
                last = vals[key]
        if last is not None:
            values.append(last)
    if values:
        return max(values), False
    return None, stale_only


def _classify(cfg: SloConfig, burn_short, burn_long) -> str:
    if burn_short is None or burn_long is None:
        return STATE_WARN
    if burn_short >= cfg.hot and burn_long >= cfg.hot:
        return STATE_BURNING
    if burn_long >= cfg.warn or burn_short >= cfg.hot:
        return STATE_WARN
    return STATE_OK


def evaluate(
    cfg: SloConfig,
    series: Sequence[Sequence[Tuple[float, Dict[str, float]]]] = (),
    proms: Sequence[Tuple[float, Dict[str, float]]] = (),
    now: Optional[float] = None,
) -> List[SloResult]:
    """Judge every objective against the evidence.

    ``series`` are ``samples_from_metrics`` outputs (one per metrics
    stream), ``proms`` are ``read_prom_file`` outputs. ``now`` defaults
    to the newest sample timestamp so reports over archived artifacts
    are deterministic; live callers pass wall clock."""
    series = [list(s) for s in series]
    if now is None:
        tails = [s[-1][0] for s in series if s]
        now = max(tails) if tails else time.time()
    results: List[SloResult] = []
    for obj in cfg.objectives:
        burn_short: Optional[float]
        burn_long: Optional[float]
        value: Optional[float] = None
        detail = ""
        if obj.kind == "latency":
            value, stale = _latency_value(
                obj, series, proms, cfg.stale_after_s,
                now - cfg.long_s, now,
            )
            if value is None:
                burn_short = burn_long = None
                detail = "stale exposition" if stale else "no data"
            else:
                burn = (
                    value / obj.threshold_s if obj.threshold_s > 0
                    else float("inf") if value > 0 else 0.0
                )
                burn_short = burn_long = burn
        elif obj.kind == "ratio":
            burn_long = _ratio_burn(obj, series, now - cfg.long_s, now)
            if burn_long is None:
                burn_short = None
                detail = "no data"
            else:
                short = _ratio_burn(
                    obj, series, now - cfg.short_s, now
                )
                # an empty short window inherits the long-window burn
                # (sparse sampling must not fake a recovery)
                burn_short = burn_long if short is None else short
                value = burn_long * obj.budget
        else:  # availability
            short = _availability_burn(
                obj, series, now - cfg.short_s, now
            )
            long_ = _availability_burn(
                obj, series, now - cfg.long_s, now
            )
            if long_ is None:
                burn_short = burn_long = None
                detail = "no data"
            else:
                # an empty short window inherits the long-window burn
                # (sparse sampling must not fake a recovery)
                burn_long, value = long_
                burn_short = long_[0] if short is None else short[0]
        results.append(SloResult(
            objective=obj.name,
            kind=obj.kind,
            state=_classify(cfg, burn_short, burn_long),
            burn_short=burn_short,
            burn_long=burn_long,
            value=value,
            detail=detail,
        ))
    return results


def exit_code(results: Sequence[SloResult]) -> int:
    """The CI contract: 0 every objective ok, 1 any warn, 2 any burning."""
    if any(r.state == STATE_BURNING for r in results):
        return 2
    if any(r.state == STATE_WARN for r in results):
        return 1
    return 0


def _round(x: Optional[float]) -> Optional[float]:
    if x is None:
        return None
    if x != x or x in (float("inf"), float("-inf")):
        return x
    return round(float(x), 4)


def results_payload(results: Sequence[SloResult]) -> dict:
    """JSON-able report form shared by ``slo-report --json``, the ops
    console snapshot, and the collector's CI artifacts — one spelling
    of the result schema so scripts never chase two."""
    return {
        "exit": exit_code(results),
        "results": [
            {
                "objective": r.objective, "kind": r.kind,
                "state": r.state, "burn_short": r.burn_short,
                "burn_long": r.burn_long, "value": r.value,
                "detail": r.detail,
            }
            for r in results
        ],
    }


class SloWatch:
    """Objective-state machine emitting ``ev: "slo"`` records.

    Feed it ``evaluate`` results each tick; it emits ONE record per
    state transition (objectives start assumed ok, recovery emits
    ``state: "resolved"``) into the telemetry stream — edges only, so a
    week of healthy watching adds zero lines to events.jsonl."""

    def __init__(self, cfg: SloConfig, emit=None):
        self.cfg = cfg
        self._emit = emit
        self._last: Dict[str, str] = {}

    def seed(self, objective: str, state: str) -> None:
        """Prime the transition detector from persisted alert state
        (restart continuity): a watcher that reboots mid-burn must not
        re-announce the burn, and a persisted ``resolved`` means the
        objective is currently ok."""
        self._last[str(objective)] = (
            STATE_OK if state == STATE_RESOLVED else str(state)
        )

    def observe(
        self, results: Sequence[SloResult], now: Optional[float] = None
    ) -> List[dict]:
        emit = self._emit
        if emit is None:
            from progen_tpu_torch.telemetry.spans import get_telemetry

            emit = get_telemetry().emit
        out: List[dict] = []
        ts = float(time.time() if now is None else now)
        for r in results:
            prev = self._last.get(r.objective, STATE_OK)
            if r.state == prev:
                continue
            self._last[r.objective] = r.state
            state = STATE_RESOLVED if r.state == STATE_OK else r.state
            rec = {
                "ev": "slo",
                "ts": ts,
                "objective": r.objective,
                "state": state,
                "prev": prev,
                "burn_short": _round(r.burn_short),
                "burn_long": _round(r.burn_long),
                "value": _round(r.value),
            }
            if r.detail:
                rec["detail"] = r.detail
            emit(rec)
            out.append(rec)
        return out


def render_report(
    cfg: SloConfig, results: Sequence[SloResult]
) -> str:
    """Human-readable gate report (the slo-report CLI's stdout)."""
    lines = [
        f"SLO report — windows {cfg.short_s:g}s/{cfg.long_s:g}s, "
        f"warn>={cfg.warn:g} hot>={cfg.hot:g}",
        f"{'objective':<22} {'kind':<13} {'state':<8} "
        f"{'burn_short':>10} {'burn_long':>10} {'value':>10}",
    ]

    def _cell(x: Optional[float]) -> str:
        return "-" if x is None else f"{x:.3f}"

    for r in results:
        row = (
            f"{r.objective:<22} {r.kind:<13} {r.state:<8} "
            f"{_cell(r.burn_short):>10} {_cell(r.burn_long):>10} "
            f"{_cell(r.value):>10}"
        )
        if r.detail:
            row += f"  ({r.detail})"
        lines.append(row)
    lines.append(f"gate: exit {exit_code(results)}")
    return "\n".join(lines)

"""Fleet metrics collector: scrape N sources → stamped samples → TSDB.

The fleet's signals are scattered — one Prometheus textfile per replica
and per router, one ``metrics.jsonl`` per run — and each answers only
for its own process. This module is the aggregation layer the
autoscaler / canary controller / ops console all read:

  * ``Collector`` scrapes every configured :class:`SourceSpec` on a
    tick: Prometheus textfiles via the existing ``parse_prom_text``
    (with a ``# TYPE`` scan so counter/gauge/summary identity survives
    the name normalization), ``metrics.jsonl`` tails incrementally by
    byte offset via the same torn-line rules as ``iter_jsonl``;
  * every scrape becomes ONE ``ev:"sample"`` record per source —
    stamped with source name, role, staleness age and an ``up`` bit
    (exposition mtime is the liveness heartbeat) — appended to a
    :class:`~progen_tpu_torch.telemetry.tsdb.RingTSDB`. ``make_sample`` is
    the single constructor for these records; PGL006 enforces that no
    other module fabricates them;
  * ``fleet_series`` folds the per-source samples into ONE aggregated
    time series in the exact ``samples_from_metrics`` shape
    ``slo.evaluate`` consumes: counters **sum** across sources with
    counter-reset rebasing (a respawned replica restarting from zero
    must never drive a fleet rate negative — its pre-reset total is
    carried as a base), gauges aggregate **max**/**min**/**sum**,
    timing reservoirs merge exactly on ``sum``/``count`` and
    approximately on quantiles (count-weighted mixture-CDF inversion
    via ``merge_quantiles``), and derived fleet gauges
    (``fleet_up``, ``replicas_live``, …) carry the liveness story;
  * staleness transitions and fleet-SLO burn transitions fan into an
    :class:`~progen_tpu_torch.telemetry.alerts.AlertSink`.

Deliberately device-free: the collector is a host-side sidecar, startable
anywhere the exposition files are visible.

The port's copy of the JAX package's ``telemetry/collector.py``.
"""

from __future__ import annotations

import math
import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from progen_tpu_torch.telemetry.remote_write import fleet_kinds
from progen_tpu_torch.telemetry.slo import (
    SloConfig,
    SloWatch,
    evaluate,
    parse_prom_exemplars,
    parse_prom_text,
)

_TYPE_RE = re.compile(r"^#\s*TYPE\s+(\S+)\s+(\S+)\s*$")
_PROM_PREFIXES = ("progen_router_", "progen_serve_", "progen_")
_QUANTILE_KEYS = ("p50_s", "p95_s", "p99_s")
_ROLES = ("replica", "router", "run")

# metrics.jsonl rows carry no TYPE metadata, so counter identity for
# tailed sources comes from this list (the serving/router/workload
# counter families that matter to fleet rates)
_JSONL_COUNTERS = (
    "requests_submitted", "requests_completed", "requests_rejected",
    "requests_admitted", "requests_expired", "decode_steps",
    "decode_tokens", "prefill_tokens", "tokens_forwarded",
    "dispatched_total", "handoffs_total", "replica_down_total",
    "journal_replayed", "reloads", "reload_rejected", "retries",
    "sequences_scored", "tokens_scored",
)


@dataclass
class SourceSpec:
    """One scrape target. ``prom`` and ``metrics`` are both optional but
    at least one must be set; ``prom`` drives the ``up`` heartbeat."""

    name: str
    role: str = "replica"
    prom: Optional[str] = None
    metrics: Optional[str] = None

    def __post_init__(self):
        if self.role not in _ROLES:
            raise ValueError(
                f"source {self.name!r}: role {self.role!r} "
                f"(want one of {_ROLES})"
            )
        if not self.prom and not self.metrics:
            raise ValueError(
                f"source {self.name!r}: need prom= and/or metrics="
            )


def parse_source_spec(spec: str) -> SourceSpec:
    """``name=r0,role=replica,prom=/p/metrics.prom[,metrics=/m.jsonl]``
    → SourceSpec (the --source CLI syntax, mirroring the router's
    --replica specs)."""
    kv: Dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad --source fragment {part!r} in {spec!r}")
        k, v = part.split("=", 1)
        kv[k.strip()] = v.strip()
    unknown = set(kv) - {"name", "role", "prom", "metrics"}
    if unknown:
        raise ValueError(f"unknown --source keys {sorted(unknown)} in {spec!r}")
    if "name" not in kv:
        raise ValueError(f"--source needs name=: {spec!r}")
    return SourceSpec(
        name=kv["name"],
        role=kv.get("role", "replica"),
        prom=kv.get("prom"),
        metrics=kv.get("metrics"),
    )


def prom_families(text: str) -> Dict[str, str]:
    """``# TYPE`` lines → {normalized family name: kind}. Names are
    normalized exactly like ``parse_prom_text`` normalizes samples
    (prefix stripped, ``_total`` bared, ``_seconds`` → ``_s``) so the
    two maps join on the same keys."""
    out: Dict[str, str] = {}
    for line in text.splitlines():
        m = _TYPE_RE.match(line.strip())
        if m is None:
            continue
        name, kind = m.groups()
        for p in _PROM_PREFIXES:
            if name.startswith(p):
                name = name[len(p):]
                break
        if name.endswith("_total"):
            name = name[: -len("_total")]
        elif name.endswith("_seconds"):
            name = name[: -len("_seconds")] + "_s"
        out[name] = kind
    return out


def make_sample(
    ts: float,
    source: str,
    role: str,
    up: bool,
    age_s: float,
    counters: Optional[Dict[str, float]] = None,
    gauges: Optional[Dict[str, float]] = None,
    timings: Optional[Dict[str, dict]] = None,
) -> dict:
    """The one constructor for ``ev:"sample"`` records (PGL006 keeps it
    that way). ``timings`` values are ``{"sum","count","p50_s",...}``."""
    return {
        "ev": "sample",
        "ts": float(ts),
        "source": str(source),
        "role": str(role),
        "up": int(bool(up)),
        "age_s": round(float(age_s), 3),
        "counters": dict(counters or {}),
        "gauges": dict(gauges or {}),
        "timings": {k: dict(v) for k, v in (timings or {}).items()},
    }


def split_prom_values(
    vals: Dict[str, float], families: Dict[str, str]
) -> Tuple[Dict[str, float], Dict[str, float], Dict[str, dict]]:
    """parse_prom_text output + TYPE map → (counters, gauges, timings).
    Samples without a TYPE line fall back to gauge (the conservative
    reading: a mistaken counter only loses rate math, a mistaken gauge
    would corrupt fleet sums after restarts)."""
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    timings: Dict[str, dict] = {}
    summary_keys = set()
    for fam, kind in families.items():
        if kind != "summary":
            continue
        t: dict = {}
        for q in _QUANTILE_KEYS:
            k = f"{fam}_{q}"
            if k in vals:
                t[q] = vals[k]
                summary_keys.add(k)
        for suffix in ("sum", "count"):
            k = f"{fam}_{suffix}"
            if k in vals:
                t[suffix] = vals[k]
                summary_keys.add(k)
        if t:
            timings[fam] = t
    for k, v in vals.items():
        if k in summary_keys:
            continue
        kind = families.get(k)
        if kind == "counter":
            counters[k] = v
        else:
            gauges[k] = v
    return counters, gauges, timings


def _timings_from_row(vals: Dict[str, float]) -> Dict[str, dict]:
    """Reassemble ``_Timing.stats()`` flat keys from a metrics.jsonl row
    into per-family dicts; families are detected by their ``_count`` +
    ``_p50_s`` pair. Pre-PR-12 rows lack ``_sum`` — reconstruct it from
    the mean so fleet averages stay mergeable across old artifacts."""
    out: Dict[str, dict] = {}
    for k in list(vals):
        if not k.endswith("_count"):
            continue
        fam = k[: -len("_count")]
        if f"{fam}_p50_s" not in vals:
            continue
        t: dict = {"count": vals[k]}
        for q in _QUANTILE_KEYS:
            qk = f"{fam}_{q}"
            if qk in vals:
                t[q] = vals[qk]
        if f"{fam}_sum" in vals:
            t["sum"] = vals[f"{fam}_sum"]
        elif f"{fam}_mean_s" in vals:
            t["sum"] = vals[f"{fam}_mean_s"] * vals[k]
        out[fam] = t
    return out


_TIMING_STAT_SUFFIXES = (
    "_p50_s", "_p95_s", "_p99_s", "_mean_s", "_max_s", "_min_s",
    "_count", "_sum",
)


class _Tail:
    """Incremental reader for a metrics.jsonl stream: remembers the
    byte offset, tolerates a torn final line by leaving it unread until
    the writer finishes it, and survives truncation (file rewritten)
    by rewinding to zero."""

    def __init__(self, path):
        self.path = Path(path)
        self.offset = 0
        self.dropped = 0

    def read_new(self) -> List[dict]:
        import json

        try:
            size = self.path.stat().st_size
        except OSError:
            return []
        if size < self.offset:
            self.offset = 0
        if size == self.offset:
            return []
        with self.path.open("rb") as f:
            f.seek(self.offset)
            data = f.read()
        end = data.rfind(b"\n") + 1
        if end == 0:
            return []
        self.offset += end
        rows: List[dict] = []
        for line in data[:end].splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                self.dropped += 1
                continue
            if isinstance(rec, dict):
                rows.append(rec)
            else:
                self.dropped += 1
        return rows


class Collector:
    """Scrape loop state: per-source tails, last-known ``up`` bits for
    staleness transitions, a bounded in-memory sample window for live
    SLO evaluation, and the TSDB + alert sinks."""

    def __init__(
        self,
        tsdb,
        sources: Sequence[SourceSpec],
        stale_after_s: float = 10.0,
        slo_cfg: Optional[SloConfig] = None,
        alerts=None,
        window_s: Optional[float] = None,
        remote_write=None,
        profile_pins: Sequence[str] = (),
        profile_min_interval_s: float = 300.0,
    ):
        names = [s.name for s in sources]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate source names: {names}")
        self.tsdb = tsdb
        self.sources = list(sources)
        self.stale_after_s = float(stale_after_s)
        self.slo_cfg = slo_cfg
        self.alerts = alerts
        self.remote_write = remote_write
        self._tails = {
            s.name: _Tail(s.metrics) for s in self.sources if s.metrics
        }
        self._last_row: Dict[str, Tuple[float, dict]] = {}
        self._up_last: Dict[str, int] = {}
        self._window: List[dict] = []
        self._window_s = float(
            window_s if window_s is not None
            else (slo_cfg.long_s if slo_cfg else 3600.0) * 1.25
        )
        self._watch = (
            SloWatch(slo_cfg, emit=self._emit_slo) if slo_cfg else None
        )
        # on-demand forensics: pins to raise when an SLO starts burning
        # (one per serve/train process we can ask to self-profile)
        self.profile_pins = [str(p) for p in profile_pins]
        self.profile_min_interval_s = float(profile_min_interval_s)
        self._profile_last = -math.inf
        # restart continuity: seed the transition detectors from the
        # sink's persisted states so an edge that happened while this
        # collector was down still fires (and a condition it already
        # reported does not re-fire)
        if alerts is not None and hasattr(alerts, "last_states"):
            for name, state in alerts.last_states("staleness").items():
                if name in set(names):
                    self._up_last[name] = 1 if state == "fresh" else 0
            if self._watch is not None:
                for obj, state in alerts.last_states("slo_burn").items():
                    self._watch.seed(obj, state)

    # -- scraping ---------------------------------------------------------

    def _scrape_prom(self, path, now: float):
        p = Path(path)
        try:
            stat = p.stat()
            text = p.read_text()
        except OSError:
            return None
        age = max(0.0, now - stat.st_mtime)
        return (
            age,
            parse_prom_text(text),
            prom_families(text),
            parse_prom_exemplars(text),
        )

    def _scrape_source(self, src: SourceSpec, now: float) -> dict:
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        timings: Dict[str, dict] = {}
        age = float("inf")
        seen = False
        if src.prom:
            got = self._scrape_prom(src.prom, now)
            if got is not None:
                prom_age, vals, families, exemplars = got
                counters, gauges, timings = split_prom_values(
                    vals, families
                )
                # trace exemplars ride the timing dicts (schema-free
                # values) so they reach the TSDB / console / alerts
                # without touching the sample record shape
                for fam, exs in exemplars.items():
                    if fam in timings and exs:
                        timings[fam]["exemplars"] = exs
                age = prom_age
                seen = True
        tail = self._tails.get(src.name)
        if tail is not None:
            rows = tail.read_new()
            for rec in rows:
                t = rec.get("_time")
                if t is not None:
                    self._last_row[src.name] = (float(t), rec)
            last = self._last_row.get(src.name)
            if last is not None:
                row_t, rec = last
                vals: Dict[str, float] = {}
                for k, v in rec.items():
                    if k.startswith("_") or isinstance(v, bool) \
                            or not isinstance(v, (int, float)):
                        continue
                    vals[k.split("/", 1)[1] if "/" in k else k] = float(v)
                row_timings = _timings_from_row(vals)
                for fam, t in row_timings.items():
                    timings.setdefault(fam, t)
                for k, v in vals.items():
                    if any(k.endswith(s) for s in _TIMING_STAT_SUFFIXES):
                        continue
                    if k in _JSONL_COUNTERS:
                        counters.setdefault(k, v)
                    else:
                        gauges.setdefault(k, v)
                age = min(age, max(0.0, now - row_t))
                seen = True
        up = seen and age <= self.stale_after_s
        return make_sample(
            ts=now,
            source=src.name,
            role=src.role,
            up=up,
            age_s=0.0 if age == float("inf") else age,
            counters=counters,
            gauges=gauges,
            timings=timings,
        )

    def scrape_once(self, now: Optional[float] = None) -> List[dict]:
        """One tick: scrape every source, append samples to the TSDB,
        fire staleness/SLO alert transitions. Returns the samples."""
        now = time.time() if now is None else float(now)
        samples = [self._scrape_source(s, now) for s in self.sources]
        for rec in samples:
            self.tsdb.append(rec)
        self._window.extend(samples)
        cutoff = now - self._window_s
        if self._window and self._window[0]["ts"] < cutoff:
            self._window = [
                r for r in self._window if r["ts"] >= cutoff
            ]
        self._staleness_transitions(samples, now)
        fleet = None
        if self._watch is not None or self.remote_write is not None:
            fleet = fleet_series(self._window)
        if self._watch is not None:
            results = evaluate(self.slo_cfg, [fleet], now=now)
            self._watch.observe(results, now=now)
        if self.remote_write is not None and fleet:
            counters, timings = fleet_kinds(self._window)
            t, vals = fleet[-1]
            self.remote_write.offer(t, vals, counters, timings)
            self.remote_write.flush(now)
        return samples

    # -- alerting ---------------------------------------------------------

    def _staleness_transitions(self, samples: List[dict], now: float):
        for rec in samples:
            name = rec["source"]
            prev = self._up_last.get(name)
            self._up_last[name] = rec["up"]
            if prev is None or prev == rec["up"]:
                continue
            if self.alerts is not None:
                self.alerts.staleness(
                    source=name,
                    up=bool(rec["up"]),
                    age_s=rec["age_s"],
                    now=now,
                )

    def _emit_slo(self, rec: dict) -> None:
        if self.alerts is not None:
            self.alerts.slo_transition(
                rec, exemplars=fleet_exemplars(self._window)
            )
        # also forward through the telemetry stream: the SloWatch above
        # is wired to this method *instead of* get_telemetry().emit, so
        # without this the flight recorder's tap (which dumps on the
        # burning edge) would never see collector-side transitions
        from progen_tpu_torch.telemetry.spans import get_telemetry

        get_telemetry().emit(rec)
        if rec.get("state") == "burning":
            self._auto_profile(rec)

    def _auto_profile(self, rec: dict) -> None:
        """First burning edge → raise ``profile.pin`` on every
        configured target so the processes behind the burn capture a
        bounded trace window while the badness is still happening.
        Rate-limited so a flapping objective cannot spam windows."""
        if not self.profile_pins:
            return
        now = float(rec.get("ts", time.time()))
        if now - self._profile_last < self.profile_min_interval_s:
            return
        self._profile_last = now
        from progen_tpu_torch.telemetry import flight

        for pin in self.profile_pins:
            try:
                flight.request_profile(
                    pin, token=f"slo-{rec.get('objective', 'burn')}-{int(now)}"
                )
            except OSError:
                continue


# -- fleet aggregation ----------------------------------------------------


def merge_quantiles(
    parts: Sequence[Tuple[float, Dict[str, float]]],
    quantiles: Sequence[Tuple[float, str]] = (
        (0.5, "p50_s"), (0.95, "p95_s"), (0.99, "p99_s")
    ),
) -> Dict[str, float]:
    """Merge per-source quantile summaries into fleet quantiles.

    Exact quantile merging needs the raw reservoirs, which never leave
    the source process — what crosses the wire is (count, p50, p95,
    p99). Each part is treated as a piecewise-linear CDF anchored at
    (0 → 0), its known quantile points, and (p99 → 1); the fleet CDF is
    the count-weighted mixture, inverted by bisection. Degenerate but
    safe at the edges: identical parts merge to themselves, disjoint
    parts land between, and the p99 of the slowest source bounds the
    result."""
    anchored = []
    total_w = 0.0
    for weight, qs in parts:
        w = float(weight)
        if w <= 0:
            continue
        pts: List[Tuple[float, float]] = [(0.0, 0.0)]
        hi = 0.0
        for q, key in quantiles:
            if key in qs:
                v = max(float(qs[key]), hi)  # enforce monotone values
                hi = v
                pts.append((v, float(q)))
        if len(pts) == 1:
            continue
        pts.append((hi, 1.0))
        anchored.append((w, pts))
        total_w += w
    if not anchored:
        return {}

    def cdf(pts: List[Tuple[float, float]], v: float) -> float:
        if v >= pts[-1][0]:
            return 1.0
        q = 0.0
        for (v0, q0), (v1, q1) in zip(pts, pts[1:]):
            if v < v0:
                break
            if v >= v1:
                q = q1
            else:
                q = q0 if v1 <= v0 else q0 + (q1 - q0) * (v - v0) / (v1 - v0)
        return q

    def mixture(v: float) -> float:
        return sum(w * cdf(pts, v) for w, pts in anchored) / total_w

    hi_all = max(pts[-1][0] for _, pts in anchored)
    out: Dict[str, float] = {}
    for q, key in quantiles:
        lo, hi = 0.0, hi_all
        for _ in range(48):
            mid = (lo + hi) / 2
            if mixture(mid) >= q:
                hi = mid
            else:
                lo = mid
        out[key] = hi
    return out


class _CounterBank:
    """Reset-safe cumulative view of one source's counters/timing sums:
    when a raw value decreases (process respawned and restarted from
    zero) the pre-reset total folds into a base so the rebased series
    stays monotone and the fleet sum never dips or spikes."""

    __slots__ = ("base", "raw")

    def __init__(self):
        self.base: Dict[str, float] = {}
        self.raw: Dict[str, float] = {}

    def update(self, vals: Dict[str, float]) -> None:
        for k, v in vals.items():
            last = self.raw.get(k)
            if last is not None and v < last:
                self.base[k] = self.base.get(k, 0.0) + last
            self.raw[k] = v

    def rebased(self) -> Dict[str, float]:
        return {
            k: self.base.get(k, 0.0) + v for k, v in self.raw.items()
        }


def fleet_series(
    samples: Iterable[dict],
) -> List[Tuple[float, Dict[str, float]]]:
    """Per-source ``ev:"sample"`` records → ONE aggregated (t, values)
    series in the ``samples_from_metrics`` shape ``slo.evaluate``
    consumes. See module docstring for the aggregation rules."""
    recs = sorted(
        (r for r in samples if r.get("ev") == "sample" and "ts" in r),
        key=lambda r: r["ts"],
    )
    counters: Dict[str, _CounterBank] = {}
    tsums: Dict[str, _CounterBank] = {}
    state: Dict[str, dict] = {}
    out: List[Tuple[float, Dict[str, float]]] = []
    i = 0
    while i < len(recs):
        t = recs[i]["ts"]
        while i < len(recs) and recs[i]["ts"] == t:
            rec = recs[i]
            name = rec["source"]
            bank = counters.setdefault(name, _CounterBank())
            bank.update(rec.get("counters", {}))
            tbank = tsums.setdefault(name, _CounterBank())
            cum = {}
            for fam, tv in rec.get("timings", {}).items():
                if "count" in tv:
                    cum[f"{fam}_count"] = float(tv["count"])
                if "sum" in tv:
                    cum[f"{fam}_sum"] = float(tv["sum"])
            tbank.update(cum)
            state[name] = rec
            i += 1
        vals: Dict[str, float] = {}
        # counters: fleet total = sum of reset-rebased per-source totals
        # (a dead source keeps contributing its last known total — work
        # already done does not vanish with the process)
        for bank in counters.values():
            for k, v in bank.rebased().items():
                vals[k] = vals.get(k, 0.0) + v
        for tbank in tsums.values():
            for k, v in tbank.rebased().items():
                vals[k] = vals.get(k, 0.0) + v
        # gauges: max is the headline (pressure reads as worst-of-fleet),
        # min/sum ride along under suffixed names; only live sources
        # vote — a frozen exposition is history, not load
        gnames = set()
        for rec in state.values():
            if rec["up"]:
                gnames.update(rec.get("gauges", {}))
        for g in gnames:
            vs = [
                rec["gauges"][g] for rec in state.values()
                if rec["up"] and g in rec.get("gauges", {})
            ]
            vals[g] = max(vs)
            vals[f"{g}_min"] = min(vs)
            vals[f"{g}_sum"] = sum(vs)
        # timing quantiles: count-weighted mixture merge over live
        # sources (sum/count already aggregated exactly above)
        fams = set()
        for rec in state.values():
            if rec["up"]:
                fams.update(rec.get("timings", {}))
        for fam in fams:
            parts = []
            for rec in state.values():
                tv = rec.get("timings", {}).get(fam)
                if rec["up"] and tv and tv.get("count", 0) > 0:
                    parts.append((float(tv["count"]), tv))
            merged = merge_quantiles(parts)
            for key, v in merged.items():
                vals[f"{fam}_{key}"] = v
            ckey = f"{fam}_count"
            if ckey in vals and vals[ckey] > 0:
                vals[f"{fam}_mean_s"] = vals.get(f"{fam}_sum", 0.0) / vals[ckey]
        # liveness rollup
        ups = {n: rec["up"] for n, rec in state.items()}
        vals["fleet_sources"] = float(len(state))
        vals["fleet_up"] = float(sum(ups.values()))
        vals["replicas_total"] = float(sum(
            1 for rec in state.values() if rec["role"] == "replica"
        ))
        vals["replicas_live"] = float(sum(
            1 for rec in state.values()
            if rec["role"] == "replica" and rec["up"]
        ))
        out.append((t, vals))
    return out


def load_collector_config(path) -> Tuple[dict, List[SourceSpec]]:
    """Flat-TOML collector config → (settings, sources). One
    ``[collector]`` table (interval_s, stale_after_s, budget_bytes,
    block_bytes, slo) plus one ``[source_<name>]`` table per target —
    the same flat subset config.py's minimal parser accepts."""
    from progen_tpu_torch.config import load_toml_config

    raw = load_toml_config(str(path))
    settings = raw.get("collector", {})
    if not isinstance(settings, dict):
        settings = {}
    sources: List[SourceSpec] = []
    for section, table in raw.items():
        if not section.startswith("source_") or not isinstance(table, dict):
            continue
        sources.append(SourceSpec(
            name=section[len("source_"):],
            role=str(table.get("role", "replica")),
            prom=str(table["prom"]) if table.get("prom") else None,
            metrics=str(table["metrics"]) if table.get("metrics") else None,
        ))
    return settings, sources


def fleet_exemplars(samples: Iterable[dict]) -> Dict[str, List[dict]]:
    """Union per-source trace exemplars into the fleet's worst-K per
    timing family. ``fleet_series`` flattens everything to floats, so
    exemplars need this parallel rollup: the latest sample per source
    contributes its exemplar list, and the fleet's worst-K is the
    worst-K of the parts' worst-Ks (same invariant as
    ``_Timing.merged`` — max is order-insensitive)."""
    from progen_tpu_torch.telemetry.registry import _Timing

    pairs: Dict[str, List[Tuple[float, str]]] = {}
    for rec in latest_by_source(samples).values():
        for fam, tv in rec.get("timings", {}).items():
            for ex in tv.get("exemplars") or []:
                try:
                    pairs.setdefault(fam, []).append(
                        (float(ex["value"]), str(ex["trace_id"]))
                    )
                except (KeyError, TypeError, ValueError):
                    continue
    return {
        fam: [
            {"value": v, "trace_id": tid}
            for v, tid in _Timing._worst_k(ps)
        ]
        for fam, ps in pairs.items()
    }


def latest_by_source(samples: Iterable[dict]) -> Dict[str, dict]:
    """Last sample per source (console's per-replica rows)."""
    out: Dict[str, dict] = {}
    for rec in samples:
        if rec.get("ev") == "sample" and "source" in rec:
            prev = out.get(rec["source"])
            if prev is None or rec.get("ts", 0) >= prev.get("ts", 0):
                out[rec["source"]] = rec
    return out

"""The harness: finds every piece of a cell by its name and turns a
traffic runner's outcome into the result line.

Nothing here knows a cell, a traffic kind or a metric. ``BENCHMARK.json``
at the root of the checkout names them; the pieces are files of their
own beside this one:

* ``configs/<config>.json``: a model configuration, its sizes as run;
* ``families/<family>.py``: what the yardstick knows of the
  configuration's architecture (its ``family`` key, ``progen`` where it
  has none): its sizes, seeded weights, kernels and their work, and its
  plain reference (``families/__init__.py``);
* ``mixes/<traffic>.toml``: a traffic mix, its ``kind`` and parameters;
* ``traffic/<kind>.py``: the runner of a kind, ``run(ctx) -> Outcome``;
* ``cells/<cell>.toml``: what belongs to one cell alone, the limits of
  its correctness numbers and the size of its traced window;
* ``metrics/<metric>.py``: the reader of one per-layer metric,
  ``read(readings) -> float | None``.

A later change adds a cell or a metric by adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
import tomllib
from pathlib import Path

from portbench import spec as specs

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "progen_tpu")
PROGRAM = "progen_tpu_torch"


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level names among the loaded modules, each
    compared whole: ``progen_tpu_torch`` is not ``progen_tpu``."""
    names = sys.modules if modules is None else modules
    top = {m.split(".")[0] for m in names}
    return sorted(top & set(FORBIDDEN))


def _load_module(path: Path, name: str):
    """The module of the file ``path``, registered as ``name`` (a
    dataclass's module has to be found by its name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    kind: str
    raw_config: dict
    family: object  # the configuration's ``families/<name>.py``
    spec: object  # its ``family.Spec``
    params: dict  # the mix's parameters
    settings: dict  # the cell's own file
    end_to_end: list  # metric entries this cell reports
    per_layer: list

    @property
    def limits(self) -> dict:
        return self.settings["limits"]

    def weights(self, seed: int, device) -> dict:
        """The configuration's seeded weights (``weights.make``), drawn
        anew."""
        from portbench import weights

        return weights.make(self.spec, seed, device, self.family.SCALES)


class Bench:
    """``BENCHMARK.json`` of a checkout and the files it names, found
    beside this module (or under ``root``, a copy of this folder)."""

    def __init__(self, checkout: Path, root: Path | None = None):
        self.checkout = Path(checkout)
        self.root = Path(root) if root is not None else HERE
        self.data = json.loads((self.checkout / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    @staticmethod
    def _applies(metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def cell(self, name: str) -> Cell:
        w = self.workload(name)
        raw = specs.load_config(self.root / "configs"
                                / f"{w['config']}.json")
        family = self.family(specs.family_name(raw))
        mix = tomllib.loads((self.root / "mixes"
                             / f"{w['traffic']}.toml").read_text())
        settings = tomllib.loads((self.root / "cells"
                                  / f"{name}.toml").read_text())
        return Cell(
            name=name, chips=int(w["chips"]), config_name=w["config"],
            traffic_name=w["traffic"], kind=mix["kind"], raw_config=raw,
            family=family, spec=family.Spec.from_dict(raw),
            params=mix.get("params", {}), settings=settings,
            end_to_end=[m for m in self.data["end_to_end"]
                        if self._applies(m, name)],
            per_layer=[m for m in self.data["per_layer"]
                       if self._applies(m, name)])

    def family(self, name: str):
        return _load_module(self.root / "families" / f"{name}.py",
                            _module_name("family", name))

    def runner(self, kind: str):
        return _load_module(self.root / "traffic" / f"{kind}.py",
                            _module_name("traffic", kind))

    def reader(self, metric: str):
        return _load_module(self.root / "metrics" / f"{metric}.py",
                            _module_name("metric", metric)).read


def _module_name(part: str, name: str) -> str:
    return f"portbench_{part}_" + name.replace(".", "_").replace("-", "_")


def process_start() -> float:
    """The time (``time.time()``) at which this process started, from
    /proc; now where /proc cannot say."""
    try:
        import os

        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


@dataclasses.dataclass
class Readings:
    """What a per-layer reader may read: the cell, the harness's spans
    (name -> seconds of each), values the runner measured, and the
    traced window's summary (or None)."""

    cell: Cell
    spans: dict
    values: dict
    trace: object = None


@dataclasses.dataclass
class Outcome:
    """What a traffic runner hands back."""

    attempted: int
    failed: int
    rates: dict  # end-to-end metric name -> value
    numbers: dict  # correctness number name -> value
    memory_peak_bytes: int
    readings: Readings | None = None
    info: dict = dataclasses.field(default_factory=dict)


class Context:
    """One run of a cell: its seed, window, trace flag and device, and
    the set-up clock. The runner calls ``window_opens`` at the instant
    its measured window starts."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, started: float | None = None,
                 variant: str = "program"):
        if variant not in ("program", "control"):
            raise ValueError(f"unknown variant {variant!r}")
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.device, self.variant = bool(trace), device, variant
        self.started = process_start() if started is None else started
        self.setup_s = None
        self.setup_marks = {}  # part of set-up -> seconds since start

    def mark(self, part: str) -> None:
        """Set-up has reached the end of ``part``."""
        self.setup_marks[part] = time.time() - self.started

    def window_opens(self) -> None:
        self.setup_s = time.time() - self.started


def per_layer_values(cell: Cell, readings: Readings, bench: Bench) -> dict:
    """name -> {"value", "unit"} of each per-layer metric whose reader
    found something to read."""
    out = {}
    for m in cell.per_layer:
        value = bench.reader(m["name"])(readings)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result(cell: Cell, ctx: Context, outcome: Outcome, bench: Bench,
           device_info: dict, correct: bool, checks: list) -> dict:
    """The result line's object."""
    if ctx.trace:
        metrics = per_layer_values(cell, outcome.readings, bench)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {name: {"value": float(v), "unit": units[name]}
                   for name, v in outcome.rates.items() if name in units}
        metrics["setup_s"] = {"value": float(ctx.setup_s),
                              "unit": units["setup_s"]}
    out = {"correct": bool(correct), "attempted": int(outcome.attempted),
           "failed": int(outcome.failed), "metrics": metrics,
           "device": dict(device_info,
                          memory_peak_bytes=int(outcome.memory_peak_bytes))}
    summary = outcome.readings.trace if outcome.readings else None
    if ctx.trace and summary is not None:
        out["device"]["busy_s"] = summary.busy_s
        out["device"]["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": summary.device_ops,
                            "idle_gaps": summary.idle_gaps}
    out["info"] = outcome.info
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    return out


def release() -> None:
    """Return freed device memory to the card, so that what runs after
    the window finds it."""
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def device_info(device) -> dict:
    import torch

    return {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": 1}


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def written_bytes() -> int | None:
    """Bytes this process has had written to storage (/proc/self/io)."""
    try:
        for line in Path("/proc/self/io").read_text().splitlines():
            if line.startswith("write_bytes:"):
                return int(line.split()[1])
    except (OSError, ValueError):
        pass
    return None


def build_program(device) -> None:
    """Build (or load, when built) the program's CUDA kernels: set-up."""
    if device.type != "cuda":
        return
    import torch

    torch.cuda.init()
    torch.cuda.set_device(device)
    from progen_tpu_torch.ops import _build

    for name in _build.build_all():
        _build.load(name)


def execute(bench: Bench, cell: Cell, seed: int, seconds: float,
            trace: bool, device, started: float | None = None,
            variant: str = "program"):
    """One run of ``cell`` on ``device``: (context, outcome, checks,
    correct). The program's kernels are built in set-up."""
    ctx = Context(cell, seed, seconds, trace, device, started, variant)
    ctx.mark("imports")
    build_program(device)
    ctx.mark("kernels")
    outcome = bench.runner(cell.kind).run(ctx)
    from portbench import compare

    rows = compare.checks(outcome.numbers, cell.limits)
    return ctx, outcome, rows, compare.passed(rows)


def kernel_shares(cell: Cell, readings: Readings) -> dict:
    """Kernel id -> percent of its roofline in the traced window."""
    from portbench import counts

    passes = readings.values.get("traced_passes")
    if not passes:
        return {}
    work = counts.traced_work(cell.family, cell.spec, passes)
    return {rid: 100.0 * work[rid] / 1e3 / s
            for rid, s in readings.trace.kernel_s.items()
            if rid in work and s > 0}


def run_and_report(bench: Bench, cell: Cell, seed: int, seconds: float,
                   trace: bool, device, started: float) -> int:
    """``execute``, then the result line; 5 without one when a forbidden
    module is loaded once the window has closed."""
    ctx, outcome, rows, ok = execute(bench, cell, seed, seconds, trace,
                                     device, started)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}",
              file=sys.stderr, flush=True)
        return 5
    outcome.info["setup_marks"] = ctx.setup_marks
    outcome.info["power_limit"] = power_limit()
    outcome.info["written_bytes"] = written_bytes()
    line = result(cell, ctx, outcome, bench, device_info(device), ok, rows)
    readings = outcome.readings
    if readings is not None and readings.trace is not None:
        print(json.dumps({"kernel_seconds": readings.trace.kernel_s,
                          "kernel_roofline_pct": kernel_shares(
                              cell, readings),
                          "traced_passes":
                          readings.values.get("traced_passes"),
                          "device_s": readings.trace.device_s,
                          "trace_events": readings.trace.kinds}),
              flush=True)
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

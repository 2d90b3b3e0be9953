"""The port stands alone: it imports neither JAX nor flax nor anything of
the JAX package ``progen_tpu``, and neither does ``chip_smoke.py``. Nor
does it import the packages the card's machine lacks (click, safetensors,
tqdm, jinja2, tensorflow, prefect). ``wandb`` is imported only where it
is installed: every module imports with it blocked too."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "progen_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "progen_tpu",
             "click", "safetensors", "tqdm", "jinja2", "tensorflow",
             "prefect")
GUARDED = ("wandb",)  # imported inside try only


def _modules():
    names = ["progen_tpu_torch"]
    for info in pkgutil.walk_packages([str(PACKAGE)], "progen_tpu_torch."):
        names.append(info.name)
    return names


def test_every_module_imports_with_jax_blocked():
    blocked = ", ".join(repr(n) for n in FORBIDDEN + GUARDED)
    code = f"""
import importlib, sys
for name in ({blocked},):
    sys.modules[name] = None  # any import of it now raises ImportError
for name in {_modules()!r}:
    importlib.import_module(name)
loaded = [m for m in sys.modules
          if m.split(".")[0] in ({blocked},) and sys.modules[m] is not None]
assert not loaded, loaded
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_package_has_the_slice_modules():
    names = set(_modules())
    for mod in ("config", "convert", "sampling", "data.tokenizer",
                "ops.rotary", "ops.shift", "ops.attention", "ops.sgu",
                "ops.cuda_layers", "ops.cuda_attention", "ops._build",
                "models.layers", "models.progen", "training.loss",
                "training.optimizer", "training.state", "training.step",
                "workloads.scoring", "parallel", "parallel.groups",
                "parallel.collectives", "parallel.ring_attention",
                "data._native", "data.tfrecord", "data.dataset",
                "data.fasta", "checkpoint", "tracking", "cli",
                "cli.generate_data", "cli.train", "cli.eval",
                "cli.sample", "serving", "serving.engine",
                "serving.scheduler", "serving.journal",
                "serving.prefix_cache", "serving.metrics",
                "telemetry.registry", "telemetry.spans", "telemetry.trace",
                "workloads.infill", "workloads.embeddings", "cli.serve",
                "workloads", "workloads.mutagenesis", "resilience",
                "resilience.chaos", "resilience.retry", "ops.quant",
                "cli.batch_score", "cli.scan", "cli.convert",
                "parallel.tensor", "parallel.partition",
                "parallel.pipeline", "parallel.pipeline_1f1b",
                "telemetry", "telemetry.prometheus", "telemetry.hbm",
                "telemetry.goodput", "telemetry.watchdog",
                "resilience.anomaly", "profiling", "utils", "utils.env",
                "fleet", "fleet.transport", "serving.reload",
                "serving.router", "cli.router", "telemetry.trace",
                "telemetry.stitch", "telemetry.slo",
                "telemetry.remote_write", "telemetry.tsdb",
                "telemetry.alerts", "telemetry.alert_router",
                "telemetry.collector", "telemetry.console",
                "telemetry.flight", "fleet.autoscaler", "cli.telemetry",
                "cli.collector", "cli.top", "training", "deploy",
                "deploy.ledger", "deploy.controller", "cli.deploy",
                "analysis", "analysis.core", "analysis.event_grammar",
                "analysis.project", "analysis.registry", "analysis.runner",
                "analysis.rules_telemetry", "analysis.rules_durability",
                "analysis.rules_locks", "analysis.rules_chaos",
                "analysis.rules_grammar_consumers", "cli.lint"):
        assert f"progen_tpu_torch.{mod}" in names


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize(
    "path",
    sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_forbidden_import_in_source(path):
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path}: {bad}"

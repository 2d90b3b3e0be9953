"""Nothing of the benchmark imports JAX, flax or the JAX package, with
top-level names compared whole, and the reference imports nothing of
the program."""

import ast
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.tiny import CHECKOUT

ROOT = CHECKOUT / "portbench"


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(ROOT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    assert not set(imported_tops(path)) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = set(imported_tops(path))
    assert harness.PROGRAM not in tops
    assert tops <= {"__future__", "contextlib", "dataclasses", "numpy",
                    "torch", "portbench"}


def test_names_are_compared_whole():
    assert harness.loaded_forbidden(["progen_tpu_torch.models",
                                     "jaxtyping", "flaxen"]) == []
    assert harness.loaded_forbidden(["progen_tpu.models", "jax.numpy",
                                     "flax"]) == ["flax", "jax",
                                                  "progen_tpu"]


def test_a_run_loads_no_forbidden_module():
    """Everything a run imports, in a fresh interpreter."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import harness, faults, calibrate\n"
            "import portbench.traffic.train_closed\n"
            "import portbench.traffic.score_library\n"
            "import portbench.families.progen\n"
            "import progen_tpu_torch.training.step\n"
            "import progen_tpu_torch.workloads.scoring\n"
            "import progen_tpu_torch.ops.launches\n"
            "print(harness.loaded_forbidden())" % str(CHECKOUT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"

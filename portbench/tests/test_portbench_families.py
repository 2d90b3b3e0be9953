"""ProGen's family as the benchmark had it before families were files
of their own, and the rule that binds every family's kernel table."""

import dataclasses
import hashlib
from pathlib import Path

import pytest
import torch

from portbench import counts, harness, spec as specs, weights
from portbench.families import progen
from portbench.tests.tiny import CHECKOUT, CPU, TINY

FAMILIES = CHECKOUT / "portbench" / "families"


def ids_by_name(folder: Path) -> dict:
    """Profiler kernel name -> its id, over every family file in
    ``folder``; raises where two families give one name two ids."""
    bench = harness.Bench(CHECKOUT, folder.parent)
    found = {}
    for path in sorted(folder.glob("*.py")):
        if path.stem == "__init__":
            continue
        for rid, names in bench.family(path.stem).KERNEL_NAMES.items():
            for name in names:
                if found.setdefault(name, rid) != rid:
                    raise ValueError(f"{name} is {found[name]} in one "
                                     f"family and {rid} in {path.name}")
    return found


def test_a_kernel_name_has_one_id_in_every_family():
    assert ids_by_name(FAMILIES) == {
        n: rid for rid, names in progen.KERNEL_NAMES.items() for n in names}


@pytest.mark.parametrize("cell", ["train-base-4x4", "train-large-4x4",
                                  "score-base-b32"])
def test_the_configurations_are_progens_without_a_family_key(cell):
    bench = harness.Bench(CHECKOUT)
    c = bench.cell(cell)
    assert "family" not in c.raw_config
    assert specs.family_name(c.raw_config) == "progen"
    assert Path(c.family.__file__) == FAMILIES / "progen.py"
    assert dataclasses.asdict(c.spec) == dataclasses.asdict(
        progen.Spec.from_dict(c.raw_config))
    assert specs.program_dict(dict(c.raw_config, family="progen")) == \
        specs.program_dict(c.raw_config)


# sha256 over each parameter's name and float32 bytes, in order, as the
# benchmark drew them before families were files of their own
DRAWN = {2**31 + 5: "7e37dc8ae515450c48ac555ccf82c867"
                    "96acb21c0aa6fd8596e7a2015f2c25ac",
         7: "f91365586a48a3d25c894c46cd347ed7"
            "5b6bf9d1160b62fe0568cdd3edf17739"}


@pytest.mark.parametrize("seed", sorted(DRAWN))
def test_the_seeded_weights_are_drawn_as_before(seed):
    drawn = weights.make(progen.Spec.from_dict(TINY), seed, CPU,
                         progen.SCALES)
    h = hashlib.sha256()
    for name, t in drawn.items():
        h.update(name.encode())
        h.update(t.contiguous().numpy().tobytes())
    assert len(drawn) == 27 and h.hexdigest() == DRAWN[seed]


def test_the_family_file_draws_what_its_spec_names():
    spec = progen.Spec.from_dict(TINY)
    drawn = weights.make(spec, 3, CPU, progen.SCALES)
    assert [(n, tuple(t.shape)) for n, t in drawn.items()] == [
        (n, s) for n, s, _ in spec.parameter_shapes()]
    assert all(t.dtype == torch.float32 for t in drawn.values())
    assert counts.ESIZE[spec.dtype] == 2

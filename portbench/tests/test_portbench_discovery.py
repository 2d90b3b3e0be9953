"""The harness finds a cell, its mix, its configuration and a metric by
name alone: a new one needs only new files and entries."""

import json
import math
import shutil
import tomllib
from pathlib import Path

import pytest
import torch

from portbench import harness, trace, weights
from portbench.tests import test_portbench_families, tiny
from portbench.tests.tiny import CHECKOUT, TINY


def copy_of_portbench(tmp_path) -> tuple:
    """A copy of ``portbench/`` under ``tmp_path``, ``BENCHMARK.json``'s
    object and every file's bytes as copied."""
    root = tmp_path / "portbench"
    shutil.copytree(CHECKOUT / "portbench", root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    before = {p.relative_to(root): p.read_bytes()
              for p in root.rglob("*") if p.is_file()}
    return root, data, before


def unchanged(root: Path, before: dict) -> bool:
    return all((root / rel).read_bytes() == body
               for rel, body in before.items())


def test_new_cell_and_metric_are_found_from_files_alone(tmp_path):
    root, data, before = copy_of_portbench(tmp_path)

    (root / "configs" / "tiny.json").write_text(json.dumps(
        dict(TINY, name="tiny", reduced=[])))
    (root / "mixes" / "closed-1x2.toml").write_text(
        'kind = "train_closed"\n[params]\ngrad_accum = 1\n'
        'micro_batch = 2\nmin_residues = 10\nmax_residues = 60\n')
    (root / "cells" / "train-tiny-1x2.toml").write_text(
        "reference_rows = 1\n[limits]\nloss_gap = 0.5\n")
    (root / "metrics" / "steps.train.py").write_text(
        "def read(r):\n    return len(r.spans.get('train_step', []))\n")
    data["configs"].append({"name": "tiny", "source": "x",
                            "file": "portbench/configs/tiny.json",
                            "reduced": [], "why": "x"})
    data["workloads"].append({"name": "train-tiny-1x2", "config": "tiny",
                              "traffic": "closed-1x2", "chips": 1,
                              "why": "x"})
    data["end_to_end"][0]["workloads"].append("train-tiny-1x2")
    data["per_layer"].append({"name": "steps.train", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "training step",
                              "moves": "train_tokens_per_s",
                              "workloads": ["train-tiny-1x2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))

    bench = harness.Bench(tmp_path, root)
    cell = bench.cell("train-tiny-1x2")
    assert cell.kind == "train_closed" and cell.spec.dim == TINY["dim"]
    assert cell.params["grad_accum"] == 1
    assert cell.limits == {"loss_gap": 0.5}
    assert [m["name"] for m in cell.end_to_end] == [
        "train_tokens_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["steps.train"]
    readings = harness.Readings(cell=cell, spans={"train_step": [1, 2]},
                                values={})
    assert harness.per_layer_values(cell, readings, bench) == {
        "steps.train": {"value": 2.0, "unit": "steps"}}
    assert bench.runner(cell.kind).run is not None
    assert unchanged(root, before)


def add_toy(root: Path, data: dict) -> None:
    """The files and entries of a cell of the toy family
    (``toy_family.py``): its family, configuration, mix and cell, the
    cell joining the training metrics by their ``workloads`` lists."""
    shutil.copy(Path(__file__).with_name("toy_family.py"),
                root / "families" / "toy.py")
    (root / "configs" / "toy.json").write_text(json.dumps(dict(
        name="toy", family="toy", num_tokens=256, dim=32, heads=2,
        dim_head=16, seq_len=64, experts=4, layer_types=["dense", "moe"],
        remat=False, dtype="float32", reduced=["experts"],
        assumed=["dim", "heads"])))
    closed = tomllib.loads((root / "mixes" / "closed-4x4.toml").read_text())
    residues = closed["params"]["residues"]
    percent = ", ".join(map(str, closed["params"]["residue_percent"]))
    (root / "mixes" / "closed-toy.toml").write_text(
        'kind = "train_closed"\n[params]\ngrad_accum = 2\n'
        'micro_batch = 2\nlength_median = 30\nlength_sigma = 0.62\n'
        'min_residues = 8\nmax_residues = 62\n'
        f'residues = "{residues}"\nresidue_percent = [{percent}]\n'
        'first_steps = 3\n')
    (root / "cells" / "train-toy.toml").write_text(
        "reference_rows = 2\nprofile_steps = 1\n[limits]\n"
        "loss_gap = 1e-4\ngrad_gap = 1e-3\nchange_gap = 1e-3\n")
    data["configs"].append({"name": "toy", "source": "x",
                            "file": "portbench/configs/toy.json",
                            "reduced": ["experts"], "why": "x"})
    data["workloads"].append({"name": "train-toy", "config": "toy",
                              "traffic": "closed-toy", "chips": 1,
                              "why": "x"})
    for group, name in (("end_to_end", "train_tokens_per_s"),
                        ("per_layer", "mfu.train"),
                        ("per_layer", "kernels_roofline.train")):
        (metric,) = [m for m in data[group] if m["name"] == name]
        metric["workloads"].append("train-toy")


def marked(events: list) -> list:
    """``events`` between the two marker kernels of a traced span."""
    return ([trace.Event(trace.MARK, "kernel", -10, 0, 7),
             trace.Event(trace.MARK, "kernel", 10**6, 10**6 + 10, 7)]
            + events)


def test_a_family_of_another_architecture_joins_by_files_alone(
        tmp_path, monkeypatch):
    """A configuration whose ``family`` is not ``progen`` is loaded,
    drawn, counted, traced, reported and checked for ``correct`` by the
    files it brings."""
    from progen_tpu_torch.telemetry import spans

    root, data, before = copy_of_portbench(tmp_path)
    add_toy(root, data)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    bench = harness.Bench(tmp_path, root)
    cell = bench.cell("train-toy")
    family, spec = cell.family, cell.spec
    assert Path(family.__file__) == root / "families" / "toy.py"
    assert spec.layer_types == ("dense", "moe")
    assert {m["name"] for m in cell.per_layer} == {"mfu.train",
                                                   "kernels_roofline.train"}

    # drawn: every parameter by its own kind's scale, a router among them
    shapes = spec.parameter_shapes()
    assert "router" in {kind for _, _, kind in shapes}
    got = weights.make(spec, 2**31 + 3, tiny.CPU, family.SCALES)
    flat = torch.randn(sum(math.prod(s) for _, s, _ in shapes),
                       generator=torch.Generator().manual_seed(2**31 + 3))
    at = 0
    for name, shape, kind in shapes:
        scale, shift = family.SCALES[kind]
        want = flat[at:at + math.prod(shape)].view(shape) * scale(shape, spec)
        assert torch.equal(got[name], want + shift if shift else want), name
        at += math.prod(shape)

    # traced: the toy's kernel gets its own id, which ProGen's table lacks
    events = marked([
        trace.Event("void toy_router_kernel<float>(float const*)", "kernel",
                    100, 400_100, 7),
        trace.Event("void (anonymous namespace)::fwd_tc_kernel<"
                    "__nv_bfloat16, 64>(int)", "kernel", 500_000, 600_000,
                    7)])
    summary = trace.reduce(events, family.KERNEL_NAMES)
    assert summary.kernel_s == {"X1": pytest.approx(400e-6)}
    assert trace.reduce(events).kernel_s == {"A1": pytest.approx(100e-6)}

    # counted: the readers take the toy's FLOPs and kernels' work
    passes = dict(rows=2, forwards=2, backwards=2)
    readings = harness.Readings(
        cell=cell, spans={}, trace=summary,
        values={"tokens_per_s": 1000.0, "traced_passes": passes,
                "device_name": "NVIDIA H100 80GB HBM3"})
    read = harness.per_layer_values(cell, readings, bench)
    assert read["mfu.train"]["value"] == pytest.approx(
        100 * family.flops_per_token(spec) * 1000.0 / 989e12)
    work = family.work_ms(spec, 2, forwards=2, backwards=2)
    assert set(work) == {"X1"}
    assert read["kernels_roofline.train"]["value"] == pytest.approx(
        100 * work["X1"] / 1e3 / 400e-6)

    # run, reported and checked: the program's train step on the toy
    monkeypatch.setattr(spans, "_GLOBAL", spans.Telemetry())
    ctx, outcome, rows, ok = harness.execute(bench, cell, 2**31 + 9, 0.3,
                                             True, tiny.CPU)
    line = harness.result(cell, ctx, outcome, bench,
                          harness.device_info(tiny.CPU), ok, rows)
    assert ok and line["correct"], rows
    assert outcome.attempted > 0 and outcome.rates["train_tokens_per_s"] > 0
    assert outcome.readings.values["traced_passes"] == passes
    _, _, rows, ok = harness.execute(bench, cell, 2**31 + 9, 0.3, False,
                                     tiny.CPU, variant="control")
    assert not ok, rows
    assert test_portbench_families.ids_by_name(root / "families")
    assert unchanged(root, before)


def test_every_cell_of_the_benchmark_is_whole():
    bench = harness.Bench(CHECKOUT)
    for w in bench.data["workloads"]:
        cell = bench.cell(w["name"])
        assert bench.runner(cell.kind).run
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert bench.reader(m["name"])
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
        assert cell.limits


def test_a_reader_that_finds_nothing_leaves_its_metric_out():
    bench = harness.Bench(CHECKOUT)
    cell = bench.cell("train-base-4x4")
    readings = harness.Readings(cell=cell, spans={}, values={})
    assert harness.per_layer_values(cell, readings, bench) == {}

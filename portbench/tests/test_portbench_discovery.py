"""The harness finds a cell, its mix, its configuration and a metric by
name alone: a new one needs only new files and entries."""

import json
import shutil

from portbench import harness
from portbench.tests.tiny import CHECKOUT, TINY


def test_new_cell_and_metric_are_found_from_files_alone(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(CHECKOUT / "portbench", root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    before = {p.relative_to(root): p.read_bytes()
              for p in root.rglob("*") if p.is_file()}

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
    # nothing that was there changed
    assert all((root / rel).read_bytes() == body
               for rel, body in before.items())


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

"""``run.py`` without a card, or without the program, fails and prints
no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.tests.tiny import CHECKOUT


def run(cwd, *extra, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "train-base-4x4", "--seed", str(2**31 + 11), "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=120, env=env)


def no_result(proc):
    for line in proc.stdout.splitlines():
        try:
            if "correct" in json.loads(line):
                return False
        except (ValueError, TypeError):
            continue
    return True


def test_without_a_card_it_fails(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = run(CHECKOUT, env=env)
    assert proc.returncode != 0 and no_result(proc)
    assert "no CUDA device" in proc.stderr


def test_with_only_the_benchmarks_files_it_fails(tmp_path):
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(CHECKOUT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = run(tmp_path, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and no_result(proc)
    assert "is not in this checkout" in proc.stderr


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "score-base-b32", "--seed", str(2**31 + 13), "--seconds", "2",
         "--trace", "0"], cwd=CHECKOUT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"

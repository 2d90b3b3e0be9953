"""Subprocess kill matrix of the port's ``cli.train`` (``python -m
progen_tpu_torch.cli.train --device cpu``): SIGKILL a real run at
injected points (``PROGEN_CHAOS`` ``kill@N`` rules), resume it, and hold
the two crash-consistency invariants of ``tests/test_chaos_matrix.py``:

  1. the store is always restorable — a kill at any point leaves either
     no complete checkpoint or a complete, verifiable one;
  2. ``next_seq_index`` never regresses across a crash and resume.

The two deterministic cases of the JAX package's matrix run in tier 1;
its randomized sweep over six kill points is ``slow``. The workspace is
that matrix's (``tests/torch_workspace.py``).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from progen_tpu_torch.checkpoint import get_checkpoint_fns
from torch_workspace import make_workspace

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return make_workspace(tmp_path_factory.mktemp("torch_chaos_matrix"))


def _run_train(workspace, ckpt_dir, steps, chaos="", extra=()):
    env = dict(os.environ, PROGEN_CHAOS=chaos,
               PYTHONPATH=f"{REPO}{os.pathsep}"
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.run(
        [sys.executable, "-m", "progen_tpu_torch.cli.train",
         "--device", "cpu", "--wandb_off", "--batch_size", "4",
         "--grad_accum_every", "1", "--num_steps", str(steps),
         "--validate_every", "1000", "--sample_every", "1000",
         "--checkpoint_every", "2", "--seq_len", "32",
         "--config_path", str(workspace / "configs" / "model"),
         "--data_path", str(workspace / "train_data"),
         "--checkpoint_path", str(ckpt_dir), *extra],
        env=env, cwd=str(workspace), capture_output=True, text=True,
        timeout=240)


def _peek(ckpt_dir):
    """The restorability probe: the walk never raises; a crash may leave
    nothing, never something broken but trusted."""
    return get_checkpoint_fns(str(ckpt_dir))[1].peek()


class TestDeterministicKills:
    def test_kill_during_meta_write_leaves_no_complete_ckpt(
            self, workspace, tmp_path):
        """Die between the array files and the meta.json: the orphaned
        directory is invisible to restore, and a chaos-free resume starts
        clean and finishes."""
        ck = tmp_path / "ck"
        res = _run_train(workspace, ck, 4, chaos="ckpt/io/meta_write:kill")
        assert res.returncode == -9, res.stderr[-2000:]
        dirs = [p for p in ck.iterdir() if p.name.startswith("ckpt_")]
        assert dirs and not (dirs[0] / "meta.json").exists()
        assert (dirs[0] / "params.pt").exists()  # the arrays landed
        assert _peek(ck) is None  # incomplete == invisible

        res = _run_train(workspace, ck, 4)
        assert res.returncode == 0, res.stderr[-2000:]
        pkg = _peek(ck)
        assert pkg is not None and pkg.next_seq_index == 16  # 4 steps x 4

    def test_kill_mid_second_save_resumes_from_first(self, workspace,
                                                     tmp_path):
        """Die entering the second save: the first (complete) checkpoint
        survives, the resume starts from its cursor, and the cursor never
        regresses."""
        ck = tmp_path / "ck"
        res = _run_train(workspace, ck, 8, chaos="ckpt/save:kill@2")
        assert res.returncode == -9, res.stderr[-2000:]
        pkg = _peek(ck)
        assert pkg is not None and pkg.next_seq_index == 4  # saved at i = 0
        before = pkg.next_seq_index

        res = _run_train(workspace, ck, 4)
        assert res.returncode == 0, res.stderr[-2000:]
        after = _peek(ck).next_seq_index
        assert after >= before  # monotone across crash and resume
        assert after == before + 4 * 4


@pytest.mark.slow
class TestRandomizedKillMatrix:
    """The sweep over the span and retry-site timeline: kill, check the
    store restorable, resume chaos-free, check the cursor moved
    monotonically and the run finished."""

    CASES = [
        "ckpt/io/save:kill",
        "ckpt/io/meta_write:kill@2",
        "ckpt/save:kill@3",
        "train/ckpt:kill@2",
        "data/read:kill@2",
        "train/eval:kill",
    ]

    @pytest.mark.parametrize("chaos", CASES)
    def test_kill_resume_invariants(self, workspace, tmp_path, chaos):
        ck = tmp_path / "ck"
        res = _run_train(workspace, ck, 10, chaos=chaos,
                         extra=("--validate_every", "3"))
        # a kill point may fall after the run's work (the spec hits fewer
        # times than @N): a clean exit is a valid outcome
        assert res.returncode in (-9, 0), res.stderr[-2000:]
        pkg = _peek(ck)  # must not raise, may be None
        before = pkg.next_seq_index if pkg is not None else 0

        res = _run_train(workspace, ck, 4)
        assert res.returncode == 0, res.stderr[-2000:]
        pkg = _peek(ck)
        assert pkg is not None and pkg.next_seq_index >= before

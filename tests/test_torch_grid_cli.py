"""The multi-process bootstrap and the grid flags of the port's
``cli.train``, on the CPU. Imports no jax.

* ``initialize_distributed``: the cases of the JAX package's matrix that
  apply (``tests/test_partition.py:169-200``): an explicit environment
  joins, a failed join raises rather than run as independent jobs, and
  a single process does nothing. Its TPU-only cases have no counterpart.
* Two gloo ranks run ``cli.train --mesh_model 2`` for 2 steps with a
  checkpoint (``tests/torch_grid_worker.py``); the single-process CLI
  resumes it. Their losses against one process's 3-step run to 1e-5
  relative and the checkpoint's parameters against that run's after 2
  steps to 2e-5 absolute (the tolerances of ``make_train_step(grid)``
  against one process).
* Each pipeline flag combination the JAX CLI rejects is rejected with
  its text (``tests/test_cli.py:229,272``), and each grid flag in one
  process is either accepted or refused as the JAX CLI would on one
  device.
"""

import types

import pytest
import torch
import torch.distributed as dist

from progen_tpu_torch.checkpoint import get_checkpoint_fns
from progen_tpu_torch.cli import train as ttrain
from progen_tpu_torch.parallel import groups
from torch_grid_worker import spawn
from torch_workspace import TOML, make_workspace, train_args

RANK_TIMEOUT = 180
PIPE_TOML = TOML.replace("depth = 2", "depth = 3") + "scan_layers = true\n"


@pytest.fixture
def fake_join(monkeypatch):
    calls = []

    def join(behaviour):
        def init(backend, **kw):
            calls.append((backend, kw))
            if behaviour == "raise":
                raise RuntimeError("connection refused")

        monkeypatch.setattr(dist, "init_process_group", init)
        monkeypatch.setattr(dist, "is_initialized", lambda: False)
        return calls

    return join


def test_explicit_env_joins(fake_join, monkeypatch):
    calls = fake_join("ok")
    monkeypatch.setenv("WORLD_SIZE", "2")
    groups.initialize_distributed("gloo")
    assert calls == [("gloo", {"init_method": "env://"})]


def test_failed_join_is_loud(fake_join, monkeypatch):
    fake_join("raise")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match="4 independent single-process"):
        groups.initialize_distributed("gloo")


@pytest.mark.parametrize("world", [None, "1"], ids=["unset", "one"])
def test_single_process_does_nothing(fake_join, monkeypatch, world):
    calls = fake_join("ok")
    if world is None:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("WORLD_SIZE", world)
    groups.initialize_distributed()
    assert calls == []
    assert groups.is_coordinator()


def test_joined_already_does_nothing(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: pytest.fail("joined twice"))
    monkeypatch.setenv("WORLD_SIZE", "2")
    groups.initialize_distributed()


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = make_workspace(tmp_path_factory.mktemp("grid_cli"))
    (root / "configs" / "model" / "pipe.toml").write_text(PIPE_TOML)
    return root


def test_two_ranks_checkpoint_and_one_process_resumes(ws):
    args = train_args(ws, "ck_grid", "--num_steps", "2", "--mesh_model",
                      "2", "--dist_backend", "gloo", "--validate_every",
                      "1")
    ranks = spawn(2, "cli_train", ws, RANK_TIMEOUT, args)
    resumed = ttrain.run(train_args(ws, "ck_grid", "--num_steps", "1"))
    one = ttrain.run(train_args(ws, "ck_one", "--num_steps", "3",
                                "--checkpoint_every", "1"))
    assert resumed["start_seq_index"] == ranks[0]["next_seq_index"] == 16
    assert resumed["state"].step == 3
    for r in ranks:
        assert [s["step"] for s in r["steps"]] == [1, 2]
        for got, want in zip(r["steps"], one["steps"]):
            assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert len(r["valid_losses"]) == 2
    # only the coordinator samples
    assert len(ranks[0]["samples"]) == 1 and ranks[1]["samples"] == []
    assert resumed["steps"][0]["loss"] == pytest.approx(
        one["steps"][2]["loss"], rel=1e-5)
    # the coordinator's checkpoint against one process's after 2 steps
    grid_ck = get_checkpoint_fns(str(ws / "ck_grid"))[1]
    one_ck = get_checkpoint_fns(str(ws / "ck_one"))[1]
    got = grid_ck.restore_params(ranks[0]["saves"][-1]["path"]).state
    want = one_ck.restore_params(one["saves"][1]["path"]).state
    assert one["saves"][1]["path"] != one["saves"][-1]["path"]
    for name, t in want.items():
        torch.testing.assert_close(got[name], t, atol=2e-5, rtol=0)


def test_pipeline_1f1b_with_data_and_zero1_through_the_cli(ws):
    """``--mesh_pipe 2 --mesh_data 2 --pipe_schedule 1f1b --zero1`` on four
    ranks (the JAX CLI's ``test_pipeline_cli_1f1b``): every rank trains
    and its losses equal one process's on the same records (1e-5
    relative)."""
    flags = ("--num_steps", "2", "--model_name", "pipe", "--validate_every",
             "1")
    ranks = spawn(4, "cli_train", ws, RANK_TIMEOUT, train_args(
        ws, "ck_pipe", *flags, "--mesh_pipe", "2", "--mesh_data", "2",
        "--pipe_microbatches", "2", "--pipe_schedule", "1f1b", "--zero1",
        "--dist_backend", "gloo"))
    one = ttrain.run(train_args(ws, "ck_pipe_one", *flags))
    for r in ranks:
        assert len(r["steps"]) == 2 and len(r["valid_losses"]) == 2
        for got, want in zip(r["steps"] + r["valid_losses"],
                             one["steps"] + one["valid_losses"]):
            assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)


def _refused(ws, capsys, ck, *flags, grid=None, monkeypatch=None):
    if grid is not None:
        monkeypatch.setattr(ttrain, "make_grid", lambda *a: grid)
    with pytest.raises(SystemExit) as exc:
        ttrain.run(train_args(ws, ck, *flags))
    assert exc.value.code == 2
    return capsys.readouterr().err


FAKE = {"data1": types.SimpleNamespace(data=1, seq=1, model=2),
        "data2": types.SimpleNamespace(data=2, seq=1, model=2)}
PIPE_REFUSALS = [
    ("mutually exclusive", None, ["--mesh_pipe", "2", "--mesh_model", "2"]),
    ("separate deployment paths", None, ["--mesh_pipe", "2", "--ring_attn"]),
    ("needs scan_layers=true", "data1", ["--mesh_pipe", "2"]),
    ("2 uniform layers not divisible by 4 pipeline stages", "data1",
     ["--mesh_pipe", "4", "--model_name", "pipe"]),
    ("--batch_size 4 not divisible by 3 pipeline microbatches", "data1",
     ["--mesh_pipe", "2", "--pipe_microbatches", "3", "--model_name",
      "pipe"]),
    ("PPxDP", "data2", ["--mesh_pipe", "2", "--pipe_microbatches", "4",
                        "--model_name", "pipe"]),
]


@pytest.mark.parametrize("text,grid,flags", PIPE_REFUSALS,
                         ids=[c[0].split()[0] for c in PIPE_REFUSALS])
def test_pipeline_flags_refused_as_jax_does(ws, capsys, monkeypatch, text,
                                            grid, flags):
    err = _refused(ws, capsys, "ck_pipe_refused", *flags,
                   grid=FAKE.get(grid), monkeypatch=monkeypatch)
    assert text in err
    assert not (ws / "ck_pipe_refused").exists()


GRID_FLAGS = [
    (["--data_parallel"], None), (["--zero1"], None),
    (["--pipe_microbatches", "2"], None), (["--pipe_schedule", "1f1b"], None),
    (["--mesh_data", "2"], "needs 2 > 1 devices"),
    (["--mesh_seq", "2"], "not divisible by seq*model=2"),
    (["--mesh_model", "2"], "not divisible by seq*model=2"),
    (["--ring_attn"], "--ring_attn needs a sequence-parallel mesh"),
    (["--mesh_pipe", "2"], "not divisible by seq*model=2"),
]


@pytest.mark.parametrize("flags,refusal", GRID_FLAGS,
                         ids=[f[0][0] for f in GRID_FLAGS])
def test_grid_flag_in_one_process(ws, capsys, flags, refusal):
    """One process is a grid of one: flags that ask for more ranks are
    refused as the JAX CLI refuses a mesh larger than its devices; the
    others train."""
    if refusal is None:
        res = ttrain.run(train_args(ws, "ck_flag" + flags[0], "--num_steps",
                                    "1", *flags))
        assert res["steps"][0]["skipped"] == 0
    else:
        assert refusal in _refused(ws, capsys, "ck_flags_refused", *flags)

"""The port's checkpoints (``progen_tpu_torch/checkpoint.py``) on the CPU:
a bit-equal round trip of every parameter, moment, count and step in
float32 and bfloat16; ``keep_last_n``; the integrity walk that
quarantines a corrupted checkpoint and falls back; a torn write skipped;
``reset``; and an orbax checkpoint refused.

Then the importer of JAX checkpoints (``tests/torch_jax_ckpt.py``): the
JAX CLI (``progen_tpu.cli.train``, float32) trains one step and saves;
both CLIs resume from that one checkpoint (the original and its import)
for 3 more steps on the same data. Held, by the tolerances of
``tests/test_torch_train.py``: the per-step losses to 1e-5 relative
(float32 sums in another order), the final parameters to 1e-5 absolute
(that file's reasons: an Adam update of a near-zero gradient), and the two
eval CLIs' losses to 1e-5 relative.
"""

import json
import math
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from progen_tpu_torch.checkpoint import (
    CORRUPT_SUFFIX,
    Package,
    get_checkpoint_fns,
)
from progen_tpu_torch.config import ProGenConfig
from progen_tpu_torch.training.optimizer import OptimizerConfig
from progen_tpu_torch.training.step import init_train_state, make_train_step
from torch_jax_ckpt import import_jax_checkpoint
from torch_workspace import make_workspace, train_args

CFG = dict(num_tokens=32, dim=32, seq_len=16, depth=2, window_size=8,
           global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2,
           dtype="float32")
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5


def trained_state(param_dtype="float32", seed=0):
    """A tiny state after one step, so the moments and count are set."""
    cfg = ProGenConfig(**{**CFG, "param_dtype": param_dtype})
    state = init_train_state(cfg, OptimizerConfig(1e-2), seed=seed,
                             device="cpu")
    rng = np.random.default_rng(seed)
    batch = torch.from_numpy(rng.integers(1, 32, (2, 2, 17)))
    make_train_step()(state, batch)
    return state


def package(state, next_seq_index=16):
    return Package(next_seq_index=next_seq_index, state=state,
                   model_config=state.model.config.to_dict(), run_id="r1",
                   train_config={"lr_schedule": "cosine", "warmup_steps": 1,
                                 "total_steps": 9, "shuffle_seed": 3})


def assert_states_equal(got, want):
    for (k, a), (_, b) in zip(got.model.state_dict().items(),
                              want.model.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    for name in ("mu", "nu"):
        for k, a in getattr(got.optimizer, name).items():
            b = getattr(want.optimizer, name)[k]
            assert a.dtype == b.dtype and torch.equal(a, b), (name, k)
    assert got.optimizer.count == want.optimizer.count
    assert got.step == want.step


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_round_trip_is_bit_equal(tmp_path, param_dtype):
    state = trained_state(param_dtype)
    _, get_last, save = get_checkpoint_fns(str(tmp_path / "ck"))
    path = save(package(state))
    assert sorted(p.name for p in Path(path).iterdir()) == \
        ["meta.json", "opt.pt", "params.pt"]

    fresh = init_train_state(state.model.config, seed=None, device="cpu")
    pkg = get_last(fresh)
    assert pkg.state is fresh and pkg.path == path
    assert_states_equal(fresh, state)
    assert (pkg.next_seq_index, pkg.run_id) == (16, "r1")
    assert pkg.model_config == state.model.config.to_dict()
    assert pkg.train_config["lr_schedule"] == "cosine"

    as_dict = get_last().state  # no state given: the payload, on the CPU
    assert as_dict["step"] == state.step
    assert as_dict["optimizer"]["count"] == state.optimizer.count
    params = get_last.restore_params().state
    assert params.keys() == state.model.state_dict().keys()
    for k, v in state.model.state_dict().items():
        assert params[k].dtype == getattr(torch, param_dtype)
        assert torch.equal(params[k], v)
        assert torch.equal(as_dict["params"][k], v)


def test_keep_last_n_and_pinned_restore(tmp_path):
    state = trained_state()
    _, get_last, save = get_checkpoint_fns(str(tmp_path / "ck"),
                                           keep_last_n=2)
    paths = [save(package(state, next_seq_index=8 * (i + 1)))
             for i in range(4)]
    assert paths == sorted(paths)  # names increase within one second
    left = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert left == [Path(p).name for p in paths[2:]]
    assert get_last.peek().next_seq_index == 32
    assert get_last.peek(at=paths[2]).next_seq_index == 24
    assert get_last.restore_params(at=Path(paths[0]).name) is None


def test_corrupt_checkpoint_is_quarantined_and_walk_falls_back(tmp_path):
    state = trained_state()
    root = tmp_path / "ck"
    _, _, save = get_checkpoint_fns(str(root))
    older = save(package(state, next_seq_index=8))
    newer = save(package(state, next_seq_index=16))
    params = Path(newer) / "params.pt"
    raw = bytearray(params.read_bytes())
    raw[len(raw) // 2] ^= 0x40  # one byte of the tensor data
    params.write_bytes(bytes(raw))

    _, get_last, _ = get_checkpoint_fns(str(root))
    pkg = get_last()
    assert pkg.path == older and pkg.next_seq_index == 8
    assert not Path(newer).exists()
    assert Path(newer + CORRUPT_SUFFIX).is_dir()
    assert get_last.peek().path == older  # out of the rotation for good


def test_torn_write_is_skipped_and_reset_clears(tmp_path):
    state = trained_state()
    root = tmp_path / "ck"
    reset, get_last, save = get_checkpoint_fns(str(root))
    good = save(package(state))
    torn = root / "ckpt_9999999999"  # newest by name, no meta.json
    torn.mkdir()
    shutil.copy(Path(good) / "params.pt", torn / "params.pt")
    (root / "ckpt_9999999998.tmp").mkdir()  # a save that never renamed
    assert get_last.peek().path == good
    assert torn.is_dir()  # skipped, not quarantined
    reset()
    assert not root.exists() and get_last.peek() is None


def test_unreadable_meta_is_quarantined(tmp_path):
    state = trained_state()
    root = tmp_path / "ck"
    _, get_last, save = get_checkpoint_fns(str(root))
    older = save(package(state))
    newer = Path(save(package(state)))
    (newer / "meta.json").write_text("{not json")
    assert get_last.peek().path == older
    assert (root / (newer.name + CORRUPT_SUFFIX)).is_dir()


def test_orbax_checkpoint_is_refused(tmp_path):
    ckpt = tmp_path / "ck" / "ckpt_1700000000"
    (ckpt / "state").mkdir(parents=True)
    (ckpt / "meta.json").write_text(json.dumps({"next_seq_index": 0}))
    _, get_last, _ = get_checkpoint_fns(str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="torch_jax_ckpt"):
        get_last.peek()


def _jax_losses(root: Path, run_id: str) -> dict:
    """{step: loss} from the JAX CLI's metrics.jsonl."""
    path = root / "runs" / "progen-training" / run_id / "metrics.jsonl"
    out = {}
    for rec in map(json.loads, path.read_text().splitlines()):
        if "loss" in rec:
            out[rec["_step"]] = rec["loss"]
    return out


def _jax_eval_loss(output: str) -> float:
    """ln(perplexity): the printed perplexity (4 decimals of a value near
    300) carries the loss to about 1e-7, the printed loss to 5e-5."""
    return math.log(float(re.search(r"perplexity: ([\d.]+)",
                                    output).group(1)))


def test_imported_jax_checkpoint_resumes_like_jax(tmp_path, monkeypatch):
    import jax

    from progen_tpu.checkpoint import get_checkpoint_fns as jax_fns
    from progen_tpu.cli import eval as jeval
    from progen_tpu.cli import train as jtrain
    from progen_tpu_torch.cli import eval as teval
    from progen_tpu_torch.cli import train as ttrain
    from progen_tpu_torch.convert import flax_params_to_state_dict

    root = make_workspace(tmp_path / "ws")
    monkeypatch.chdir(root)  # the JAX CLI's tracker writes ./runs
    runner = CliRunner()
    jax_args = train_args(root, "jck")[3:]  # drop --device cpu --wandb_off

    res = runner.invoke(jtrain.main, jax_args + ["--num_steps", "1"])
    assert res.exit_code == 0, res.output
    imported = import_jax_checkpoint(str(root / "jck"), str(root / "tck"))

    # the import is the JAX checkpoint, bit for bit through the bridge
    jpkg = jax_fns(str(root / "jck"))[1]()
    jtree = jax.tree.map(np.asarray, jpkg.state)
    _, get_last, _ = get_checkpoint_fns(str(root / "tck"))
    tpkg = get_last()
    assert tpkg.path == imported and tpkg.run_id == jpkg.run_id
    assert tpkg.next_seq_index == jpkg.next_seq_index == 8
    assert tpkg.state["step"] == int(jtree["step"]) == 1
    cfg = ProGenConfig.from_dict(jpkg.model_config)
    for k, v in flax_params_to_state_dict(jtree["params"], cfg).items():
        assert torch.equal(tpkg.state["params"][k], v), k
    with pytest.raises(ValueError, match="torch_jax_ckpt"):
        get_checkpoint_fns(str(root / "jck"))[1].peek()

    res = runner.invoke(jtrain.main, jax_args + ["--num_steps", "3"])
    assert res.exit_code == 0, res.output
    port = ttrain.run(train_args(root, "tck", "--num_steps", "3"))
    jax_losses = _jax_losses(root, jpkg.run_id)
    assert [s["step"] for s in port["steps"]] == [2, 3, 4]
    for s in port["steps"]:
        want = jax_losses[s["step"]]
        assert abs(s["loss"] - want) <= LOSS_RTOL * abs(want), s
    assert port["next_seq_index"] == 32

    jfinal = jax_fns(str(root / "jck"))[1]()
    assert jfinal.next_seq_index == 32
    want = flax_params_to_state_dict(
        jax.tree.map(np.asarray, jfinal.state["params"]), cfg)
    for k, v in port["state"].model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)

    res = runner.invoke(jeval.main, ["--checkpoint_path", str(root / "jck"),
                                     "--data_path", str(root / "train_data")])
    assert res.exit_code == 0, res.output
    got = teval.run(["--device", "cpu", "--checkpoint_path",
                     str(root / "tck"), "--data_path",
                     str(root / "train_data")])
    want = _jax_eval_loss(res.output)
    assert got["sequences"] == 12
    assert abs(got["loss"] - want) <= LOSS_RTOL * abs(want)

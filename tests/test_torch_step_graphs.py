"""The train step replayed from its two CUDA graphs
(``training/graphs.py``, ``training/step.py``).

On the CPU the step never captures, on one process or on a grid, and
stays bit-equal to the eager step written out here. The engagement key
and the launch counts are held with stand-ins for ``torch.cuda``'s
graph and capture, which run the captured body once and replay nothing.

The tests marked ``cuda`` hold the replayed step against the eager one
on the card; they skip on a host without one. Run them there with

    python -m pytest --noconftest -m cuda tests/test_torch_step_graphs.py

(this file imports torch alone, as ``test_torch_cuda.py`` does). The
replay runs the eager step's own kernels, and the update's factors are
the numbers those kernels take from Python, so the two are held equal
bit for bit.
"""

import contextlib
import copy
import gc
import socket
import weakref

import pytest
import torch

from progen_tpu_torch import ProGenConfig
from progen_tpu_torch.ops import cuda_layers, launches
from progen_tpu_torch.training import graphs, step as step_mod
from progen_tpu_torch.training.optimizer import global_norm
from progen_tpu_torch.training.step import (
    batch_loss,
    init_train_state,
    make_train_step,
)

CFG = dict(num_tokens=32, dim=32, seq_len=32, depth=2, window_size=8,
           global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2,
           dtype="float32")
# the card tests' SMALL model (test_torch_cuda.py)
SMALL = dict(num_tokens=32, dim=64, seq_len=64, depth=3, window_size=16,
             global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2)
ACCUM, MICRO = 2, 2


def _batch(seed, seq_len=CFG["seq_len"], shape=(ACCUM, MICRO),
           dtype=torch.int64):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(1, 31, (*shape, seq_len + 1), generator=g,
                         dtype=dtype)


def _eager_step(state, batch):
    """The step as it ran before it replayed: forward and backward per
    micro-batch, the mean gradient, its norm, the gate, the update."""
    model, opt = state.model, state.optimizer
    batch = batch.to(model.device)
    losses = []
    for micro in batch:
        loss = batch_loss(model, micro)
        loss.backward()
        losses.append(loss.detach())
    losses = torch.stack(losses)
    grads = {n: p.grad.div_(batch.shape[0]) for n, p in opt.params.items()}
    norm = global_norm(list(grads.values()))
    ok = bool(torch.isfinite(losses).all() & torch.isfinite(norm))
    if ok:
        opt.update(grads, norm)
    for p in opt.params.values():
        p.grad = None
    state.step += 1
    return losses, norm, ok


def _tensors(state):
    opt = state.optimizer
    return {**{("p", n): p for n, p in opt.params.items()},
            **{("mu", n): t for n, t in opt.mu.items()},
            **{("nu", n): t for n, t in opt.nu.items()}}


def _assert_equal_states(a, b):
    assert (a.step, a.optimizer.count) == (b.step, b.optimizer.count)
    ta, tb = _tensors(a), _tensors(b)
    for k, t in ta.items():
        assert torch.equal(t.nan_to_num(), tb[k].nan_to_num()), k


# ---------------------------------------------------------------- CPU


def test_the_cpu_step_never_captures_and_is_the_eager_step():
    state = init_train_state(ProGenConfig(**CFG), seed=0, device="cpu")
    twin = copy.deepcopy(state)
    step = make_train_step()
    for i in range(3):
        batch = _batch(i)
        _, m = step(state, batch)
        losses, norm, ok = _eager_step(twin, batch)
        assert torch.equal(m["loss"], losses.mean())
        assert torch.equal(m["last_micro_loss"], losses[-1])
        assert torch.equal(m["grad_norm"], norm)
        assert int(m["skipped"]) == (not ok) == 0
        _assert_equal_states(state, twin)
    assert (step.captures, step.replays) == (0, 0)


class FakeGraph:
    """``torch.cuda.CUDAGraph`` without a card: a replay runs nothing."""

    def replay(self):
        pass

    def pool(self):
        return None


@contextlib.contextmanager
def fake_capture(graph, pool=None):
    """``torch.cuda.graph`` without a card: the body runs, once."""
    yield


@pytest.fixture
def card(monkeypatch):
    """Every device taken for the card, with stand-in graphs."""
    monkeypatch.setattr(step_mod, "replayable",
                        lambda model, grid: grid is None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_capture)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_a_grid_step_never_captures(card, monkeypatch):
    """On a grid (one gloo rank here) the step stays eager, and bit-equal
    to the eager step, even where the device would take graphs."""
    from progen_tpu_torch.parallel import init_grid

    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    grid = init_grid(1, 1, "gloo", timeout=60)
    try:
        state = init_train_state(ProGenConfig(**CFG), seed=0, device="cpu",
                                 grid=grid)
        twin = init_train_state(ProGenConfig(**CFG), seed=0, device="cpu")
        step = make_train_step(grid)
        for i in range(3):
            _, m = step(state, _batch(i))
            losses, _, _ = _eager_step(twin, _batch(i))
            assert torch.equal(m["loss"], losses.mean())
            _assert_equal_states(state, twin)
        assert (step.captures, step.replays) == (0, 0)
    finally:
        torch.distributed.destroy_process_group()


def _changed(state, how):
    """(state, batch) for the next call, with one thing changed."""
    if how == "shape":
        return state, _batch(9, shape=(1, MICRO))
    if how == "dtype":
        return state, _batch(9, dtype=torch.int32)
    return copy.deepcopy(state), _batch(9)


@pytest.mark.parametrize("how", ["shape", "dtype", "state"])
def test_a_new_key_drops_the_graphs_and_runs_eagerly(card, how):
    """Eager, capture, replay on one key; then a call on a changed batch
    shape, dtype or state runs the eager step (equal to it, bit for
    bit) and drops the graphs; the call after it captures anew."""
    state = init_train_state(ProGenConfig(**CFG), seed=0, device="cpu")
    step = make_train_step()
    for i, want in enumerate([(0, 0), (1, 1), (1, 2)]):
        step(state, _batch(i))
        assert (step.captures, step.replays) == want
    state, batch = _changed(state, how)
    twin = copy.deepcopy(state)
    _, m = step(state, batch)
    losses, _, _ = _eager_step(twin, batch)
    assert torch.equal(m["loss"], losses.mean())
    _assert_equal_states(state, twin)
    assert (step.captures, step.replays) == (1, 2)
    step(state, batch)  # the second call on the new key captures
    assert (step.captures, step.replays) == (2, 3)


def test_a_dropped_step_frees_its_graphs_at_once(card):
    """No reference cycle holds a step's graphs, so they go with the step
    and not later, when the cycle collector might free them in the
    middle of another capture."""
    state = init_train_state(ProGenConfig(**CFG), seed=0, device="cpu")
    step = make_train_step()
    for i in range(2):
        step(state, _batch(i))
    graph = weakref.ref(step.graphs.a)
    gc.disable()
    try:
        del step
        assert graph() is None
    finally:
        gc.enable()


def test_the_same_key_replays():
    """The key holds for the same state and batch shape and changes with
    each part of it."""
    state = init_train_state(ProGenConfig(**CFG), seed=0, device="cpu")
    key = graphs.key_of(state, _batch(0))
    assert graphs.key_of(state, _batch(1)) == key
    assert graphs.key_of(copy.deepcopy(state), _batch(0)) != key
    assert graphs.key_of(state, _batch(0, shape=(1, MICRO))) != key
    assert graphs.key_of(state, _batch(0, dtype=torch.int32)) != key


def test_a_replay_credits_the_launches_seen_while_capturing(card,
                                                            monkeypatch):
    """Each step, eager, capturing or replayed, adds the same launches:
    a capture's are taken back out, and each replay credits them (here a
    stand-in kernel that counts 3 L1 launches a micro-batch)."""
    real = step_mod.batch_loss

    def counted(model, data, grid=None):
        cuda_layers.norm_shift.launches += 3
        return real(model, data, grid)

    monkeypatch.setattr(step_mod, "batch_loss", counted)
    state = init_train_state(ProGenConfig(**CFG), seed=0, device="cpu")
    step = make_train_step()
    launches.reset_counts()
    per_step = []
    for i in range(4):
        before = launches.launch_counts()
        step(state, _batch(i))
        after = launches.launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
    assert (step.captures, step.replays) == (1, 3)
    want = {k: 0 for k in launches.WRAPPERS} | {"L1": 3 * ACCUM}
    assert per_step == [want] * 4


# --------------------------------------------------------------- card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_states(dev, dtype):
    cfg = ProGenConfig(**SMALL, dtype=dtype)
    return (init_train_state(cfg, seed=0, device=dev),
            init_train_state(cfg, seed=0, device=dev))


def _metrics_equal(a, b):
    return all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_replayed_steps_equal_the_eager_steps(dev, dtype):
    """One step function over 4 batches (eager, capture, replay, replay)
    against a fresh, eager one each step, from the same state: losses,
    grad norm, parameters, moments, count and each step's launches."""
    state, twin = _card_states(dev, dtype)
    step = make_train_step()
    for i in range(4):
        batch = _batch(i, SMALL["seq_len"])
        launches.reset_counts()
        _, got = step(state, batch)
        replayed = launches.launch_counts()
        launches.reset_counts()
        _, want = make_train_step()(twin, batch)
        assert launches.launch_counts() == replayed
        assert _metrics_equal(got, want), (i, got, want)
        torch.cuda.synchronize()
        _assert_equal_states(state, twin)
    assert (step.captures, step.replays) == (1, 3)
    assert replayed["A1"] > 0 and replayed["L1"] > 0


@pytest.mark.cuda
def test_a_non_finite_replay_skips_the_update(dev):
    """A batch with one row through a NaN embedding row: the replayed
    step's gate refuses the update (parameters, moments and count as
    they were) and the step still counts; the next batch updates."""
    state, twin = _card_states(dev, "bfloat16")
    step = make_train_step()
    for i in range(3):
        step(state, _batch(i, SMALL["seq_len"]))
        make_train_step()(twin, _batch(i, SMALL["seq_len"]))
    nan_token = 31  # _batch draws 1..30
    for s in (state, twin):
        with torch.no_grad():
            s.model.embed[nan_token] = float("nan")
    before = {k: t.clone() for k, t in _tensors(state).items()}
    count = state.optimizer.count
    poisoned = _batch(7, SMALL["seq_len"])
    poisoned[1, 0, 5] = nan_token
    _, m = step(state, poisoned)
    _, want = make_train_step()(twin, poisoned)
    assert int(m["skipped"]) == int(want["skipped"]) == 1
    assert step.replays == 3 and state.step == 4
    assert state.optimizer.count == count
    for k, t in _tensors(state).items():
        assert torch.equal(t.nan_to_num(), before[k].nan_to_num()), k
    _assert_equal_states(state, twin)
    _, m = step(state, _batch(8, SMALL["seq_len"]))
    make_train_step()(twin, _batch(8, SMALL["seq_len"]))
    assert int(m["skipped"]) == 0 and state.optimizer.count == count + 1
    _assert_equal_states(state, twin)

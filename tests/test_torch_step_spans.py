"""The spans the port's train step, optimizer and scorer open
(``training/step.py``, ``training/optimizer.py``,
``workloads/scoring.py``), and the span machinery they rest on
(``telemetry/spans.py``): parents, the ring of closed spans, the waits,
``time.time_ns()`` stamps, and ``record_function`` entered only under a
profiler. Port only, on the CPU."""

import contextlib

import pytest
import torch

from progen_tpu_torch import ProGen, ProGenConfig
from progen_tpu_torch.resilience import chaos
from progen_tpu_torch.telemetry import spans
from progen_tpu_torch.training.step import init_train_state, make_train_step
from progen_tpu_torch.workloads.scoring import run_batch_score

CFG = dict(num_tokens=256, dim=32, seq_len=32, depth=2, window_size=8,
           global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2,
           dtype="float32")
ACCUM, MICRO = 2, 2
UPDATE = ["step/clip", "step/adamw"]
STEP_TREE = (["step/h2d"]
             + [n for _ in range(ACCUM)
                for n in ("step/forward", "step/backward")]
             + ["step/grad_norm", "step/gate"])
SCORE_CHILDREN = ["score/collate", "score/forward", "score/fetch",
                  "score/write"]
NAMES = sorted(set(STEP_TREE + UPDATE + SCORE_CHILDREN)
               | {"step/run", "step/update", "step/grad_reduce",
                  "step/zero1_gather", "score/run", "score/flush"})


@pytest.fixture
def tel(monkeypatch):
    """A fresh process-global Telemetry whose records land in
    ``tel.records``."""
    records = []
    fresh = spans.Telemetry(sink=records.append)
    fresh.records = records
    monkeypatch.setattr(spans, "_GLOBAL", fresh)
    return fresh


def _state(poison: bool = False):
    state = init_train_state(ProGenConfig(**CFG), seed=0, device="cpu")
    if poison:
        with torch.no_grad():
            state.model.to_logits.bias[3] = float("nan")
    return state


def _batch(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(1, 256, (ACCUM, MICRO, CFG["seq_len"] + 1),
                         generator=g)


def _children(ring, parent):
    """Names of the spans directly under ``parent``, in entry order."""
    return [c.name for c in sorted(ring, key=lambda c: c.t0_ns)
            if c.parent == parent.id]


def _only(ring, name):
    (found,) = [c for c in ring if c.name == name]
    return found


@pytest.mark.parametrize("finite", [True, False],
                         ids=["finite", "non-finite"])
def test_train_step_tree(tel, finite):
    """A step at grad_accum 2 opens exactly the tree of the module's
    docstring; a non-finite step reads the gate and skips the update.
    Under the loop's span the step's root sits below it."""
    state, step = _state(poison=not finite), make_train_step()
    with spans.span("train/step"):
        _, metrics = step(state, _batch())
    assert int(metrics["skipped"]) == (0 if finite else 1)
    ring = tel.closed_spans()
    loop, root = _only(ring, "train/step"), _only(ring, "step/run")
    assert root.parent == loop.id and loop.parent is None
    assert _children(ring, root) == (STEP_TREE
                                     + (["step/update"] if finite else []))
    if finite:
        assert _children(ring, _only(ring, "step/update")) == UPDATE
    else:
        assert not {"step/update", *UPDATE} & {c.name for c in ring}
    assert {c.name for c in ring if c.wait} == {"step/h2d", "step/gate"}
    # the records carry the parent, and the micro-batch on both ends
    micro = [(r["ev"], r["span"], r["micro"]) for r in tel.records
             if "micro" in r]
    assert micro == [(ev, name, k) for k in range(ACCUM)
                     for name in ("step/forward", "step/backward")
                     for ev in ("B", "E")]
    by_id = {r["id"]: r for r in tel.records if r["ev"] == "B"}
    assert by_id[root.id]["parent"] == loop.id
    assert by_id[loop.id]["parent"] is None


def test_children_lie_inside_their_parents(tel):
    state, step = _state(), make_train_step()
    for k in range(2):
        step(state, _batch(k))
    ring = tel.closed_spans()
    by_id = {c.id: c for c in ring}
    assert len(ring) == 2 * (len(STEP_TREE) + 2 + len(UPDATE))
    for c in ring:
        assert c.t0_ns <= c.t1_ns
        if c.parent is not None:
            up = by_id[c.parent]
            assert up.t0_ns <= c.t0_ns <= c.t1_ns <= up.t1_ns
    # the records' stamps are the ring's, in seconds
    ends = {r["id"]: r for r in tel.records if r["ev"] == "E"}
    for c in ring:
        assert ends[c.id]["ts"] == c.t1_ns / 1e9
        assert ends[c.id]["dur_s"] == round((c.t1_ns - c.t0_ns) / 1e9, 6)


def test_the_step_is_unchanged_by_its_spans(tel, monkeypatch):
    """The same step with every span a no-op gives bit-equal
    parameters and metrics."""
    from progen_tpu_torch.training import optimizer, step as step_mod

    got_state = _state()
    _, got = make_train_step()(got_state, _batch())

    def quiet(name, wait=False, **attrs):
        return contextlib.nullcontext()

    monkeypatch.setattr(step_mod, "span", quiet)
    monkeypatch.setattr(optimizer, "span", quiet)
    want_state = _state()
    _, want = make_train_step()(want_state, _batch())
    for (n, p), q in zip(got_state.model.named_parameters(),
                         want_state.model.parameters()):
        assert torch.equal(p, q), n
    for k in got:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("capacity, opened", [(4, 3), (4, 4), (4, 9),
                                              (1, 5)])
def test_the_ring_keeps_order_and_drops_the_oldest(capacity, opened):
    tel = spans.Telemetry(ring_spans=capacity)
    for _ in range(opened):
        with tel.span("outer"):  # id 2k, closes second
            with tel.span("inner", wait=True):  # id 2k + 1
                pass
    closed = [i for k in range(opened) for i in (2 * k + 1, 2 * k)]
    kept = closed[-capacity:]
    ring = tel.closed_spans()
    assert [c.id for c in ring] == kept
    assert [c.name for c in ring] == [("inner" if i % 2 else "outer")
                                      for i in kept]
    assert [c.wait for c in ring] == [bool(i % 2) for i in kept]
    assert tel.dropped == len(closed) - len(kept)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_recent_spans_serve_the_watchdog(n):
    tel = spans.Telemetry()
    with tel.span("a"):
        pass
    with tel.span("b"):
        pass
    with tel.span("c"):
        pass
    got = tel.recent_spans(n)
    assert [r["span"] for r in got] == ["a", "b", "c"][-n:]
    assert all(r["dur_s"] >= 0 and r["ts"] > 0 for r in got)


@pytest.mark.parametrize("profiled", [False, True])
def test_record_function_only_under_a_profiler(tel, monkeypatch,
                                               profiled):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with (torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
          if profiled else contextlib.nullcontext()):
        with spans.span("outer"):
            with spans.span("inner", wait=True):
                pass
    assert entered == (["outer", "inner"] if profiled else [])


def test_annotations_match_the_stamps(tel):
    """Under a CPU profiler each span's annotation starts and ends
    within 1 ms of its stamps: one clock."""
    state, step = _state(), make_train_step()
    step(state, _batch(0))  # the first step's allocations, unprofiled
    before = len(tel.closed_spans())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, _batch(1))
    ring = tel.closed_spans()[before:]
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in NAMES:
            events.setdefault(e.name(), []).append(e)
    for name in events:
        events[name].sort(key=lambda e: e.start_ns())
    assert {c.name for c in ring} == set(events)
    for c in sorted(ring, key=lambda c: c.t0_ns):
        e = events[c.name].pop(0)
        assert abs(e.start_ns() - c.t0_ns) < 1_000_000, c.name
        assert abs(e.end_ns() - c.t1_ns) < 1_000_000, c.name


def test_the_scorer_tree(tel, tmp_path):
    cfg = ProGenConfig(**CFG)
    model = ProGen(cfg, device="cpu", seed=0).eval()
    records = [(f"r{i}", b"# " + b"MKV" * (i + 2)) for i in range(5)]
    out = run_batch_score(model, records, str(tmp_path), batch_size=2)
    assert out["batches"] == 3
    ring = tel.closed_spans()
    run = _only(ring, "score/run")
    assert run.parent is None
    flushes = [c for c in ring if c.name == "score/flush"]
    assert [c.parent for c in flushes] == [run.id] * 3
    assert _children(ring, run) == ["score/flush"] * 3
    for f in flushes:
        assert _children(ring, f) == SCORE_CHILDREN
    assert {c.name for c in ring if c.wait} == {"score/fetch"}
    begins = [r for r in tel.records
              if r["ev"] == "B" and r["span"] == "score/flush"]
    assert [(r["bucket"], r["n"]) for r in begins] == [(32, 2), (32, 2),
                                                        (32, 1)]


@pytest.mark.parametrize("name", NAMES)
def test_no_span_is_a_chaos_target(name):
    """The chaos hook fires on every span's name: none of these may be
    one of its sites."""
    assert name not in chaos.KNOWN_TARGETS

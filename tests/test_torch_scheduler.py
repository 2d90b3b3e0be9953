"""The port's scheduler, request journal and prefix cache on the CPU, at
the JAX serving tests' tiny size (vocab 32, dim 32, seq_len 32, depth 2,
window 8, one gMLP layer) in float32, with seeded random weights. Every
stream is held bit for bit against the port's ``sample_fast``."""

import json

import numpy as np
import pytest
import torch

from progen_tpu_torch import ProGen, ProGenConfig
from progen_tpu_torch.sampling import sample_fast
from progen_tpu_torch.serving import (
    REJECT_DEADLINE,
    REJECT_DRAINING,
    REJECT_QUEUE_FULL,
    PrefixCache,
    Request,
    RequestJournal,
    Scheduler,
    ServeEngine,
    replay_into,
    replay_requests,
)
from progen_tpu_torch.telemetry import spans
from progen_tpu_torch.telemetry.trace import LineDrops

TINY = dict(num_tokens=32, dim=32, seq_len=32, depth=2, window_size=8,
            global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2,
            dtype="float32")


@pytest.fixture(scope="module")
def model():
    m = ProGen(ProGenConfig(**TINY), device="cpu", seed=5)
    with torch.no_grad():  # an SGU mix that matters at this size
        w = m.ff[1].sgu.spatial_weights
        w.copy_(torch.randn(w.shape, generator=torch.Generator()
                            .manual_seed(5)) / 6)
    return m.eval()


def _reference(model, req: Request) -> np.ndarray:
    return sample_fast(req.seed, model, req.prime, req.length,
                       top_k=req.top_k, add_bos=req.add_bos,
                       temperature=req.temperature, top_p=req.top_p,
                       template=req.template, frozen=req.frozen,
                       device="cpu").numpy()


def _requests() -> list:
    tpl = np.zeros(20, np.int64)
    frz = np.zeros(20, bool)
    tpl[[1, 2, 6, 11]] = [4, 9, 13, 2]
    frz[[1, 2, 6, 11]] = True
    return [
        Request(id="a", prime=[3, 4, 5], length=26, add_bos=True, seed=1),
        Request(id="b", prime=[6, 7], length=22, temperature=0.7,
                top_p=0.9, seed=2),
        Request(id="c", prime=[4, 9], length=20, add_bos=True, seed=3,
                template=tpl, frozen=frz, top_k=5),
        Request(id="d", prime=[8, 1, 8, 1, 8], length=30, top_k=None,
                seed=4),
    ]


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class TestScheduler:
    def test_queue_full_and_invalid(self, model):
        sched = Scheduler(ServeEngine(model, max_slots=1, max_len=24),
                          max_queue=2)
        ok = Request(id="ok", prime=[1, 2], length=10)
        assert sched.submit(ok) == (True, None)
        assert sched.submit(Request(id="ok2", prime=[1], length=8)) == (
            True, None)
        assert sched.submit(Request(id="full", prime=[1], length=8)) == (
            False, REJECT_QUEUE_FULL)
        for bad in (Request(id="long", prime=[1], length=25),
                    Request(id="k", prime=[1], length=8, top_k=0),
                    Request(id="kind", prime=[1], length=8, kind="score"),
                    Request(id="dl", prime=[1], length=8, deadline_s=0),
                    Request(id="emb", prime=[1] * 33, length=0,
                            kind="embed")):
            accepted, reason = sched.submit(bad)
            assert not accepted and reason.startswith("invalid: "), bad.id
        m = sched.metrics.counters
        assert (m["requests_submitted"], m["rejected_queue_full"],
                m["rejected_invalid"]) == (8, 1, 5)

    def test_deadline_sheds_a_queued_request(self, model):
        clock = _Clock()
        sched = Scheduler(ServeEngine(model, max_slots=1, max_len=32),
                          clock=clock)
        first, late = _requests()[:2]
        late.deadline_s = 1.0
        sched.submit(first)
        sched.submit(late)
        sched.step()
        clock.t = 2.0
        sched.step()
        assert sched.pop_expired() == [(late, REJECT_DEADLINE)]
        _, comps = sched.run_to_completion(max_steps=100)
        assert [c.request_id for c in comps] == ["a"]
        np.testing.assert_array_equal(comps[0].tokens,
                                      _reference(model, first))
        assert sched.metrics.counters["rejected_deadline_exceeded"] == 1

    def test_drain_sheds_the_queue_and_finishes_the_slots(self, model):
        sched = Scheduler(ServeEngine(model, max_slots=2, max_len=32))
        reqs = _requests()
        for r in reqs:
            sched.submit(r)
        sched.step()
        assert sched.drain_queue() == 2
        shed = sched.pop_expired()
        assert [(r.id, why) for r, why in shed] == [
            ("c", REJECT_DRAINING), ("d", REJECT_DRAINING)]
        _, comps = sched.run_to_completion(max_steps=100)
        for c in comps:
            req = next(r for r in reqs if r.id == c.request_id)
            np.testing.assert_array_equal(c.tokens, _reference(model, req))
        assert sorted(c.request_id for c in comps) == ["a", "b"]

    def test_embed_is_answered_in_fifo_order(self, model):
        engine = ServeEngine(model, max_slots=1, max_len=32)
        sched = Scheduler(engine)
        for r in _requests()[:2]:
            sched.submit(r)
        sched.submit(Request(id="e", prime=[3, 4, 5], length=0,
                             add_bos=True, kind="embed"))
        # a holds the one slot, b waits for it, and e waits behind b
        assert sched.step()[1] == []
        _, comps = sched.run_to_completion(max_steps=100)
        assert [c.request_id for c in comps] == ["a", "e", "b"]
        emb = next(c for c in comps if c.request_id == "e")
        np.testing.assert_array_equal(emb.embedding,
                                      engine.embed([3, 4, 5], add_bos=True))
        assert emb.tokens.shape == (0,) and emb.embedding.shape == (32,)
        assert sched.metrics.counters["embed_requests"] == 1

    def test_one_closed_track_per_accepted_request(self, model):
        recs = []
        spans.configure(sink=recs.append)
        try:
            clock = _Clock()
            sched = Scheduler(ServeEngine(model, max_slots=2, max_len=32),
                              clock=clock, prefill_chunk=3)
            reqs = _requests()
            reqs[3].deadline_s = 0.5
            for r in reqs:
                sched.submit(r)
            sched.submit(Request(id="e", prime=[2, 3], length=0,
                                 kind="embed"))
            sched.submit(Request(id="bad", prime=[1], length=99))
            sched.step()
            clock.t = 1.0
            sched.run_to_completion(max_steps=200)
        finally:
            spans.configure()
        req = [r for r in recs if r["ev"] == "req"]
        for rid in ("a", "b", "c", "d", "e"):
            mine = [(r["ph"], r["name"]) for r in req if r["req"] == rid]
            assert mine[0] == ("b", "request") and mine[-1] == ("e",
                                                                "request")
            opened = [n for ph, n in mine if ph == "b"]
            closed = [n for ph, n in mine if ph == "e"]
            assert sorted(opened) == sorted(closed), rid
        assert ("n", "deadline_exceeded") in [
            (r["ph"], r["name"]) for r in req if r["req"] == "d"]
        assert [r for r in recs if r["ev"] == "request_rejected"][0][
            "req"] == "bad"
        assert not [r for r in req if r["req"] == "bad"]
        assert [r for r in recs if r["ev"] == "slots"][-1]["in_use"] == 0
        spans_seen = {r["span"] for r in recs if r["ev"] == "E"}
        assert {"serve/prefill_chunk", "serve/embed"} <= spans_seen

    def test_metrics_count_tokens_and_latencies(self, model):
        sched = Scheduler(ServeEngine(model, max_slots=4, max_len=32))
        reqs = _requests()
        for r in reqs:
            sched.submit(r)
        events, comps = sched.run_to_completion(max_steps=200)
        snap = sched.metrics.snapshot()
        assert snap["decode_tokens"] == len(events) == sum(
            c.n_generated for c in comps)
        starts = [len(r.prime) + r.add_bos for r in reqs]
        assert snap["prefill_tokens"] == sum(s - 1 for s in starts)
        assert snap["ttft_s_count"] == snap["latency_s_count"] == 4
        assert snap["decode_tokens_per_s"] > 0


class TestJournal:
    @pytest.mark.parametrize("cut", [1, 5, 12])
    def test_replay_after_a_cut_gives_the_uninterrupted_stream(
            self, model, tmp_path, cut):
        path = tmp_path / "journal.jsonl"
        reqs = _requests()
        first = Scheduler(ServeEngine(model, max_slots=2, max_len=32),
                          journal=RequestJournal(path))
        for r in reqs:
            first.submit(r)
        done_first = []
        for _ in range(cut):  # then the process dies
            done_first += [c.request_id for c in first.step()[1]]
        first.journal.close()
        journal = RequestJournal(path)
        second = Scheduler(ServeEngine(model, max_slots=2, max_len=32),
                           journal=journal, prefill_chunk=4)
        summary = replay_into(second, path)
        assert summary["skipped_done"] == len(done_first)
        _, comps = second.run_to_completion(max_steps=300)
        journal.close()
        got = {c.request_id: c.tokens for c in comps}
        assert sorted(done_first + list(got)) == ["a", "b", "c", "d"]
        # the journal's tokens over both lives are the uninterrupted ones
        toks = {}
        for line in path.read_text().splitlines():
            rec = json.loads(line)
            if rec["op"] == "token":
                toks.setdefault(rec["req"], {})[rec["index"]] = rec["token"]
        for r in reqs:
            want = _reference(model, r)
            start = len(r.prime) + r.add_bos
            stream = [toks[r.id][i] for i in sorted(toks[r.id])]
            assert sorted(toks[r.id]) == list(range(start,
                                                    start + len(stream)))
            np.testing.assert_array_equal(want[start:start + len(stream)],
                                          stream)
            if r.id in got:
                np.testing.assert_array_equal(got[r.id], want)
        # a third life finds nothing to do
        pending, finished, n_done = replay_requests(path)
        assert (pending, finished, n_done) == ([], [], 4)

    def test_torn_last_line_is_skipped(self, model, tmp_path):
        path = tmp_path / "journal.jsonl"
        sched = Scheduler(ServeEngine(model, max_slots=1, max_len=32),
                          journal=RequestJournal(path))
        req = _requests()[0]
        sched.submit(req)
        for _ in range(3):
            sched.step()
        sched.journal.close()
        with path.open("a") as f:
            f.write('{"ev": "journal", "op": "tok')
        drops = LineDrops()
        pending, finished, n_done = replay_requests(path, drops)
        assert drops.count == 1 and (finished, n_done) == ([], 0)
        (resumed,) = pending
        assert resumed.draw_offset == 3 and resumed.deadline_s is None
        assert list(resumed.prime[:3]) == [3, 4, 5]
        np.testing.assert_array_equal(
            np.concatenate([[0], resumed.prime]),
            _reference(model, req)[:len(resumed.prime) + 1])

    def test_a_finished_stream_is_settled_not_decoded(self, model,
                                                       tmp_path):
        path = tmp_path / "journal.jsonl"
        journal = RequestJournal(path)
        req = Request(id="x", prime=[3, 4], length=6, seed=9)
        journal.accept(req)
        for i, t in zip(range(2, 6), (5, 6, 7, 8)):
            journal.token("x", i, t)
        journal.close()
        journal = RequestJournal(path)
        sched = Scheduler(ServeEngine(model, max_slots=1, max_len=32),
                          journal=journal)
        summary = replay_into(sched, path)
        journal.close()
        assert summary["resumed"] == [] and not sched.has_work
        assert summary["finished"][0]["emitted"] == [5, 6, 7, 8]
        assert replay_requests(path)[2] == 1  # now settled


class TestPrefixCache:
    def _cache(self, model, n: int):
        c = model.init_cache(1)
        with torch.no_grad():
            for p in range(n):
                model.decode_step(torch.tensor([p + 1]), c)
        return c

    def test_lru_obeys_the_byte_budget(self, model):
        snap = self._cache(model, 2)
        cache = PrefixCache(2 * snap.nbytes)
        rows = [np.arange(10) + k for k in range(3)]
        assert cache.insert(rows[0], 2, snap)
        assert cache.insert(rows[1], 2, snap)
        assert cache.lookup(rows[0], 5)[0] == 2  # refreshes row 0
        assert cache.insert(rows[2], 2, snap)  # evicts row 1
        assert cache.bytes == 2 * snap.nbytes and len(cache) == 2
        assert cache.lookup(rows[1], 5) == (0, None)
        assert cache.lookup(rows[0], 5)[0] == 2
        assert cache.lookup(rows[0], 1) == (0, None)  # deeper than feed
        assert not cache.insert(rows[0], 2, snap)  # present: refreshed
        assert cache.stats() == {"hits": 2, "misses": 2, "evictions": 1,
                                 "inserts": 3, "bytes": 2 * snap.nbytes,
                                 "entries": 2}

    def test_oversized_snapshot_is_skipped(self, model):
        snap = self._cache(model, 1)
        cache = PrefixCache(snap.nbytes - 1)
        assert not cache.insert(np.arange(4), 1, snap)
        assert len(cache) == 0 and cache.bytes == 0

    def test_snapshots_are_clones(self, model):
        snap = self._cache(model, 3)
        cache = PrefixCache(1 << 20)
        cache.insert(np.arange(4), 3, snap)
        snap.attn[0].k.zero_()
        _, got = cache.lookup(np.arange(4), 3)
        assert got.attn[0].k.abs().sum() > 0
        got.attn[0].k.zero_()
        _, again = cache.lookup(np.arange(4), 3)
        assert again.attn[0].k.abs().sum() > 0
        assert again.pos.tolist() == [3]

    def test_clear_keeps_the_counters(self, model):
        cache = PrefixCache(1 << 20)
        cache.insert(np.arange(4), 2, self._cache(model, 2))
        cache.lookup(np.arange(4), 2)
        cache.clear()
        assert len(cache) == 0 and cache.bytes == 0
        assert cache.stats()["hits"] == 1
        assert cache.lookup(np.arange(4), 2) == (0, None)

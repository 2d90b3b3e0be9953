"""The port's failover router (``progen_tpu_torch/serving/router.py``)
against scripted fake replicas: the cases of ``tests/test_router.py``
(spec parsing, the circuit breaker, dispatch, shedding, failover, the
route grammar and the trace context), with the spec parser, the
Prometheus parse and the breaker's schedule held against the JAX
package's. The handoff's resume payload carries ``seed`` and
``draw_offset`` (the port's resume wire) where the JAX router's carries
a PRNG key, and, unlike the JAX router's, an infill's template and an
embed's kind: the resumed streams, fed through the port's ``cli.serve``
parser into a real engine on the CPU (the serving tests' tiny model,
vocab 256, float32, one slot), equal the uninterrupted ones token for
token, every frozen position kept, and a handed-off pending embed comes
back as the same embedding.

Each FakeReplica is a unix-socket server the test drives by hand between
``router.poll()`` calls: no serve subprocess, a deterministic order.
"""

import json
import os
import socket
import time

import numpy as np
import pytest

import torch

from progen_tpu.resilience.retry import RetryPolicy as JaxRetryPolicy
from progen_tpu.serving import router as jax_router
from progen_tpu_torch import ProGen, ProGenConfig
from progen_tpu_torch.cli import serve
from progen_tpu_torch.resilience.retry import RetryPolicy
from progen_tpu_torch.sampling import sample_fast
from progen_tpu_torch.serving import Scheduler, ServeEngine, ServingMetrics
from progen_tpu_torch.serving.journal import (
    STATUS_HANDED_OFF,
    RequestJournal,
    replay_requests,
)
from progen_tpu_torch.serving.router import (
    ROUTE_DISPATCHED,
    ROUTE_HANDOFF,
    ROUTE_REPLICA_DOWN,
    ROUTE_SHED,
    CircuitBreaker,
    ReplicaSpec,
    Router,
    _parse_prom,
    parse_replica_spec,
)
from progen_tpu_torch.serving.scheduler import Request
from progen_tpu_torch.telemetry import prometheus_text, spans


# fast, jitter-free backoff so tests never sleep for real
FAST_POLICY = RetryPolicy(
    max_attempts=3, base_delay_s=0.01, max_delay_s=0.05,
    multiplier=2.0, jitter=0.0, seed=0,
)


class FakeReplica:
    """A scripted replica endpoint: unix socket server the test drives
    by hand between router polls."""

    def __init__(self, tmp, name, journal_dir=None):
        self.path = os.path.join(str(tmp), f"{name}.sock")
        self.journal_dir = (
            None if journal_dir is None else str(journal_dir)
        )
        self.srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.srv.bind(self.path)
        self.srv.listen(4)
        self.srv.setblocking(False)
        self.conn = None
        self.buf = b""
        self.requests = []  # every request dict ever received

    def spec(self):
        return ReplicaSpec(
            socket_path=self.path, journal_dir=self.journal_dir
        )

    def pump(self):
        """Accept a pending connection and drain request lines."""
        if self.conn is None:
            try:
                conn, _ = self.srv.accept()
            except (BlockingIOError, OSError):
                return
            conn.setblocking(False)
            self.conn = conn
        while True:
            try:
                data = self.conn.recv(65536)
            except (BlockingIOError, OSError):
                break
            if not data:
                break
            self.buf += data
        *lines, self.buf = self.buf.split(b"\n")
        for raw in lines:
            if raw.strip():
                self.requests.append(json.loads(raw.decode()))

    def send(self, obj):
        self.conn.sendall(json.dumps(obj).encode() + b"\n")

    def die(self):
        """SIGKILL from the router's point of view: EOF on the socket,
        listener gone."""
        if self.conn is not None:
            self.conn.close()
            self.conn = None
        self.srv.close()
        if os.path.exists(self.path):
            os.unlink(self.path)

    def close(self):
        self.die()


def make_router(replicas, **kw):
    kw.setdefault("policy", FAST_POLICY)
    return Router([r.spec() for r in replicas], **kw)


def pump(router, replicas, rounds=4):
    """A few router ticks with the fakes accepting/draining between."""
    out = []
    for _ in range(rounds):
        for r in replicas:
            r.pump()
        out.extend(router.poll())
        for r in replicas:
            r.pump()
    return out


@pytest.fixture
def telemetry_records():
    records = []
    spans.configure(sink=records.append)
    yield records
    spans.configure()


class TestSpecParsing:
    def test_bare_path(self):
        s = parse_replica_spec("/tmp/r0.sock")
        assert s.socket_path == "/tmp/r0.sock"
        assert s.journal_dir is None

    def test_keyed(self):
        s = parse_replica_spec(
            "sock=/tmp/r0.sock,journal=/var/j,prom=/var/m.prom,name=r0"
        )
        assert s.socket_path == "/tmp/r0.sock"
        assert s.journal_dir == "/var/j"
        assert s.prom_file == "/var/m.prom"
        assert s.name == "r0"

    def test_missing_sock_rejected(self):
        with pytest.raises(ValueError, match="sock="):
            parse_replica_spec("journal=/var/j")

    def test_unknown_key_rejected(self):
        with pytest.raises(ValueError, match="unknown"):
            parse_replica_spec("sock=/tmp/a,journel=/var/j")

    @pytest.mark.parametrize("text", [
        "/tmp/r0.sock",
        "sock=/tmp/r0.sock,journal=/var/j,prom=/var/m.prom,name=r0",
        "tcp=10.0.0.5:7000,journal=/var/j",
        " sock=/a , prom=/b ,",
        "journal=/var/j",
        "sock=/tmp/a,journel=/var/j",
        "sock=/a,tcp=h:1",
    ])
    def test_parses_as_the_jax_router_does(self, text):
        def parse(fn):
            try:
                s = fn(text)
            except ValueError:
                return "ValueError"
            return (s.socket_path, s.tcp, s.journal_dir, s.prom_file,
                    s.name, s.endpoint)

        assert parse(parse_replica_spec) == \
            parse(jax_router.parse_replica_spec)

    def test_prom_parse_reads_the_port_exposition(self):
        m = ServingMetrics()
        m.set_gauge("queue_depth", 3)
        m.set_gauge("slot_occupancy", 2)
        m.inc("requests_completed", 5)
        m.observe("latency_s", 0.25, trace_id="tr-1")
        text = prometheus_text(m)
        out = _parse_prom(text)
        assert out["queue_depth"] == 3.0
        assert out["slot_occupancy"] == 2.0
        assert out["requests_completed_total"] == 5.0
        assert out['latency_seconds{quantile="0.99"}'] == 0.25
        # what the router reads agrees with the JAX parse
        ref = jax_router._parse_prom(text)
        for key in ("queue_depth", "slot_occupancy",
                    "requests_completed_total"):
            assert out[key] == ref[key]

    def test_prom_parse_strips_serve_prefix(self):
        text = (
            "# TYPE progen_serve_queue_depth gauge\n"
            "progen_serve_queue_depth 3\n"
            "progen_serve_decode_compile_count 1\n"
            'progen_serve_ttft_s{quantile="0.5"} 0.01\n'
            "garbage line\n"
        )
        out = _parse_prom(text)
        assert out["queue_depth"] == 3.0
        assert out["decode_compile_count"] == 1.0


class TestCircuitBreaker:
    def test_backoff_grows_and_saturates(self):
        t = [0.0]
        b = CircuitBreaker("x", FAST_POLICY, clock=lambda: t[0])
        d1 = b.record_failure()
        d2 = b.record_failure()
        d3 = b.record_failure()
        d4 = b.record_failure()
        assert d2 == pytest.approx(d1 * 2)
        assert d3 == pytest.approx(min(d1 * 4, FAST_POLICY.max_delay_s))
        assert d4 == d3  # attempt index saturates: re-probe forever
        assert b.is_open
        t[0] += d4 + 1e-6
        assert not b.is_open

    def test_schedule_equals_the_jax_breaker(self):
        knobs = dict(max_attempts=4, base_delay_s=0.1, max_delay_s=2.0,
                     multiplier=2.0, jitter=0.5, seed=3)
        t = [0.0]
        ours = CircuitBreaker("replica1", RetryPolicy(**knobs),
                              clock=lambda: t[0])
        ref = jax_router.CircuitBreaker("replica1", JaxRetryPolicy(**knobs),
                                        clock=lambda: t[0])
        for _ in range(7):
            assert ours.record_failure() == ref.record_failure()

    def test_success_resets(self):
        t = [0.0]
        b = CircuitBreaker("x", FAST_POLICY, clock=lambda: t[0])
        b.record_failure()
        b.record_success()
        assert not b.is_open
        assert b.failures == 0


class TestDispatch:
    def test_roundtrip_token_done(self, tmp_path, telemetry_records):
        rep = FakeReplica(tmp_path, "r0")
        router = make_router([rep])
        try:
            assert router.submit({"id": "a", "prime": "MK",
                                  "length": 8, "seed": 3}) is None
            pump(router, [rep])
            assert len(rep.requests) == 1
            wire = rep.requests[0]["id"]
            assert wire.endswith("-a") and wire.startswith("q")
            # replica id namespace survives the round trip untouched
            assert rep.requests[0]["prime"] == "MK"
            rep.send({"event": "token", "id": wire, "token": 7,
                      "text": "X", "index": 3})
            rep.send({"event": "done", "id": wire, "text": "ignored",
                      "n_generated": 99})
            out = pump(router, [rep])
            kinds = [ev["event"] for _, ev in out]
            assert kinds == ["token", "done"]
            tok, done = out[0][1], out[1][1]
            assert tok["id"] == "a" and tok["token"] == 7
            # the done is the ROUTER's accounting, not the replica's
            assert done["id"] == "a"
            assert done["text"] == "X"
            assert done["n_generated"] == 1
            assert router.metrics.counters["requests_completed"] == 1
            assert not router.has_work
        finally:
            rep.close()
        statuses = [r["status"] for r in telemetry_records
                    if r.get("ev") == "route"]
        assert statuses == [ROUTE_DISPATCHED]

    def test_wire_ids_unique_across_reuse(self, tmp_path):
        rep = FakeReplica(tmp_path, "r0")
        router = make_router([rep])
        try:
            router.submit({"id": "a", "prime": "M", "length": 8})
            pump(router, [rep])
            w1 = rep.requests[0]["id"]
            rep.send({"event": "done", "id": w1, "text": "",
                      "n_generated": 0})
            pump(router, [rep])
            # client reuses its id after settlement: new wire id
            router.submit({"id": "a", "prime": "M", "length": 8})
            pump(router, [rep])
            w2 = rep.requests[1]["id"]
            assert w1 != w2
        finally:
            rep.close()

    def test_least_loaded_replica_wins(self, tmp_path):
        r0 = FakeReplica(tmp_path, "r0")
        r1 = FakeReplica(tmp_path, "r1")
        router = make_router([r0, r1])
        try:
            for i in range(4):
                router.submit({"id": f"x{i}", "prime": "M", "length": 8})
            pump(router, [r0, r1])
            # in-flight balancing: 2 requests each, not 4 on replica 0
            assert len(r0.requests) == 2
            assert len(r1.requests) == 2
        finally:
            r0.close()
            r1.close()


class TestShedding:
    def test_missing_id_rejected(self, tmp_path):
        rep = FakeReplica(tmp_path, "r0")
        router = make_router([rep])
        try:
            rej = router.submit({"prime": "M"})
            assert rej["event"] == "rejected"
            assert "missing id" in rej["reason"]
        finally:
            rep.close()

    def test_router_queue_full(self, tmp_path):
        rep = FakeReplica(tmp_path, "r0")
        router = make_router([rep], max_queue=1)
        try:
            assert router.submit({"id": "a", "prime": "M"}) is None
            rej = router.submit({"id": "b", "prime": "M"})
            assert rej["reason"] == "router_queue_full"
        finally:
            rep.close()

    def test_tenant_quota_released_on_settle(self, tmp_path):
        rep = FakeReplica(tmp_path, "r0")
        router = make_router([rep], tenant_quota=1)
        try:
            assert router.submit(
                {"id": "a", "prime": "M", "tenant": "t1", "length": 8}
            ) is None
            rej = router.submit({"id": "b", "prime": "M", "tenant": "t1"})
            assert rej["reason"] == "tenant_quota"
            # a DIFFERENT tenant is not throttled
            assert router.submit(
                {"id": "c", "prime": "M", "tenant": "t2", "length": 8}
            ) is None
            pump(router, [rep])
            for r in rep.requests:
                rep.send({"event": "done", "id": r["id"], "text": "",
                          "n_generated": 0})
            pump(router, [rep])
            # quota released after settlement
            assert router.submit(
                {"id": "d", "prime": "M", "tenant": "t1", "length": 8}
            ) is None
        finally:
            rep.close()

    def test_drain_sheds_queue_and_closes_intake(self, tmp_path,
                                                 telemetry_records):
        rep = FakeReplica(tmp_path, "r0")
        router = make_router([rep])
        try:
            router.submit({"id": "a", "prime": "M"})
            n = router.drain()
            assert n == 1
            out = router.poll()
            # the shed lands through poll's output queue
            shed = [ev for _, ev in out if ev["event"] == "rejected"]
            assert shed and shed[0]["reason"] == "draining"
            rej = router.submit({"id": "b", "prime": "M"})
            assert rej["reason"] == "draining"
            assert not router.has_work
        finally:
            rep.close()
        statuses = [r["status"] for r in telemetry_records
                    if r.get("ev") == "route"]
        assert ROUTE_SHED in statuses

    def test_replica_queue_full_retries_then_sheds(self, tmp_path):
        rep = FakeReplica(tmp_path, "r0")
        router = make_router([rep], max_redispatch=1)
        try:
            router.submit({"id": "a", "prime": "M", "length": 8})
            pump(router, [rep])
            wire = rep.requests[0]["id"]
            rep.send({"event": "rejected", "id": wire,
                      "reason": "queue_full"})
            # first rejection -> requeued with backoff, re-dispatched
            deadline = time.monotonic() + 2.0
            while len(rep.requests) < 2:
                pump(router, [rep], rounds=1)
                assert time.monotonic() < deadline, "no re-dispatch"
                time.sleep(0.005)
            wire2 = rep.requests[1]["id"]
            assert wire2 == wire  # same request, same wire id
            rep.send({"event": "rejected", "id": wire2,
                      "reason": "queue_full"})
            out = []
            deadline = time.monotonic() + 2.0
            while not out:
                out = [ev for _, ev in pump(router, [rep], rounds=1)
                       if ev["event"] == "rejected"]
                assert time.monotonic() < deadline, "no shed"
                time.sleep(0.005)
            # retry budget exhausted -> the client gets the reason
            assert out[0]["id"] == "a"
            assert out[0]["reason"] == "queue_full"
        finally:
            rep.close()


class TestFailover:
    def test_connect_failure_opens_breaker(self, tmp_path):
        spec = ReplicaSpec(socket_path=str(tmp_path / "nope.sock"))
        router = Router([spec], policy=FAST_POLICY)
        router.poll()
        assert router.metrics.counters["connect_failures"] == 1
        assert router.links[0].breaker.is_open
        router.poll()  # breaker open: no second attempt yet
        assert router.metrics.counters["connect_failures"] == 1

    def test_never_journaled_redispatches_fresh(self, tmp_path,
                                                telemetry_records):
        """A dead replica that never wrote an accept never emitted a
        token (accept-before-ack), so the request is re-sent verbatim
        to a survivor."""
        r0 = FakeReplica(tmp_path, "r0", journal_dir=tmp_path / "j0")
        r1 = FakeReplica(tmp_path, "r1")
        router = make_router([r0, r1])
        try:
            router.submit({"id": "a", "prime": "MK", "length": 8})
            pump(router, [r0, r1])
            victim, survivor = (
                (r0, r1) if r0.requests else (r1, r0)
            )
            wire = victim.requests[0]["id"]
            victim.die()
            deadline = time.monotonic() + 2.0
            while not survivor.requests:
                pump(router, [survivor], rounds=1)
                assert time.monotonic() < deadline, "no failover"
                time.sleep(0.005)
            assert survivor.requests[0]["id"] == wire
            assert survivor.requests[0]["prime"] == "MK"
        finally:
            r0.close()
            r1.close()
        statuses = [r["status"] for r in telemetry_records
                    if r.get("ev") == "route"]
        assert ROUTE_REPLICA_DOWN in statuses
        assert ROUTE_HANDOFF in statuses

    def test_journal_handoff_resumes_midstream(self, tmp_path,
                                               telemetry_records):
        """The core contract: fold the dead journal, forward unsent
        tokens, re-dispatch resume state (compound prime, the seed and
        the draw offset past the emitted tokens), and write handed_off
        marks a --replay respects."""
        j0 = tmp_path / "j0"
        r0 = FakeReplica(tmp_path, "r0", journal_dir=j0)
        r1 = FakeReplica(tmp_path, "r1")
        router = make_router([r0, r1])
        try:
            router.submit({"id": "a", "prime": "MK", "length": 10,
                           "seed": 7, "top_k": 25})
            # pin the dispatch to r0 by keeping r1 unready
            pump(router, [r0])
            wire = r0.requests[0]["id"]
            # the replica journaled the accept (fd-namespaced, as the
            # socket transport does) and two tokens, but the router
            # only ever saw the first
            jr = RequestJournal(j0 / "journal.jsonl")
            jid = f"9:{wire}"
            jr.accept(Request(
                id=jid, prime=np.asarray([5, 6], np.int64), length=10,
                top_k=25, add_bos=True, seed=7,
            ))
            jr.token(jid, 3, 41)
            jr.token(jid, 4, 42)
            jr.close()
            rep_sent = {"event": "token", "id": wire, "token": 41,
                        "text": "d", "index": 3}
            r0.send(rep_sent)
            out = pump(router, [r0, r1])
            assert [ev["event"] for _, ev in out] == ["token"]
            r0.die()
            events = []
            deadline = time.monotonic() + 2.0
            while not r1.requests:
                events += pump(router, [r1], rounds=1)
                assert time.monotonic() < deadline, "no handoff"
                time.sleep(0.005)
            # the journaled-but-unsent token reached the client exactly
            # once (index 3 was already forwarded, 4 was not)
            toks = [ev for _, ev in events if ev["event"] == "token"]
            assert [t["index"] for t in toks] == [4]
            assert toks[0]["token"] == 42
            # resume state: compound prime, the draw offset past the 2
            # emitted tokens, the seed as it was
            res = r1.requests[0]
            assert res["id"] == wire
            assert res["prime_tokens"] == [5, 6, 41, 42]
            assert res["add_bos"] is True
            assert res["length"] == 10
            assert (res["seed"], res["draw_offset"]) == (7, 2)
            assert "key" not in res and "template_tokens" not in res
            assert "embed" not in res
            # ownership marks: a --replay of the dead journal must skip
            pending, finished, n_done = replay_requests(
                j0 / "journal.jsonl"
            )
            assert pending == [] and finished == []
            assert n_done == 1
            marks = [
                json.loads(ln) for ln in
                (j0 / "journal.jsonl").read_text().splitlines()
                if json.loads(ln).get("op") == "done"
            ]
            assert marks[0]["status"] == STATUS_HANDED_OFF
            assert marks[0]["req"] == jid
            # survivor finishes the stream; the router settles once
            r1.send({"event": "token", "id": wire, "token": 43,
                     "text": "e", "index": 5})
            r1.send({"event": "done", "id": wire, "text": "",
                     "n_generated": 1})
            out = pump(router, [r1])
            done = [ev for _, ev in out if ev["event"] == "done"]
            assert len(done) == 1
            assert done[0]["id"] == "a"
            assert done[0]["n_generated"] == 3  # 41, 42, 43 — no dups
            assert not router.has_work
        finally:
            r0.close()
            r1.close()
        routes = [r for r in telemetry_records if r.get("ev") == "route"]
        handoffs = [r for r in routes if r["status"] == ROUTE_HANDOFF]
        assert handoffs and handoffs[0].get("resumed") is True
        assert handoffs[0].get("to") == 1

    def test_journal_finished_settles_without_redispatch(self, tmp_path):
        """A stream that already hit its stop rule in the dead journal
        is answered from the journal alone — nothing re-decodes."""
        j0 = tmp_path / "j0"
        r0 = FakeReplica(tmp_path, "r0", journal_dir=j0)
        r1 = FakeReplica(tmp_path, "r1")
        router = make_router([r0, r1])
        try:
            router.submit({"id": "a", "prime": "MK", "length": 5,
                           "seed": 7})
            pump(router, [r0])
            wire = r0.requests[0]["id"]
            jr = RequestJournal(j0 / "journal.jsonl")
            jr.accept(Request(
                id=wire, prime=np.asarray([5, 6], np.int64), length=5,
                add_bos=True, seed=7,
            ))
            jr.token(wire, 3, 41)
            jr.token(wire, 4, 42)  # start 3 + 2 emitted = length 5
            jr.close()
            r0.die()
            out = []
            deadline = time.monotonic() + 2.0
            while not any(ev["event"] == "done" for _, ev in out):
                out += pump(router, [r1], rounds=1)
                assert time.monotonic() < deadline, "no settle"
                time.sleep(0.005)
            done = [ev for _, ev in out if ev["event"] == "done"][0]
            assert done["id"] == "a" and done.get("replayed") is True
            assert done["n_generated"] == 2
            assert r1.requests == []  # nothing was re-dispatched
            # the finished stream got its terminal mark too
            pending, finished, n_done = replay_requests(
                j0 / "journal.jsonl"
            )
            assert pending == [] and finished == [] and n_done == 1
        finally:
            r0.close()
            r1.close()

    def test_route_records_stay_in_grammar(self, tmp_path,
                                           telemetry_records):
        rep = FakeReplica(tmp_path, "r0")
        router = make_router([rep])
        try:
            router.submit({"id": "a", "prime": "M", "length": 8})
            pump(router, [rep])
            rep.send({"event": "done", "id": rep.requests[0]["id"],
                      "text": "", "n_generated": 0})
            pump(router, [rep])
            router.drain()
        finally:
            rep.close()
        allowed = {ROUTE_DISPATCHED, ROUTE_HANDOFF, ROUTE_SHED,
                   ROUTE_REPLICA_DOWN}
        routes = [r for r in telemetry_records if r.get("ev") == "route"]
        assert routes
        for r in routes:
            assert r["status"] in allowed
        # every req 'b' got its 'e' (the PGL006 burden this module
        # shares with the scheduler)
        opens = {}
        for r in telemetry_records:
            if r.get("ev") != "req":
                continue
            if r["ph"] == "b":
                opens[(r["req"], r["name"])] = True
            elif r["ph"] == "e":
                opens.pop((r["req"], r["name"]), None)
            else:
                pass  # 'n' instants carry no pairing obligation
        assert opens == {}


class TestTraceContext:
    """Dapper-style trace propagation: the router mints one trace_id
    per accepted request, the wire carries it to replicas, the journal
    persists it, and a handoff resume reattaches to the SAME trace."""

    def test_trace_minted_and_on_every_record(self, tmp_path,
                                              telemetry_records):
        rep = FakeReplica(tmp_path, "r0")
        router = make_router([rep])
        try:
            router.submit({"id": "a", "prime": "M", "length": 8})
            pump(router, [rep])
            wire_req = rep.requests[0]
            trace = wire_req.get("trace_id")
            assert trace  # minted, and carried on the wire
            rep.send({"event": "done", "id": wire_req["id"],
                      "text": "", "n_generated": 0})
            pump(router, [rep])
        finally:
            rep.close()
        reqs = [r for r in telemetry_records if r.get("ev") == "req"]
        assert reqs
        assert {r.get("trace_id") for r in reqs} == {trace}
        dispatched = [r for r in telemetry_records
                      if r.get("ev") == "route"
                      and r["status"] == ROUTE_DISPATCHED]
        assert dispatched[0]["trace_id"] == trace
        assert dispatched[0]["hop"] == 1

    def test_client_supplied_trace_honored(self, tmp_path):
        rep = FakeReplica(tmp_path, "r0")
        router = make_router([rep])
        try:
            router.submit({"id": "a", "prime": "M", "length": 8,
                           "trace_id": "upstream-7"})
            pump(router, [rep])
            assert rep.requests[0]["trace_id"] == "upstream-7"
        finally:
            rep.close()

    def test_traces_unique_across_requests(self, tmp_path):
        rep = FakeReplica(tmp_path, "r0")
        router = make_router([rep])
        try:
            router.submit({"id": "a", "prime": "M", "length": 8})
            router.submit({"id": "b", "prime": "M", "length": 8})
            pump(router, [rep])
            traces = {r["trace_id"] for r in rep.requests}
            assert len(traces) == 2
        finally:
            rep.close()

    def test_handoff_resume_keeps_trace_and_marks_resumer(
            self, tmp_path, telemetry_records):
        """The acceptance bar: a midstream replica death must NOT fork
        the trace — the journaled accept carries the trace_id, the
        resume payload restores it, and the handed_off ownership mark
        names the resuming replica."""
        j0 = tmp_path / "j0"
        r0 = FakeReplica(tmp_path, "r0", journal_dir=j0)
        r1 = FakeReplica(tmp_path, "r1")
        router = make_router([r0, r1])
        try:
            router.submit({"id": "a", "prime": "MK", "length": 10,
                           "seed": 7})
            pump(router, [r0])
            wire_req = r0.requests[0]
            wire = wire_req["id"]
            trace = wire_req["trace_id"]
            # the replica journals the accept exactly as serve does:
            # the Request built from the wire dict carries the trace
            jr = RequestJournal(j0 / "journal.jsonl")
            jid = f"9:{wire}"
            jr.accept(Request(
                id=jid, prime=np.asarray([5, 6], np.int64), length=10,
                add_bos=True, seed=7, trace_id=trace,
            ))
            jr.token(jid, 3, 41)
            jr.close()
            accepts = [
                json.loads(ln) for ln in
                (j0 / "journal.jsonl").read_text().splitlines()
                if json.loads(ln).get("op") == "accept"
            ]
            assert accepts[0]["trace_id"] == trace
            r0.die()
            deadline = time.monotonic() + 2.0
            while not r1.requests:
                pump(router, [r1], rounds=1)
                assert time.monotonic() < deadline, "no handoff"
                time.sleep(0.005)
            # the resume payload reattaches to the SAME trace
            assert r1.requests[0]["id"] == wire
            assert r1.requests[0]["trace_id"] == trace
            # the ownership mark names who resumed the stream
            marks = [
                json.loads(ln) for ln in
                (j0 / "journal.jsonl").read_text().splitlines()
                if json.loads(ln).get("op") == "done"
            ]
            assert marks[0]["status"] == STATUS_HANDED_OFF
            assert marks[0]["resumed_by"]
        finally:
            r0.close()
            r1.close()
        # router-side: ONE trace across both dispatch hops, the second
        # hop flagged as a resume
        reqs = [r for r in telemetry_records if r.get("ev") == "req"]
        assert {r.get("trace_id") for r in reqs} == {trace}
        hops = [r for r in reqs
                if r.get("ph") == "b" and r.get("name") == "dispatched"]
        assert [h["hop"] for h in hops] == [1, 2]
        assert hops[1].get("resumed") is True


TINY = dict(num_tokens=256, dim=32, seq_len=32, depth=2, window_size=8,
            global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2,
            dtype="float32")
DEFAULTS = {"length": 32, "top_k": 25, "temperature": 1.0, "top_p": None,
            "seed": 42}


@pytest.fixture(scope="module")
def model():
    """The tiny model with seeded random weights, an SGU mix that
    matters."""
    pm = ProGen(ProGenConfig(**TINY), device="cpu", seed=3)
    with torch.no_grad():
        w = pm.ff[1].sgu.spatial_weights
        w.copy_(torch.randn(w.shape, generator=torch.Generator()
                            .manual_seed(3)) / 6)
    return pm.eval()


def _parsed(line: dict):
    req, err = serve.parse_request(json.dumps(line), DEFAULTS)
    assert err is None, err
    return req


def _run_one(model, req):
    """Serve ``req`` alone on a one-slot engine: ({index: token},
    completion)."""
    sched = Scheduler(ServeEngine(model, max_slots=1, max_len=32))
    ok, why = sched.submit(req)
    assert ok, why
    toks, comps = {}, []
    while sched.has_work:
        events, done = sched.step()
        toks.update({ev.index: ev.token for ev in events})
        comps += done
    (comp,) = comps
    return toks, comp


def _uninterrupted(model, req) -> np.ndarray:
    return sample_fast(req.seed, model, req.prime, req.length,
                       top_k=req.top_k, add_bos=req.add_bos,
                       temperature=req.temperature, top_p=req.top_p,
                       template=req.template, frozen=req.frozen,
                       device="cpu").numpy()


def _hand_off(tmp_path, line: dict, emitted, seen: int):
    """Route ``line`` to r0, which journals its accept (as cli.serve
    does, connection-namespaced) and the first ``emitted`` tokens, sends
    the router the first ``seen`` of them, and dies. Returns (the
    router, the survivor r1, the wire id, the client events so far)."""
    j0 = tmp_path / "j0"
    r0 = FakeReplica(tmp_path, "r0", journal_dir=j0)
    r1 = FakeReplica(tmp_path, "r1")
    router = make_router([r0, r1])
    assert router.submit(line) is None
    pump(router, [r0])
    wire_line = r0.requests[0]
    wire = wire_line["id"]
    req = _parsed(wire_line)
    req.id = f"3:{wire}"
    jr = RequestJournal(j0 / "journal.jsonl")
    jr.accept(req)
    start = len(req.prime) + req.add_bos
    for k, tok in enumerate(emitted):
        jr.token(req.id, start + k, int(tok))
    jr.close()
    for k, tok in enumerate(emitted[:seen]):
        r0.send({"event": "token", "id": wire, "token": int(tok),
                 "text": "x", "index": start + k})
    events = pump(router, [r0, r1])
    r0.die()
    deadline = time.monotonic() + 2.0
    while not r1.requests:
        events += pump(router, [r1], rounds=1)
        assert time.monotonic() < deadline, "no handoff"
        time.sleep(0.005)
    return router, r1, r0, wire, [ev for _, ev in events]


def _finish_on_survivor(model, router, r1, wire, events):
    """Serve the resume payload r1 got on a real engine, stream its
    tokens and done back through the router; the client's events."""
    payload = r1.requests[0]
    toks, comp = _run_one(model, _parsed(payload))
    for index in sorted(toks):
        r1.send({"event": "token", "id": wire, "token": int(toks[index]),
                 "text": "x", "index": index})
    r1.send({"event": "done", "id": wire, "text": "", "n_generated": 0})
    events += [ev for _, ev in pump(router, [r1])]
    assert not router.has_work
    return payload, events


class TestResumeOnTheEngine:
    """The resume wire, served: a handed-off stream equals the
    uninterrupted one."""

    def test_generate_resumes_the_uninterrupted_stream(self, tmp_path,
                                                       model):
        line = {"id": "g", "prime": "MKTAY", "length": 30, "seed": 11,
                "temperature": 0.9, "top_p": 0.95}
        want = _uninterrupted(model, _parsed(line))
        start = 6  # BOS + 5 residues
        emitted = want[start:start + 7]
        router, r1, r0, wire, events = _hand_off(tmp_path, line, emitted, 4)
        try:
            payload, events = _finish_on_survivor(model, router, r1, wire,
                                                  events)
        finally:
            r0.close()
            r1.close()
        assert (payload["seed"], payload["draw_offset"]) == (11, 7)
        got = {ev["index"]: ev["token"] for ev in events
               if ev["event"] == "token"}
        idx = [ev["index"] for ev in events if ev["event"] == "token"]
        assert len(idx) == len(set(idx))  # no index twice
        n = max(got) + 1
        np.testing.assert_array_equal([got[i] for i in range(start, n)],
                                      want[start:n])
        assert (want[n:] == 0).all()
        (done,) = [ev for ev in events if ev["event"] == "done"]
        assert done["id"] == "g" and done["n_generated"] == n - start

    def test_infill_keeps_every_frozen_position(self, tmp_path, model):
        line = {"id": "f", "template": "MK?LV??GA?K???W?", "seed": 5}
        req = _parsed(line)
        want = _uninterrupted(model, req)
        start = len(req.prime) + 1
        emitted = want[start:start + 4]
        router, r1, r0, wire, events = _hand_off(tmp_path, line, emitted, 2)
        try:
            payload, events = _finish_on_survivor(model, router, r1, wire,
                                                  events)
        finally:
            r0.close()
            r1.close()
        assert payload["template_tokens"] == req.template.tolist()
        assert payload["frozen"] == req.frozen.tolist()
        got = {ev["index"]: ev["token"] for ev in events
               if ev["event"] == "token"}
        np.testing.assert_array_equal(
            [got[i] for i in range(start, req.length)],
            want[start:req.length])
        full = np.concatenate([want[:start], [got[i] for i in
                                              range(start, req.length)]])
        np.testing.assert_array_equal(full[req.frozen],
                                      req.template[req.frozen])

    def test_pending_embed_comes_back_as_an_embedding(self, tmp_path,
                                                      model):
        line = {"id": "e", "prime": "MKTAYIAKQR", "embed": True}
        router, r1, r0, wire, events = _hand_off(tmp_path, line, [], 0)
        try:
            payload = r1.requests[0]
            assert payload["embed"] is True
            req = _parsed(payload)
            assert req.kind == "embed"
            _, comp = _run_one(model, req)
            want = ServeEngine(model, max_slots=1).embed(
                _parsed(line).prime, add_bos=True)
            np.testing.assert_array_equal(comp.embedding, want)
            r1.send({"event": "embedding", "id": wire, "dim": 32,
                     "values": [round(float(x), 6) for x in comp.embedding],
                     "latency_s": 0.1})
            out = [ev for _, ev in pump(router, [r1])]
        finally:
            r0.close()
            r1.close()
        (emb,) = out
        assert emb["event"] == "embedding" and emb["id"] == "e"
        assert emb["values"] == [round(float(x), 6) for x in want]
        assert not router.has_work
        assert router.metrics.counters["requests_completed"] == 1


def test_embedding_event_settles_the_request(tmp_path):
    rep = FakeReplica(tmp_path, "r0")
    router = make_router([rep])
    try:
        router.submit({"id": "e", "prime": "MK", "embed": True})
        pump(router, [rep])
        wire = rep.requests[0]["id"]
        rep.send({"event": "embedding", "id": wire, "dim": 2,
                  "values": [0.5, -1.0], "latency_s": 0.01})
        out = pump(router, [rep])
        assert [ev for _, ev in out] == [{
            "event": "embedding", "id": "e", "dim": 2,
            "values": [0.5, -1.0], "latency_s": 0.01}]
        assert not router.has_work
    finally:
        rep.close()


class TestScaling:
    """The fleet's run-time scaling: a retired replica gives back its
    queued requests through the release control line, and a replica that
    turns healthy takes queued work off the busiest one."""

    def _answer_releases(self, rep):
        """The replica's side of ``{"ctl": "release"}``: grant it."""
        for req in rep.requests:
            if req.get("ctl") == "release" and not req.get("_answered"):
                req["_answered"] = True
                rep.send({"event": "released", "id": req["id"],
                          "released": True})

    def test_retire_releases_queued_work_to_another_replica(self, tmp_path,
                                                            telemetry_records):
        r0 = FakeReplica(tmp_path, "r0")
        r1 = FakeReplica(tmp_path, "r1")
        router = make_router([r0, r1])
        try:
            for i in range(2):
                router.submit({"id": f"x{i}", "prime": "M", "length": 8})
            pump(router, [r0, r1])
            assert [len(r.requests) for r in (r0, r1)] == [1, 1]
            assert router.retire_replica(0) == 1
            pump(router, [r0, r1])
            ctl = [r for r in r0.requests if r.get("ctl") == "release"]
            assert [c["id"] for c in ctl] == [r0.requests[0]["id"]]
            self._answer_releases(r0)
            pump(router, [r0, r1])
            # the released request went to r1 as it was first sent
            assert r1.requests[-1] == r0.requests[0]
            assert router.links[0].inflight == {}
            assert router.metrics.counters["rebalance_released"] == 1
        finally:
            r0.close()
            r1.close()
        handoffs = [r for r in telemetry_records if r.get("ev") == "route"
                    and r["status"] == ROUTE_HANDOFF]
        assert handoffs and handoffs[0]["rebalance"] is True

    def test_added_replica_takes_work_off_the_busiest(self, tmp_path):
        r0 = FakeReplica(tmp_path, "r0")
        r1 = FakeReplica(tmp_path, "r1")
        router = make_router([r0], rebalance_max=4)
        try:
            for i in range(4):
                router.submit({"id": f"x{i}", "prime": "M", "length": 8})
            pump(router, [r0])
            assert len(r0.requests) == 4
            assert router.add_replica(r1.spec()) == 1
            pump(router, [r0, r1])
            # a gap of 4 moves 2: their release ctls go to the donor
            ctl = [r for r in r0.requests if r.get("ctl") == "release"]
            assert len(ctl) == 2
            self._answer_releases(r0)
            pump(router, [r0, r1])
            assert len(r1.requests) == 2
            assert len(router.links[0].inflight) == 2
            assert len(router.links[1].inflight) == 2
        finally:
            r0.close()
            r1.close()


class TestDigestReexport:
    def test_replica_checkpoint_digest_reexported(self, tmp_path):
        """The router re-exports each replica's progen_serve_
        checkpoint_digest (scraped from its exposition) as
        replica{i}_checkpoint_digest, as the JAX router does from the same
        files; the port's replicas publish no decode_compile_count, so
        none is re-exported."""
        from progen_tpu_torch.checkpoint import digest_gauge
        from progen_tpu_torch.telemetry.prometheus import write_prometheus

        gauges = [digest_gauge("a1b2c3d4e5f6" + "0" * 52),
                  digest_gauge("0fedcba98765" + "1" * 52)]
        proms = []
        for i, g in enumerate(gauges):
            m = ServingMetrics()
            m.set_gauge("queue_depth", i)
            m.set_gauge("checkpoint_digest", g)
            proms.append(str(tmp_path / f"r{i}.prom"))
            write_prometheus(proms[-1], prometheus_text(m))
        snaps = []
        for pkg, spec_cls, router_cls, policy in (
                ("torch", ReplicaSpec, Router, FAST_POLICY),
                ("jax", jax_router.ReplicaSpec, jax_router.Router,
                 JaxRetryPolicy(max_attempts=3, base_delay_s=0.01,
                                max_delay_s=0.05, multiplier=2.0,
                                jitter=0.0, seed=0))):
            (tmp_path / pkg).mkdir()
            fakes = [FakeReplica(tmp_path / pkg, f"r{i}") for i in range(2)]
            router = router_cls(
                [spec_cls(socket_path=f.path, prom_file=p)
                 for f, p in zip(fakes, proms)],
                policy=policy, health_every=0.0)
            try:
                pump(router, fakes, rounds=3)
                snaps.append(router.metrics.snapshot())
            finally:
                for f in fakes:
                    f.close()
        got, want = snaps
        for i, g in enumerate(gauges):
            assert got[f"replica{i}_checkpoint_digest"] == g
            assert want[f"replica{i}_checkpoint_digest"] == g
        assert not any(k.endswith("decode_compile_count") for k in got)

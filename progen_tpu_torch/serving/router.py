"""Multi-replica failover router: one front, N journaled serve replicas.

The port of the JAX package's ``serving/router.py``. One ``ServeEngine``
process scales up (slots, int8); this module scales out, Orca-style:
request-level routing in front of iteration-level scheduling, each
replica running ``cli.serve --socket`` (or ``--tcp``) with its own
journal directory. The router is a pure front end, with no model and no
device, so its failure domain is small and its loop is IO.

Routing: the least-loaded up replica (router-tracked in-flight plus the
queue depth scraped from the replica's Prometheus file), lowest index
as the deterministic tiebreak. Health is passive: the prom file's mtime
is the replica's heartbeat (stale replicas are deprioritised, not
evicted), and a broken or refused socket is the hard down signal. Each
replica has a circuit breaker whose open interval follows
``resilience/retry.py``'s policy: exponential backoff with seeded
jitter, saturating at ``max_delay_s``, so a dead replica is probed
again forever and one that comes back is simply dialled again.

Replicas may live on other machines: a ``tcp=HOST:PORT`` spec dials the
framed-TCP transport (``fleet/transport.py``) instead of a unix socket.
The frame's payload is exactly the JSONL line, so journals, replay and
handoff do not depend on the wire, and a framing violation (a condemned
stream) is handled as a replica's death. The fleet also scales at run
time: ``add_replica`` / ``retire_replica`` / ``revive_replica`` grow and
shrink the link set, and when a link turns healthy the router
rebalances: it asks the most-loaded donor to ``{"ctl": "release"}`` a
bounded number of its still-queued requests (journaled
``done(handed_off)`` on the donor, so a replay never serves them twice)
and routes them again.

Load shedding is explicit, like the scheduler's: ``router_queue_full``
when the router's own queue is at its bound, ``tenant_quota`` when a
tenant's outstanding requests reach ``--tenant_quota``, ``draining``
after SIGTERM, ``no_replicas`` with an empty fleet. A replica's
``queue_full`` (or ``draining``) rejection is retried on the backoff
schedule before it becomes the client's problem.

The robustness core is the journal-ownership handoff. When a replica
dies mid-stream, its journal still holds what is needed to continue
(accept before acknowledge, token before emit: ``serving/journal.py``):
the router folds that journal (``handoff_states``), forwards any
journaled but unsent tokens to the client, settles requests whose
stream had already finished, and sends the rest to a survivor as raw
resume state, the resume wire ``cli.serve`` takes: ``prime_tokens``
(the prime and every emitted token), ``seed`` and ``draw_offset`` (a
slot's draw t is ``draw_seed(seed, t)``, so the offset past the emitted
tokens continues the stream exactly, where the JAX router sends a
fast-forwarded PRNG key), and the request's ``template_tokens`` and
``frozen`` (an infill keeps every frozen position) or ``embed`` (an
embedding request comes back as an embedding). The JAX router's payload
carries neither of those last two, so it resumes an infill as a free
generation and an embedding as a generation of nothing. Ownership is
then marked: a ``done(status="handed_off")`` record in the dead journal
means a restart with ``--replay`` skips the request. Requests the dead
replica never journaled were never acknowledged past the router, so a
fresh dispatch is safe. A replica's ``embedding`` event settles its
request (the JAX router ignores it and waits forever).

Telemetry: each request is one async ``req`` track (queued →
dispatched, with handoff and shed instants); routing decisions land as
``{"ev": "route", "status": dispatched|handoff|shed|replica_down}``
records. Metrics render under the ``progen_router_`` Prometheus prefix,
including per-replica ``replica{i}_scrape_age_s`` staleness gauges.

Trace context (Dapper-style): ``submit()`` mints a ``trace_id`` per
accepted request (clients may supply their own) and each dispatch is a
hop (the ``hop`` counter on the ``dispatched`` records). The id rides
the wire to the replica, is journaled on accept and is carried on the
resume payload after a handoff, so the replica tracks, the dead
replica's journal and the survivor's resumed stream share one trace.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import socket
import time
import uuid
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from progen_tpu_torch.data.tokenizer import decode_tokens
from progen_tpu_torch.fleet.transport import (
    FramedConnection,
    LineConnection,
    connect_tcp,
    parse_hostport,
)
from progen_tpu_torch.resilience.chaos import ChaosError, maybe_inject
from progen_tpu_torch.resilience.retry import RetryPolicy, policy_from_env
from progen_tpu_torch.serving.journal import (
    STATUS_COMPLETED,
    STATUS_HANDED_OFF,
    RequestJournal,
    handoff_states,
    resume_request,
)
from progen_tpu_torch.serving.metrics import ServingMetrics
from progen_tpu_torch.serving.scheduler import (
    REJECT_DRAINING,
    REJECT_QUEUE_FULL,
)
from progen_tpu_torch.telemetry.spans import get_telemetry, span

# the route-record status alphabet
ROUTE_DISPATCHED = "dispatched"
ROUTE_HANDOFF = "handoff"
ROUTE_SHED = "shed"
ROUTE_REPLICA_DOWN = "replica_down"

REJECT_NO_REPLICAS = "no_replicas"
REJECT_ROUTER_QUEUE_FULL = "router_queue_full"
REJECT_TENANT_QUOTA = "tenant_quota"
# a replica died holding tokens we cannot re-derive (no journal)
REJECT_REPLICA_LOST = "replica_lost"


@dataclasses.dataclass
class ReplicaSpec:
    """One replica endpoint — a unix ``socket_path`` or a framed-TCP
    ``tcp`` (``HOST:PORT``, fleet/transport.py), exactly one of the
    two. ``journal_dir`` is what makes handoff possible — without it a
    dead replica's mid-stream requests can only be shed (the tokens
    the client saw cannot be re-derived)."""

    socket_path: Optional[str] = None
    journal_dir: Optional[str] = None
    prom_file: Optional[str] = None
    name: Optional[str] = None
    tcp: Optional[str] = None

    def __post_init__(self):
        if bool(self.socket_path) == bool(self.tcp):
            raise ValueError(
                "replica spec needs exactly one of sock=PATH / "
                "tcp=HOST:PORT"
            )

    @property
    def endpoint(self) -> str:
        return self.socket_path or f"tcp={self.tcp}"


def parse_replica_spec(text: str) -> ReplicaSpec:
    """CLI form: ``sock=PATH`` or ``tcp=HOST:PORT``, then optional
    ``[,journal=DIR][,prom=FILE][,name=N]`` — or a bare socket path."""
    if "=" not in text:
        return ReplicaSpec(socket_path=text)
    kw: Dict[str, str] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        kw[k.strip()] = v.strip()
    if "sock" not in kw and "tcp" not in kw:
        raise ValueError(
            f"--replica spec needs sock=PATH or tcp=HOST:PORT: {text!r}"
        )
    extra = set(kw) - {"sock", "tcp", "journal", "prom", "name"}
    if extra:
        raise ValueError(f"unknown --replica key(s) {sorted(extra)}")
    return ReplicaSpec(
        socket_path=kw.get("sock"), journal_dir=kw.get("journal"),
        prom_file=kw.get("prom"), name=kw.get("name"),
        tcp=kw.get("tcp"),
    )


class CircuitBreaker:
    """Per-replica failure gate with retry-policy backoff semantics:
    consecutive failures open the circuit for an exponentially growing
    seeded-jitter interval (`RetryPolicy.delay`), any success closes
    it. The attempt index saturates at ``max_attempts - 1`` so a
    long-dead replica keeps being probed at ``max_delay_s`` cadence —
    a breaker that gives up permanently could never notice a replica
    coming back."""

    def __init__(self, label: str, policy: Optional[RetryPolicy] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.policy = policy if policy is not None else policy_from_env()
        self._rng = random.Random(f"{self.policy.seed}:{label}")
        self._clock = clock
        self.failures = 0
        self.open_until = 0.0

    def record_failure(self) -> float:
        attempt = min(self.failures, self.policy.max_attempts - 1)
        delay = self.policy.delay(attempt, self._rng)
        self.failures += 1
        self.open_until = self._clock() + delay
        return delay

    def record_success(self) -> None:
        self.failures = 0
        self.open_until = 0.0

    @property
    def is_open(self) -> bool:
        return self._clock() < self.open_until


@dataclasses.dataclass
class _InFlight:
    """Router-side request state. ``wire`` is the id on the replica
    wire (unique per router lifetime, so journals never fold two client
    requests that happened to reuse an id); ``raw`` is the original
    request object, ``resume`` replaces it after a handoff."""

    wire: str
    public: str
    client: object
    raw: dict
    tenant: Optional[str]
    t_submit: float
    trace: str = ""
    phase: str = "queued"  # "queued" | "dispatched" (req-track phase)
    replica: Optional[int] = None
    resume: Optional[dict] = None
    retries: int = 0
    not_before: float = 0.0
    last_index: Optional[int] = None
    n_tokens: int = 0
    text: str = ""
    first_token_t: Optional[float] = None
    hop: int = 0  # dispatch attempts that reached a replica (span id)
    releasing: bool = False  # a rebalance release ctl is outstanding


class ReplicaLink:
    """One replica's connection + router-visible state. The wire is
    fleet.transport's: a ``FramedConnection`` on a tcp link, a
    ``LineConnection`` on a unix socket."""

    def __init__(self, index: int, spec: ReplicaSpec,
                 policy: Optional[RetryPolicy],
                 clock: Callable[[], float]):
        self.index = index
        self.spec = spec
        self.name = spec.name or f"replica{index}"
        self.breaker = CircuitBreaker(self.name, policy, clock)
        self.conn: Optional[FramedConnection | LineConnection] = None
        self.inflight: Dict[str, _InFlight] = {}
        self.health: Dict[str, float] = {}
        self.health_mtime: Optional[float] = None
        self.health_rx: Optional[float] = None
        # scale-down state: a retired link takes no new work and is
        # never re-dialed; it stays in Router.links so indices (and the
        # journals keyed on them) remain stable across scale cycles
        self.retired = False

    @property
    def up(self) -> bool:
        return self.conn is not None

    def journal_path(self) -> Optional[str]:
        if self.spec.journal_dir is None:
            return None
        return os.path.join(self.spec.journal_dir, "journal.jsonl")

    def connect(self) -> None:
        maybe_inject("router/connect")
        if self.spec.tcp is not None:
            host, port = parse_hostport(self.spec.tcp)
            self.conn = FramedConnection(connect_tcp(host, port),
                                         peer=self.spec.tcp)
            return
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(2.0)
        try:
            s.connect(self.spec.socket_path)
        except BaseException:
            s.close()
            raise
        self.conn = LineConnection(s)

    def close(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass
        self.conn = None

    def send(self, obj: dict) -> None:
        """One request line, framed on tcp (the frame payload is exactly
        the JSONL line: bit-identical wires). A replica that cannot
        drain a few KB in 5 s raises OSError: it is down."""
        assert self.conn is not None
        self.conn.send_line(json.dumps(obj))

    def recv_events(self) -> Tuple[List[dict], bool]:
        """Drain whatever the replica has written: (events, eof). A
        SIGKILLed replica's socket reads EOF — the immediate down
        signal the handoff rides on. A framing violation on a tcp link
        (the decoder condemned the stream) reads as EOF too: a
        corrupted wire gets the same journal-ownership handoff a dead
        replica does."""
        if self.conn is None:
            return [], False
        raws, eof = self.conn.recv_lines()
        events = []
        for raw in raws:
            if not raw.strip():
                continue
            try:
                events.append(json.loads(raw))
            except ValueError:
                continue  # a dying writer may tear its final line
        return events, eof


class Router:
    """Single-threaded request router. The caller owns the loop:
    ``submit()`` requests as they arrive, ``poll()`` every tick, write
    out the (client, event) pairs it returns. Same ownership shape as
    Scheduler — no threads, no locks, deterministic under test."""

    def __init__(self, specs: List[ReplicaSpec], *, max_queue: int = 256,
                 tenant_quota: int = 0,
                 policy: Optional[RetryPolicy] = None,
                 metrics: Optional[ServingMetrics] = None,
                 clock: Callable[[], float] = time.monotonic,
                 heartbeat_timeout: float = 30.0,
                 health_every: float = 2.0,
                 max_redispatch: int = 3,
                 rebalance_max: int = 4):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.policy = policy if policy is not None else policy_from_env()
        self._clock = clock
        self.links = [
            ReplicaLink(i, s, self.policy, clock)
            for i, s in enumerate(specs)
        ]
        self.max_queue = int(max_queue)
        self.tenant_quota = int(tenant_quota)
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.health_every = float(health_every)
        self.max_redispatch = int(max_redispatch)
        self.rebalance_max = int(rebalance_max)
        self.pending: deque[_InFlight] = deque()
        self.by_wire: Dict[str, _InFlight] = {}
        self.draining = False
        self._seq = 0
        self._out: List[Tuple[object, dict]] = []
        self._rng = random.Random(f"{self.policy.seed}:router")
        self._tenants: Dict[str, int] = {}
        self._last_health = -1e9
        # trace ids must be unique across router lifetimes (a journaled
        # trace from a previous run outlives this process), so the mint
        # carries a per-process random tag, not just the wire sequence
        self._trace_tag = uuid.uuid4().hex[:6]
        for fam in ("ttft_s", "latency_s"):
            self.metrics.declare_timing(fam)

    # ----- telemetry -------------------------------------------------------

    def _req_event(self, ph: str, rid: str, name: str,
                   ts: Optional[float] = None,
                   trace: Optional[str] = None, **attrs) -> None:
        rec = {
            "ev": "req", "ph": ph, "name": name, "req": rid,
            "ts": time.time() if ts is None else ts,
        }
        if trace:
            rec["trace_id"] = trace
        if attrs:
            rec.update(attrs)
        get_telemetry().emit(rec)

    def _route(self, status: str, **attrs) -> None:
        """One routing-decision record; None attrs are omitted."""
        rec = {"ev": "route", "ts": time.time(), "status": status}
        rec.update({k: v for k, v in attrs.items() if v is not None})
        get_telemetry().emit(rec)

    def close_tracks(self, reason: str = "killed") -> None:
        """Crash-path teardown: close every open req track so a ``b``
        without its ``e`` still means 'died mid-phase' (the scheduler's
        contract, kept across the fleet)."""
        now = time.time()
        for inf in list(self.by_wire.values()):
            self._req_event("n", inf.wire, reason, ts=now,
                            trace=inf.trace)
            self._req_event("e", inf.wire, inf.phase, ts=now,
                            trace=inf.trace)
            self._req_event("e", inf.wire, "request", ts=now,
                            trace=inf.trace, reason=reason)

    # ----- intake ----------------------------------------------------------

    def submit(self, obj: dict, client: object = None) -> Optional[dict]:
        """Admit one request (parsed JSON object; ``id`` required).
        Returns a rejection event to answer immediately, or None on
        acceptance — tokens/done then stream via ``poll()``."""
        self.metrics.inc("requests_submitted")
        public = obj.get("id")
        if public is None:
            self.metrics.inc("requests_rejected")
            return {"event": "rejected", "id": None,
                    "reason": "bad request line: missing id"}
        public = str(public)

        def reject(reason: str) -> dict:
            self.metrics.inc("requests_rejected")
            self.metrics.inc(f"rejected_{reason}")
            self._route(ROUTE_SHED, req=public, reason=reason)
            return {"event": "rejected", "id": public, "reason": reason}

        if self.draining:
            return reject(REJECT_DRAINING)
        if not self.links:
            return reject(REJECT_NO_REPLICAS)
        if len(self.pending) >= self.max_queue:
            return reject(REJECT_ROUTER_QUEUE_FULL)
        tenant = obj.get("tenant")
        tenant = None if tenant is None else str(tenant)
        if (
            self.tenant_quota > 0
            and tenant is not None
            and self._tenants.get(tenant, 0) >= self.tenant_quota
        ):
            return reject(REJECT_TENANT_QUOTA)
        # wire ids are unique per router lifetime: a client reusing an
        # id after settlement must not fold with the old request in any
        # replica journal
        self._seq += 1
        wire = f"q{self._seq}-{public}"
        # trace context: honor a client-supplied trace_id (upstream
        # propagation), else mint one; it rides the wire, the journal,
        # and every resume from here on
        trace = obj.get("trace_id")
        trace = (
            f"t{self._trace_tag}-{self._seq}" if trace is None
            else str(trace)
        )
        inf = _InFlight(
            wire=wire, public=public, client=client,
            raw={**obj, "id": wire, "trace_id": trace}, tenant=tenant,
            t_submit=self._clock(), trace=trace,
        )
        if tenant is not None:
            self._tenants[tenant] = self._tenants.get(tenant, 0) + 1
        self.pending.append(inf)
        self.by_wire[wire] = inf
        now = time.time()
        self._req_event("b", wire, "request", ts=now, trace=trace,
                        id=public)
        self._req_event("b", wire, "queued", ts=now, trace=trace)
        self.metrics.set_gauge("queue_depth", len(self.pending))
        return None

    # ----- the loop --------------------------------------------------------

    @property
    def has_work(self) -> bool:
        return bool(self.pending) or any(
            link.inflight for link in self.links
        )

    def fds(self) -> List[FramedConnection | LineConnection]:
        """Live replica connections, for the caller's select()."""
        return [link.conn for link in self.links if link.conn is not None]

    def poll(self) -> List[Tuple[object, dict]]:
        """One router tick: maintain connections, read replica events
        (handing off on a death), dispatch pending work, scrape health.
        Returns (client, event) pairs to deliver."""
        now = self._clock()
        for link in self.links:
            if link.retired or link.up or link.breaker.is_open:
                continue
            if self._try_connect(link, now):
                # a replica just turned HEALTHY (fresh spawn, scale-up,
                # or breaker re-probe): proactively migrate a bounded
                # amount of waiting work onto it
                self._rebalance(link, now)
        for link in self.links:
            if not link.up:
                continue
            events, eof = link.recv_events()
            for ev in events:
                self._on_replica_event(link, ev, now)
            if eof:
                self._replica_down(link, "connection_eof", now)
        self._dispatch_pending(now)
        self._scrape_health(now)
        # per-replica scrape-age/staleness gauges: the router scrapes
        # the fleet but used to be a metrics blind spot itself — age of
        # each replica's last prom heartbeat (-1 = never scraped), its
        # up/down bit, and the fleet-wide stale count
        stale = 0
        for link in self.links:
            age = -1.0 if link.health_rx is None else now - link.health_rx
            self.metrics.set_gauge(
                f"replica{link.index}_scrape_age_s", age
            )
            self.metrics.set_gauge(
                f"replica{link.index}_up", 1.0 if link.up else 0.0
            )
            # re-export the load signals scraped for placement, so the
            # fleet collector sees per-replica pressure through the
            # router's exposition even when replica files are remote,
            # and each replica's live checkpoint identity (the deploy
            # controller's convergence). The JAX router also re-exports
            # decode_compile_count: the port compiles nothing per shape,
            # so its replicas publish no such gauge to re-export
            for key in ("queue_depth", "slot_occupancy",
                        "checkpoint_digest"):
                if key in link.health:
                    self.metrics.set_gauge(
                        f"replica{link.index}_{key}", link.health[key]
                    )
            if self._stale(link, now):
                stale += 1
        self.metrics.set_gauge("replicas_stale", stale)
        self.metrics.set_gauge(
            "replicas_up", sum(1 for link in self.links if link.up)
        )
        self.metrics.set_gauge(
            "replicas_retired",
            sum(1 for link in self.links if link.retired),
        )
        self.metrics.set_gauge("queue_depth", len(self.pending))
        self.metrics.set_gauge(
            "inflight", sum(len(link.inflight) for link in self.links)
        )
        out, self._out = self._out, []
        return out

    def drain(self, reason: str = REJECT_DRAINING) -> int:
        """Graceful-shutdown intake cut: shed every queued request now;
        in-flight streams (and any handoffs their replicas' deaths
        require) run to completion. The caller keeps polling until
        ``has_work`` is False."""
        self.draining = True
        n = 0
        now = self._clock()
        while self.pending:
            self._shed(self.pending.popleft(), reason, now)
            n += 1
        self.metrics.set_gauge("queue_depth", 0)
        return n

    # ----- connections & health -------------------------------------------

    def _try_connect(self, link: ReplicaLink, now: float) -> bool:
        try:
            link.connect()
        except (ChaosError, OSError):
            link.breaker.record_failure()
            self.metrics.inc("connect_failures")
            return False
        link.breaker.record_success()
        return True

    def _scrape_health(self, now: float) -> None:
        if now - self._last_health < self.health_every:
            return
        self._last_health = now
        for link in self.links:
            pf = link.spec.prom_file
            if not pf:
                continue
            try:
                mtime = os.stat(pf).st_mtime
                if mtime == link.health_mtime:
                    continue
                with open(pf) as f:
                    link.health = _parse_prom(f.read())
            except (OSError, ValueError):
                continue
            link.health_mtime = mtime
            # the prom rewrite cadence IS the heartbeat
            link.health_rx = now

    def _stale(self, link: ReplicaLink, now: float) -> bool:
        if link.spec.prom_file is None or link.health_rx is None:
            return False
        return (now - link.health_rx) > self.heartbeat_timeout

    # ----- dispatch --------------------------------------------------------

    def _pick_replica(self, now: float) -> Optional[ReplicaLink]:
        """Least-loaded UP replica: router-tracked in-flight plus the
        replica's own scraped queue depth; stale-heartbeat replicas are
        deprioritized; lowest index breaks ties (deterministic)."""
        best = None
        best_key = None
        for link in self.links:
            if not link.up or link.retired:
                continue
            load = len(link.inflight) + int(
                link.health.get("queue_depth", 0)
            )
            key = (1 if self._stale(link, now) else 0, load, link.index)
            if best_key is None or key < best_key:
                best, best_key = link, key
        return best

    def _dispatch_pending(self, now: float) -> None:
        if not self.pending:
            return
        keep: deque[_InFlight] = deque()
        while self.pending:
            inf = self.pending.popleft()
            if inf.not_before > now:
                keep.append(inf)
                continue
            link = self._pick_replica(now)
            if link is None:
                # nobody can take anything this tick
                keep.append(inf)
                keep.extend(self.pending)
                self.pending.clear()
                break
            if not self._send_to(link, inf, now):
                keep.append(inf)
        self.pending = keep
        self.metrics.set_gauge("queue_depth", len(self.pending))

    def _send_to(self, link: ReplicaLink, inf: _InFlight,
                 now: float) -> bool:
        payload = inf.resume if inf.resume is not None else inf.raw
        try:
            # chaos site (PROGEN_CHAOS="router/dispatch:fail@N"): the
            # dispatch path has no span of its own (per-request span
            # records would swamp the trace), so the injector is called
            # directly, like serve/decode
            maybe_inject("router/dispatch")
            link.send(payload)
        except ChaosError:
            # transient: back off and re-route (possibly elsewhere)
            inf.retries += 1
            inf.not_before = now + self.policy.delay(
                min(inf.retries - 1, self.policy.max_attempts - 1),
                self._rng,
            )
            self.metrics.inc("redispatch_retries")
            return False
        except OSError:
            self._replica_down(link, "send_failed", now)
            return False
        link.inflight[inf.wire] = inf
        inf.replica = link.index
        inf.not_before = 0.0
        ts = time.time()
        if inf.phase == "queued":
            self._req_event("e", inf.wire, "queued", ts=ts,
                            trace=inf.trace)
        elif inf.phase == "dispatched":
            # handoff fast path re-dispatches without passing through
            # the queue: close the dead replica's hop so the track stays
            # balanced (every b gets its e) and the journey renders as
            # disjoint hops, not one smeared dispatch
            self._req_event("e", inf.wire, "dispatched", ts=ts,
                            trace=inf.trace)
        inf.hop += 1
        hop_attrs = {"replica": link.index, "hop": inf.hop}
        if inf.resume is not None:
            hop_attrs["resumed"] = True
        self._req_event("b", inf.wire, "dispatched", ts=ts,
                        trace=inf.trace, **hop_attrs)
        inf.phase = "dispatched"
        self.metrics.inc("dispatched_total")
        self._route(
            ROUTE_DISPATCHED, req=inf.public, replica=link.index,
            trace_id=inf.trace, hop=inf.hop,
            retry=inf.retries or None,
            resumed=True if inf.resume is not None else None,
        )
        return True

    def _requeue(self, inf: _InFlight, now: float, backoff: bool = False,
                 front: bool = False) -> None:
        inf.replica = None
        if backoff:
            inf.retries += 1
            inf.not_before = now + self.policy.delay(
                min(inf.retries - 1, self.policy.max_attempts - 1),
                self._rng,
            )
            self.metrics.inc("redispatch_retries")
        if inf.phase == "dispatched":
            ts = time.time()
            self._req_event("e", inf.wire, "dispatched", ts=ts,
                            trace=inf.trace)
            self._req_event("b", inf.wire, "queued", ts=ts,
                            trace=inf.trace)
        inf.phase = "queued"
        if front:
            self.pending.appendleft(inf)
        else:
            self.pending.append(inf)

    # ----- replica events --------------------------------------------------

    def _on_replica_event(self, link: ReplicaLink, ev: dict,
                          now: float) -> None:
        inf = link.inflight.get(ev.get("id"))
        if inf is None:
            return  # an id we no longer own (settled via handoff)
        kind = ev.get("event")
        if kind == "token":
            self._forward_token(inf, ev)
        elif kind == "done":
            link.inflight.pop(inf.wire, None)
            self._settle(inf, now)
        elif kind == "embedding":
            # an embed request's one terminal event: forwarded as it is
            link.inflight.pop(inf.wire, None)
            self._settle(inf, now, final={**ev, "id": inf.public})
        elif kind == "rejected":
            link.inflight.pop(inf.wire, None)
            reason = str(ev.get("reason", "rejected"))
            # a draining replica (scale-down mid-dispatch) is a router
            # problem, not a client problem: retry elsewhere like a
            # momentary queue_full
            if (
                reason in (REJECT_QUEUE_FULL, REJECT_DRAINING)
                and inf.retries < self.max_redispatch
            ):
                self._requeue(inf, now, backoff=True)
            else:
                self._shed(inf, reason, now, replica=link.index)
        elif kind == "released":
            inf.releasing = False
            if not ev.get("released"):
                return  # already decoding there; leave it be
            # the replica dropped the request from its queue and
            # journaled done(handed_off): ownership is the router's
            # again, zero tokens were ever emitted (release only takes
            # queued requests), so a fresh dispatch of the original
            # payload is bit-identical. Front of the queue → the
            # least-loaded pick lands it on the new replica this tick.
            link.inflight.pop(inf.wire, None)
            self.metrics.inc("rebalance_released")
            self._route(ROUTE_HANDOFF, req=inf.public, resumed=False,
                        rebalance=True, trace_id=inf.trace or None,
                        **{"from": link.index})
            self._requeue(inf, now, front=True)

    def _forward_token(self, inf: _InFlight, ev: dict) -> None:
        index = int(ev.get("index", -1))
        if inf.last_index is not None and index <= inf.last_index:
            return  # journal gap-fill already delivered it
        if inf.first_token_t is None:
            inf.first_token_t = self._clock()
            self.metrics.observe("ttft_s", inf.first_token_t - inf.t_submit)
            self._req_event("n", inf.wire, "first_token",
                            trace=inf.trace)
        inf.last_index = index
        inf.n_tokens += 1
        inf.text += str(ev.get("text", ""))
        self.metrics.inc("tokens_forwarded")
        self._out.append((inf.client, {**ev, "id": inf.public}))

    def _settle(self, inf: _InFlight, now: float,
                replayed: bool = False,
                final: Optional[dict] = None) -> None:
        """Request finished: answer the client from the ROUTER's
        accounting (the replica's done only covers its own life; after
        a handoff the full text spans lives), or with ``final``, an
        embed request's embedding event."""
        self.by_wire.pop(inf.wire, None)
        self._tenant_release(inf)
        self.metrics.inc("requests_completed")
        latency = now - inf.t_submit
        self.metrics.observe("latency_s", latency)
        ts = time.time()
        self._req_event("e", inf.wire, inf.phase, ts=ts, trace=inf.trace)
        self._req_event("e", inf.wire, "request", ts=ts, trace=inf.trace,
                        n_generated=inf.n_tokens)
        if final is not None:
            self._out.append((inf.client, final))
            return
        ev = {
            "event": "done", "id": inf.public, "text": inf.text,
            "n_generated": inf.n_tokens,
            "ttft_s": round((inf.first_token_t or now) - inf.t_submit, 6),
            "latency_s": round(latency, 6),
        }
        if replayed:
            ev["replayed"] = True
        self._out.append((inf.client, ev))

    def _shed(self, inf: _InFlight, reason: str, now: float,
              replica: Optional[int] = None) -> None:
        self.by_wire.pop(inf.wire, None)
        self._tenant_release(inf)
        self.metrics.inc("requests_rejected")
        head = reason.split(":")[0].strip().replace(" ", "_")
        self.metrics.inc(f"rejected_{head}")
        ts = time.time()
        self._req_event("n", inf.wire, "shed", ts=ts, trace=inf.trace,
                        reason=reason)
        self._req_event("e", inf.wire, inf.phase, ts=ts, trace=inf.trace)
        self._req_event("e", inf.wire, "request", ts=ts, trace=inf.trace,
                        reason=reason)
        self._route(ROUTE_SHED, req=inf.public, reason=reason,
                    trace_id=inf.trace or None, replica=replica)
        self._out.append((inf.client, {
            "event": "rejected", "id": inf.public, "reason": reason,
        }))

    def _tenant_release(self, inf: _InFlight) -> None:
        if inf.tenant is None:
            return
        left = self._tenants.get(inf.tenant, 1) - 1
        if left <= 0:
            self._tenants.pop(inf.tenant, None)
        else:
            self._tenants[inf.tenant] = left

    # ----- fleet scaling & rebalance ---------------------------------------

    def add_replica(self, spec: ReplicaSpec) -> int:
        """Grow the fleet by one endpoint (autoscaler scale-up). The
        link dials on the next poll; returns its index."""
        index = len(self.links)
        self.links.append(
            ReplicaLink(index, spec, self.policy, self._clock)
        )
        self.metrics.inc("replicas_added")
        return index

    def retire_replica(self, index: int) -> int:
        """Begin graceful scale-down of one replica: no new work goes
        to it, its queued-but-not-decoding requests are released back
        to the router, and in-flight decodes run to completion. The
        caller reaps the process once ``links[index].inflight`` is
        empty (or on its grace deadline — the EOF then rides the
        normal handoff path, so nothing is lost either way). Returns
        the in-flight count at retirement."""
        link = self.links[index]
        link.retired = True
        self.metrics.inc("replicas_retired_total")
        if link.up and link.inflight:
            self._release_from(link, len(link.inflight), self._clock())
        return len(link.inflight)

    def revive_replica(self, index: int) -> None:
        """Un-retire a link (autoscaler scale-up reusing a retired
        slot): the breaker resets and the next poll re-dials it."""
        link = self.links[index]
        link.retired = False
        link.breaker.record_success()

    def _rebalance(self, link: ReplicaLink, now: float) -> None:
        """Proactive migration onto a replica that just turned
        HEALTHY. Router-queued work reaches it by itself (least-loaded
        placement this very tick); what needs help is work already
        QUEUED AT a busy donor. Ask the most-loaded peer to release a
        bounded number of its token-less requests — each release
        travels the journal-ownership path (the donor journals
        ``done(handed_off)`` before answering), so a later replay of
        the donor can never double-serve them."""
        if self.rebalance_max <= 0:
            return
        donor = None
        for other in self.links:
            if other is link or not other.up or other.retired:
                continue
            if donor is None or len(other.inflight) > len(donor.inflight):
                donor = other
        if donor is None:
            return
        gap = len(donor.inflight) - len(link.inflight)
        if gap < 2:
            return  # balanced enough: a migration costs a round-trip
        self._release_from(donor, min(self.rebalance_max, gap // 2), now)

    def _release_from(self, donor: ReplicaLink, n: int,
                      now: float) -> None:
        """Send up to ``n`` release ctls to a live donor. Only
        requests with zero forwarded tokens are candidates — the
        replica-side release only takes QUEUED requests, so a granted
        release guarantees the client saw nothing and a re-dispatch of
        the original payload is bit-identical."""
        victims = [
            inf for inf in donor.inflight.values()
            if inf.n_tokens == 0 and not inf.releasing
        ]
        for inf in victims[:n]:
            try:
                donor.send({"ctl": "release", "id": inf.wire})
            except OSError:
                self._replica_down(donor, "send_failed", now)
                return
            inf.releasing = True
            self.metrics.inc("rebalance_requested")

    # ----- journal-ownership handoff ---------------------------------------

    def _replica_down(self, link: ReplicaLink, why: str,
                      now: float) -> None:
        link.close()
        link.breaker.record_failure()
        inflight = list(link.inflight.values())
        link.inflight.clear()
        self.metrics.inc("replica_down_total")
        self._route(ROUTE_REPLICA_DOWN, replica=link.index, reason=why,
                    in_flight=len(inflight))
        if inflight:
            self._handoff(link, inflight, now)

    def _handoff(self, link: ReplicaLink, inflight: List[_InFlight],
                 now: float) -> None:
        def body() -> None:
            jpath = link.journal_path()
            states: dict = {}
            if jpath is not None and os.path.exists(jpath):
                states = handoff_states(jpath)
            marker = (
                RequestJournal(jpath)
                if jpath is not None and states else None
            )
            try:
                for inf in inflight:
                    self._handoff_one(
                        link, inf, states.get(inf.wire), marker, now
                    )
            finally:
                if marker is not None:
                    marker.close()

        try:
            with span("router/handoff", replica=link.index,
                                in_flight=len(inflight)):
                body()
        except ChaosError:
            # the chaos site fires at span entry; an injected transient
            # fault must not lose the fleet's in-flight work — re-read
            # and re-run (the journal fold is idempotent; nothing was
            # marked or dispatched before the span opened)
            self.metrics.inc("handoff_chaos_retries")
            body()

    def _handoff_one(self, link: ReplicaLink, inf: _InFlight,
                     cls: Optional[dict], marker: Optional[RequestJournal],
                     now: float) -> None:
        self.metrics.inc("handoffs_total")
        if cls is None or cls.get("accept") is None:
            # never journaled: accept-before-ack ordering means the dead
            # replica never emitted a token for it, so a fresh
            # re-dispatch cannot duplicate anything. Without a journal
            # that proof only holds for requests that streamed nothing.
            if link.journal_path() is None and inf.n_tokens > 0:
                self._shed(inf, REJECT_REPLICA_LOST, now,
                           replica=link.index)
                return
            self._route(ROUTE_HANDOFF, req=inf.public, resumed=False,
                        trace_id=inf.trace or None, **{"from": link.index})
            self._requeue(inf, now, front=True)
            return
        # forward journaled-but-unsent tokens: written before the
        # replica could emit them, so the client has never seen them
        start = cls["start"]
        for k, tok in enumerate(cls["emitted"]):
            self._forward_token(inf, {
                "event": "token", "id": inf.wire, "token": int(tok),
                "text": decode_tokens([int(tok)]), "index": start + k,
            })
        if cls["kind"] in ("done", "finished"):
            # the journaled stream is already complete — settle with the
            # client now; 'finished' gets its terminal record so a
            # replay of this journal skips it too
            if marker is not None and cls["kind"] == "finished":
                for jid in cls["jids"]:
                    marker.done(jid, STATUS_COMPLETED, len(cls["emitted"]))
            link.inflight.pop(inf.wire, None)
            self.metrics.inc("handoff_settled")
            self._route(ROUTE_HANDOFF, req=inf.public, resumed=False,
                        settled=True, trace_id=inf.trace or None,
                        **{"from": link.index})
            self._settle(inf, now, replayed=True)
            return
        # mid-stream: fold watermarks into resume state exactly as
        # --replay does, and re-route to a survivor
        inf.resume = resume_payload(resume_request(inf.wire, cls),
                                    inf.trace)
        target = self._pick_replica(now)
        sent = target is not None and self._send_to(target, inf, now)
        if not sent:
            self._requeue(inf, now, front=True)
        # ownership mark AFTER the re-dispatch attempt: from this record
        # on the request is the router's (a restart of the dead replica
        # with --replay must skip it), whether it is already streaming
        # on a survivor or waiting in the router's queue. The mark names
        # the resuming replica so a replay of the dead journal can still
        # reconstruct the journey (router = still queued here).
        if marker is not None:
            for jid in cls["jids"]:
                marker.done(jid, STATUS_HANDED_OFF, len(cls["emitted"]),
                            resumed_by=target.name if sent else "router")
        self.metrics.inc("handoff_resumed")
        self._route(
            ROUTE_HANDOFF, req=inf.public, resumed=True,
            trace_id=inf.trace or None,
            to=target.index if sent else None, **{"from": link.index},
        )


def resume_payload(req, trace: str = "") -> dict:
    """The resume wire for a journal-folded request (``resume_request``):
    the prime and every emitted token as ``prime_tokens``, the seed and
    the draw offset past them, the knobs and length, and an infill's
    buffer-aligned ``template_tokens`` and ``frozen`` or an embed's
    ``embed`` flag. The journaled trace wins over the router's own (they
    differ only when the dead journal predates this router)."""
    out = {
        "id": req.id,
        "trace_id": req.trace_id or trace or None,
        "prime_tokens": [int(t) for t in np.asarray(req.prime).reshape(-1)],
        "length": int(req.length),
        "top_k": None if req.top_k is None else int(req.top_k),
        "add_bos": bool(req.add_bos),
        "temperature": float(req.temperature),
        "top_p": None if req.top_p is None else float(req.top_p),
        "seed": int(req.seed),
        "draw_offset": int(req.draw_offset),
    }
    if req.template is not None:
        out["template_tokens"] = [
            int(t) for t in np.asarray(req.template).reshape(-1)]
        out["frozen"] = [bool(f) for f in np.asarray(req.frozen).reshape(-1)]
    if req.kind == "embed":
        out["embed"] = True
    return out


def _parse_prom(text: str) -> Dict[str, float]:
    """Minimal Prometheus text parse: bare ``name value`` samples, keys
    stripped of the ``progen_serve_`` prefix, an exemplar (`` # {...}
    v``) cut off. Labelled samples (quantiles) are kept under their full
    labelled name; the router reads the bare gauges (``queue_depth``,
    ``slot_occupancy``)."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.split(" # ", 1)[0].strip()
        if not line or line.startswith("#"):
            continue
        name, _, val = line.rpartition(" ")
        if not name:
            continue
        if name.startswith("progen_serve_"):
            name = name[len("progen_serve_"):]
        try:
            out[name] = float(val)
        except ValueError:
            continue
    return out

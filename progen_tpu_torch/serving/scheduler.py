"""FIFO admission scheduling for the slot-pool engine.

The port of the JAX package's ``serving/scheduler.py``. Each decode
step passes the ``serve/decode`` fault-injection site
(``resilience/chaos.py``). ``release`` hands a still-queued request
back to the router (its rebalance and scale-down path).

Continuous batching in the Orca (OSDI '22) sense: admission happens at
token-iteration granularity — every ``step()`` first drains the FIFO
queue into whatever slots just freed, then advances all live slots one
token. A finished request's slot is back in rotation on the very next
step, so the pool stays saturated as long as the queue is non-empty.

Backpressure is explicit: the queue is bounded and ``submit`` answers
(accepted, reason) instead of blocking — a serving front-end must know
*why* it should shed load ("queue_full") versus bounce a bad request
("invalid: ..."). Invalid requests are rejected at submit time (engine
validation, no device work) so they never occupy queue space.

Admission is chunked: the head request becomes a ``PendingPrefill``
(``engine.begin_prefill``, which seeds it from the prefix cache when one
is attached) and ``step()`` feeds at most ``prefill_chunk`` prime
positions per call before advancing the decoders, so a long prompt
admits WHILE the pool keeps streaming. ``prefill_chunk`` 0 feeds every
admission that fits whole before the step decodes, which stalls every
live decode for the full prompt length. At most one prefill is in
flight (FIFO order is preserved: later arrivals
wait behind the head), the slot counts as occupied for the whole
admission (the occupancy gauge counts it),
and chunk progress is deliberately NOT journaled — a crash mid-chunk
replays the accept and re-runs the prefill (or hits the prefix cache),
which is exactly the monolithic crash contract.

Every accepted request is additionally traced through the process
telemetry as ONE async track (``{"ev": "req", "ph": "b"/"n"/"e"}``
records, id = request): a ``request`` envelope containing the
``queued`` → ``prefill`` → ``decode`` lifecycle phases, with instants
for first_token / deadline_exceeded / drain and a slot-occupancy
counter stream. Phases are closed on every exit path, sheds included,
so a ``b`` without its ``e`` in events.jsonl means the process died
mid-phase, as with spans.
Trace timestamps are ``time.time()`` wall clock (the events.jsonl
timebase), independent of the injectable ``clock`` used for deadlines.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, List, Optional, Tuple

import numpy as np

from progen_tpu_torch.resilience.chaos import maybe_inject
from progen_tpu_torch.serving.engine import ServeEngine
from progen_tpu_torch.serving.metrics import ServingMetrics
from progen_tpu_torch.telemetry.spans import get_telemetry

REJECT_QUEUE_FULL = "queue_full"
REJECT_DEADLINE = "deadline_exceeded"
REJECT_DRAINING = "draining"


@dataclasses.dataclass
class Request:
    """One generation request. Its stream is ``sample_fast(seed, ...)``'s
    on this prime, from draw ``draw_offset`` on: a resumed request
    carries the draws its earlier life made (``journal.py``).

    ``deadline_s`` is a queue TTL relative to submit time: a request
    still waiting for a slot past it is expired (reject reason
    ``deadline_exceeded``) instead of admitted — serving a response the
    client has already timed out on just wastes decode steps. Requests
    already on a slot are never expired mid-decode.

    ``kind`` selects the workload: ``"generate"`` (the decode slots) or
    ``"embed"`` (embeddings extraction — answered at admission time with
    one full forward, ``length`` ignored). ``template``/``frozen`` are
    the fixed-position infilling constraint for generate requests
    ((length,) arrays, see workloads/infill.py)."""

    id: str
    prime: object  # 1-D int token ids
    length: int
    top_k: Optional[int] = 25
    add_bos: bool = False
    temperature: float = 1.0
    top_p: Optional[float] = None
    seed: int = 0
    draw_offset: int = 0
    deadline_s: Optional[float] = None
    kind: str = "generate"
    template: object = None  # (length,) int32 or None
    frozen: object = None  # (length,) bool or None
    # cross-process trace context (Dapper-style), supplied over the
    # wire, stamped on every req record and journaled on accept, so a
    # resumed request reattaches to the same trace
    trace_id: Optional[str] = None


@dataclasses.dataclass
class TokenEvent:
    """One streamed token: emitted by ``step()`` the moment the slot's
    decode step produced it."""

    request_id: str
    token: int
    index: int  # position in the (length,) output buffer
    done: bool


@dataclasses.dataclass
class Completion:
    request_id: str
    tokens: np.ndarray  # (length,) truncated like the standalone decoders
    n_generated: int
    ttft_s: float
    latency_s: float
    # embed requests complete with a vector instead of tokens
    embedding: Optional[np.ndarray] = None  # (dim,) float32


@dataclasses.dataclass
class _Active:
    req: Request
    slot: int
    start: int  # primed positions; first generated token lands at ``start``
    t_submit: float
    t_admit: float
    first_token_t: Optional[float] = None
    last_token_t: Optional[float] = None
    n_generated: int = 0


@dataclasses.dataclass
class _PendingAdmission:
    """The head request mid-chunked-prefill: its engine-side state plus
    the timing the scheduler owes the metrics once the slot goes live.
    ``prefill_s`` accumulates the wall time of the chunk calls ONLY —
    the decode steps interleaved between chunks belong to the decoders,
    not this request's prefill_time_s."""

    req: Request
    pp: object  # engine.PendingPrefill
    t_submit: float
    prefill_s: float = 0.0


class Scheduler:
    """Bounded-FIFO front of a ServeEngine. Single-threaded by design:
    the caller owns the loop and calls ``step()`` until ``has_work`` is
    False (or forever, in a server)."""

    def __init__(self, engine: ServeEngine, *, max_queue: int = 64,
                 clock: Callable[[], float] = time.perf_counter,
                 journal=None, prefill_chunk: int = 0,
                 prefix_cache=None):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {prefill_chunk}"
            )
        self.engine = engine
        self.max_queue = int(max_queue)
        # prime positions fed per step() across pending admissions;
        # 0 = unbudgeted (every prefill that fits runs before decode
        # resumes, the monolithic stall profile)
        self.prefill_chunk = int(prefill_chunk)
        self.prefix_cache = prefix_cache
        if prefix_cache is not None:
            engine.set_prefix_cache(prefix_cache)
        self._pending: Optional[_PendingAdmission] = None
        self.metrics = ServingMetrics()
        # optional RequestJournal (serving/journal.py): accepted work is
        # journaled durably before submit() acknowledges it, every token
        # before step() returns it (i.e. before a client can see it),
        # and every settlement (completion OR shed) — the ordering the
        # replay-without-duplicates guarantee rests on
        self.journal = journal
        self._clock = clock
        self._queue: deque[Tuple[Request, float]] = deque()
        self._active: dict[int, _Active] = {}
        # queued requests expired/shed since the last ``pop_expired()``:
        # (request, reason) — the front-end owns client notification
        self._expired: List[Tuple[Request, str]] = []
        # embed completions produced during _admit, delivered by the
        # enclosing step()'s return
        self._embed_done: List[Completion] = []
        self._last_slots_emitted: Optional[int] = None
        # latency families exist (at zero) from construction, so a
        # snapshot carries them before the first request
        for fam in ("ttft_s", "itl_s", "latency_s"):
            self.metrics.declare_timing(fam)
        # slot pressure is a gauge from the start
        self.metrics.set_gauge("slot_occupancy", 0)
        self.metrics.set_gauge("slots_free", self.engine.max_slots)
        self._publish_prefix_gauges()

    def _publish_prefix_gauges(self) -> None:
        """Prefix-cache health as gauges (the ``ev:"prefix_cache"``
        records come from prefix_cache.py): hit/miss/eviction totals and
        the byte/entry footprint the byte budget bounds."""
        if self.prefix_cache is None:
            return
        st = self.prefix_cache.stats()
        self.metrics.set_gauge("prefix_cache_hits", st["hits"])
        self.metrics.set_gauge("prefix_cache_misses", st["misses"])
        self.metrics.set_gauge("prefix_cache_evictions", st["evictions"])
        self.metrics.set_gauge("prefix_cache_bytes", st["bytes"])
        self.metrics.set_gauge("prefix_cache_entries", st["entries"])

    # ----- request tracing ------------------------------------------------

    def _req_event(self, ph: str, rid: str, name: str,
                   ts: Optional[float] = None,
                   trace: Optional[str] = None, **attrs) -> None:
        """One async-lifecycle record on the process telemetry (dropped
        when no sink is configured). ``trace`` is the cross-process trace
        context, stamped as ``trace_id``."""
        rec = {
            "ev": "req", "ph": ph, "name": name, "req": rid,
            "ts": time.time() if ts is None else ts,
        }
        if trace is not None:
            rec["trace_id"] = trace
        if attrs:
            rec.update(attrs)
        get_telemetry().emit(rec)

    def _emit_slots(self) -> None:
        """Slot-occupancy counter sample, on change only. Counts
        acquired slots (``engine.num_active``), not decoding ones: a
        slot mid-chunked-prefill is occupied."""
        n = self.engine.num_active
        if n == self._last_slots_emitted:
            return
        self._last_slots_emitted = n
        self.metrics.set_gauge("slot_occupancy", n)
        self.metrics.set_gauge(
            "slots_free", self.engine.max_slots - n
        )
        get_telemetry().emit({
            "ev": "slots", "ts": time.time(), "in_use": n,
            "free": self.engine.max_slots - n,
        })

    def _reject_traced(self, rid: str, reason: str) -> None:
        """Submit-time rejects never open an async track (nothing was
        accepted); a plain instant on the host track records them."""
        get_telemetry().emit({
            "ev": "request_rejected", "ts": time.time(), "req": rid,
            "reason": reason,
        })

    def _shed_traced(self, req: Request, reason: str,
                     ts: Optional[float] = None) -> None:
        """Close an accepted-but-never-admitted request's track: the
        shed instant, then the still-open queued phase, then the
        envelope. The shed is also a journal settlement — the client
        was told 'rejected', so replay must never resurrect it."""
        ts = time.time() if ts is None else ts
        rid, trace = req.id, req.trace_id
        self._req_event("n", rid, reason, ts=ts, trace=trace)
        self._req_event("e", rid, "queued", ts=ts, trace=trace)
        self._req_event("e", rid, "request", ts=ts, trace=trace,
                        reason=reason)
        if self.journal is not None:
            self.journal.done(rid, reason, 0)

    def close_tracks(self, reason: str = "killed") -> None:
        """Crash-path teardown (second-signal "exit now"): close every
        open per-request async track so the post-mortem trace is honest
        — a ``b`` without its ``e`` should mean the process DIED
        mid-phase, not that it chose to exit. Deliberately NOT a journal
        settlement: these requests were never answered, so replay must
        pick them up."""
        now = time.time()
        if self._pending is not None:
            req = self._pending.req
            self._req_event("n", req.id, reason, ts=now,
                            trace=req.trace_id)
            self._req_event("e", req.id, "prefill", ts=now,
                            trace=req.trace_id)
            self._req_event("e", req.id, "request", ts=now,
                            trace=req.trace_id, reason=reason)
        for slot in sorted(self._active):
            req = self._active[slot].req
            self._req_event("n", req.id, reason, ts=now,
                            trace=req.trace_id)
            self._req_event("e", req.id, "decode", ts=now,
                            trace=req.trace_id)
            self._req_event("e", req.id, "request", ts=now,
                            trace=req.trace_id, reason=reason)
        for req, _ in self._queue:
            self._req_event("n", req.id, reason, ts=now,
                            trace=req.trace_id)
            self._req_event("e", req.id, "queued", ts=now,
                            trace=req.trace_id)
            self._req_event("e", req.id, "request", ts=now,
                            trace=req.trace_id, reason=reason)

    # ----- intake ---------------------------------------------------------

    def submit(self, req: Request) -> Tuple[bool, Optional[str]]:
        """(accepted, reason). ``reason`` is None on accept,
        ``"queue_full"`` under backpressure, or ``"invalid: ..."`` when
        the engine can never serve the request."""
        self.metrics.inc("requests_submitted")
        try:
            if req.kind == "embed":
                # embeds run one full forward, no decode slot: the only
                # bound is the model's context window
                n = len(np.asarray(req.prime).reshape(-1))
                n += 1 if req.add_bos else 0
                if not 1 <= n <= self.engine.model.config.seq_len:
                    raise ValueError(
                        f"embed prime must be 1..seq_len="
                        f"{self.engine.model.config.seq_len} tokens, got {n}"
                    )
            elif req.kind == "generate":
                self.engine.validate(
                    req.prime, req.length, add_bos=req.add_bos,
                    temperature=req.temperature, top_p=req.top_p,
                    top_k=req.top_k, template=req.template,
                    frozen=req.frozen,
                )
            else:
                raise ValueError(f"unknown request kind {req.kind!r}")
        except ValueError as e:
            self.metrics.inc("requests_rejected")
            self.metrics.inc("rejected_invalid")
            self._reject_traced(req.id, "invalid")
            return False, f"invalid: {e}"
        if req.deadline_s is not None and req.deadline_s <= 0:
            self.metrics.inc("requests_rejected")
            self.metrics.inc("rejected_invalid")
            self._reject_traced(req.id, "invalid")
            return False, ("invalid: deadline_s must be > 0, got "
                           f"{req.deadline_s}")
        if len(self._queue) >= self.max_queue:
            self.metrics.inc("requests_rejected")
            self.metrics.inc("rejected_queue_full")
            self._reject_traced(req.id, REJECT_QUEUE_FULL)
            return False, REJECT_QUEUE_FULL
        self._queue.append((req, self._clock()))
        self.metrics.set_gauge("queue_depth", len(self._queue))
        now = time.time()
        self._req_event("b", req.id, "request", ts=now,
                        trace=req.trace_id, length=int(req.length))
        self._req_event("b", req.id, "queued", ts=now,
                        trace=req.trace_id)
        if self.journal is not None:
            # durable before acknowledged: once the caller sees True,
            # the request survives any kill via --replay
            self.journal.accept(req)
        return True, None

    # ----- the loop -------------------------------------------------------

    @property
    def has_work(self) -> bool:
        return (
            bool(self._queue)
            or bool(self._active)
            or self._pending is not None
        )

    def _expire_queued(self, now: float) -> None:
        """Shed queued requests whose deadline passed BEFORE admission —
        after a stall or a burst, the head of the queue can be entirely
        dead air, and admitting it would spend prefill+decode on clients
        that already hung up."""
        if not any(req.deadline_s is not None for req, _ in self._queue):
            return
        kept: deque[Tuple[Request, float]] = deque()
        for req, t_submit in self._queue:
            if (
                req.deadline_s is not None
                and now - t_submit >= req.deadline_s
            ):
                self.metrics.inc("requests_expired")
                self.metrics.inc("requests_rejected")
                self.metrics.inc("rejected_deadline_exceeded")
                self._expired.append((req, REJECT_DEADLINE))
                self._shed_traced(req, REJECT_DEADLINE)
            else:
                kept.append((req, t_submit))
        self._queue = kept
        self.metrics.set_gauge("queue_depth", len(self._queue))

    def pop_expired(self) -> List[Tuple[Request, str]]:
        """(request, reason) pairs shed from the queue since the last
        call — expired deadlines and drains; the caller notifies the
        owners."""
        out, self._expired = self._expired, []
        return out

    def drain_queue(self, reason: str = REJECT_DRAINING) -> int:
        """Graceful-shutdown intake cut: reject every QUEUED request
        (surfaced via ``pop_expired``) while in-flight slots keep
        decoding. Returns how many were shed."""
        n = len(self._queue)
        while self._queue:
            req, _ = self._queue.popleft()
            self.metrics.inc("requests_rejected")
            self.metrics.inc(f"rejected_{reason}")
            self._expired.append((req, reason))
            self._shed_traced(req, reason)
        self.metrics.set_gauge("queue_depth", 0)
        return n

    def release(self, request_id: str) -> bool:
        """Surrender one still-queued request to the caller (the router's
        rebalance or scale-down path). Only a queued request can go: one
        on a slot, or mid-prefill, has device work in it and may have
        streamed tokens, so it finishes here. A granted release is a
        journal settlement (``done(handed_off)``, the mark the router
        writes when it folds a dead journal), so a later ``--replay`` of
        this process skips it. True iff the request was released."""
        kept: deque[Tuple[Request, float]] = deque()
        released = None
        for req, t_submit in self._queue:
            if released is None and req.id == request_id:
                released = req
            else:
                kept.append((req, t_submit))
        if released is None:
            return False
        self._queue = kept
        self.metrics.inc("requests_released")
        self.metrics.set_gauge("queue_depth", len(self._queue))
        now = time.time()
        self._req_event("n", released.id, "released", ts=now,
                        trace=released.trace_id)
        self._req_event("e", released.id, "queued", ts=now,
                        trace=released.trace_id)
        self._req_event("e", released.id, "request", ts=now,
                        trace=released.trace_id, reason="released")
        if self.journal is not None:
            # journal.STATUS_HANDED_OFF (journal.py imports this module)
            self.journal.done(released.id, "handed_off", 0,
                              resumed_by="router")
        return True

    def _serve_embed(self, req: Request, t_submit: float) -> None:
        """Answer an embed request at admission time: one full forward,
        no decode slot occupied, completion delivered by the next
        ``step()`` return. Runs inline in the admission loop — strictly
        FIFO with generation (an embed behind a queued generate waits its
        turn, same as a slot would)."""
        w0 = time.time()
        self._req_event("e", req.id, "queued", ts=w0, trace=req.trace_id)
        self._req_event("b", req.id, "embed", ts=w0, trace=req.trace_id)
        t0 = self._clock()
        vec = self.engine.embed(req.prime, add_bos=req.add_bos)
        t1 = self._clock()
        w1 = time.time()
        self._req_event("e", req.id, "embed", ts=w1, trace=req.trace_id)
        self._req_event("e", req.id, "request", ts=w1, trace=req.trace_id,
                        dim=int(vec.shape[0]))
        self.metrics.inc("embed_requests")
        self.metrics.add_time("embed_time_s", t1 - t0)
        self.metrics.observe("latency_s", t1 - t_submit,
                             trace_id=req.trace_id)
        if self.journal is not None:
            self.journal.done(req.id, "completed", 0)
        self._embed_done.append(
            Completion(
                request_id=req.id,
                tokens=np.zeros((0,), np.int32),
                n_generated=0,
                ttft_s=t1 - t_submit,
                latency_s=t1 - t_submit,
                embedding=vec,
            )
        )

    def _admit(self) -> None:
        """Start the head request's admission on a free slot, answering
        the embed requests ahead of it. At most ONE admission is in
        flight (FIFO: later arrivals queue behind the head)."""
        while self._pending is None and self._queue:
            if self._queue[0][0].kind == "embed":
                req, t_submit = self._queue.popleft()
                self._serve_embed(req, t_submit)
                continue
            slot = self.engine.acquire()
            if slot is None:
                break
            req, t_submit = self._queue.popleft()
            w0 = time.time()
            self._req_event("e", req.id, "queued", ts=w0,
                            trace=req.trace_id)
            self._req_event("b", req.id, "prefill", ts=w0,
                            trace=req.trace_id, slot=slot)
            # no device work yet: _pump_admissions feeds the prime
            # between decode steps
            pp = self.engine.begin_prefill(
                slot, req.prime, req.length, top_k=req.top_k,
                add_bos=req.add_bos, temperature=req.temperature,
                top_p=req.top_p, seed=req.seed,
                draw_offset=req.draw_offset, request_id=req.id,
                template=req.template, frozen=req.frozen,
            )
            self._pending = _PendingAdmission(req, pp, t_submit)
        self.metrics.set_gauge("queue_depth", len(self._queue))
        self.metrics.set_gauge("active_slots", len(self._active))
        self._emit_slots()

    def _activate(self, pa: _PendingAdmission) -> None:
        """A pending prefill finished its last chunk: the slot is live
        in the pool; open its decode phase and settle admission
        metrics."""
        self._pending = None
        req, pp = pa.req, pa.pp
        t1 = self._clock()
        w1 = time.time()
        self._req_event("e", req.id, "prefill", ts=w1,
                        trace=req.trace_id)
        self._req_event("b", req.id, "decode", ts=w1,
                        trace=req.trace_id, slot=pp.slot)
        self._active[pp.slot] = _Active(
            req, pp.slot, pp.start, pa.t_submit, t1
        )
        self.metrics.inc("requests_admitted")
        # only positions actually fed through the model count — a
        # prefix-cache hit skipped the first hit_depth of them
        self.metrics.inc(
            "prefill_tokens", max(pp.start - 1 - pp.hit_depth, 0)
        )
        if pp.hit_depth > 0:
            self.metrics.inc("prefix_cache_hit_tokens", pp.hit_depth)
        self.metrics.add_time("prefill_time_s", pa.prefill_s)

    def _pump_admissions(self) -> None:
        """One step's admission work: start new admissions, then feed
        at most ``prefill_chunk`` prime positions (unbounded when 0)
        across pending prefills — the budget is per STEP, not per
        request, so a chain of tiny primes cannot stall decode any
        longer than one long one. A prefix-cache full hit costs zero
        budget and activates immediately."""
        self._admit()
        if self._pending is None:
            return
        budget = self.prefill_chunk if self.prefill_chunk > 0 else None
        spent = 0
        while self._pending is not None:
            allow = None
            if budget is not None:
                allow = budget - spent
                if allow <= 0:
                    break
            pa = self._pending
            before = pa.pp.pos
            t0 = self._clock()
            done = self.engine.advance_prefill(pa.pp, allow)
            pa.prefill_s += self._clock() - t0
            spent += pa.pp.pos - before
            if not done:
                break
            self._activate(pa)
            self._admit()
        self._publish_prefix_gauges()

    def step(self) -> Tuple[List[TokenEvent], List[Completion]]:
        """Admit what fits, then advance every live slot one token.
        Returns the tokens produced this step (streaming order =
        slot order, stable) and any requests that finished. Expired
        queued requests are shed first (check ``pop_expired()``) so a
        dead deadline never consumes a freed slot."""
        self._expire_queued(self._clock())
        self._pump_admissions()
        embed_done, self._embed_done = self._embed_done, []
        if not self._active:
            return [], embed_done
        # chaos site (PROGEN_CHAOS="serve/decode:kill@N"): decode has no
        # span of its own (a span a token would swamp the trace), so the
        # injector is called directly
        maybe_inject("serve/decode")
        t0 = self._clock()
        sampled, was_live, finished = self.engine.decode_step()
        t1 = self._clock()
        now = t1
        events: List[TokenEvent] = []
        completions: List[Completion] = []
        n_live = 0
        for slot in sorted(self._active):
            rec = self._active[slot]
            if not was_live[slot]:
                continue
            n_live += 1
            rec.n_generated += 1
            if rec.first_token_t is None:
                rec.first_token_t = now
                self.metrics.observe("ttft_s", now - rec.t_submit,
                                     trace_id=rec.req.trace_id)
                self._req_event("n", rec.req.id, "first_token",
                                trace=rec.req.trace_id)
            else:
                # inter-token latency: gap between consecutive tokens
                # of THIS request (== decode-step period while the slot
                # stays live, but attributed per request)
                self.metrics.observe("itl_s", now - rec.last_token_t)
            rec.last_token_t = now
            done = bool(finished[slot])
            events.append(
                TokenEvent(
                    rec.req.id,
                    int(sampled[slot]),
                    rec.start + rec.n_generated - 1,
                    done,
                )
            )
            if done:
                completions.append(self._finish(slot, rec, now))
        if self.journal is not None:
            # watermarks are journaled BEFORE step() returns — a token a
            # client ever saw is always in the journal, so replay can
            # never emit a (request, index) twice
            for ev in events:
                self.journal.token(ev.request_id, ev.index, ev.token)
            for c in completions:
                self.journal.done(c.request_id, "completed",
                                  c.n_generated)
        self.metrics.inc("decode_steps")
        self.metrics.inc("decode_tokens", n_live)
        self.metrics.add_time("decode_time_s", t1 - t0)
        self.metrics.set_gauge("active_slots", len(self._active))
        return events, embed_done + completions

    def _finish(self, slot: int, rec: _Active, now: float) -> Completion:
        tokens = self.engine.collect(slot)
        self.engine.release(slot)
        del self._active[slot]
        self.metrics.inc("requests_completed")
        self.metrics.observe("latency_s", now - rec.t_submit,
                             trace_id=rec.req.trace_id)
        done_t = time.time()
        self._req_event("e", rec.req.id, "decode", ts=done_t,
                        trace=rec.req.trace_id)
        self._req_event("e", rec.req.id, "request", ts=done_t,
                        trace=rec.req.trace_id,
                        n_generated=rec.n_generated)
        self._emit_slots()
        return Completion(
            request_id=rec.req.id,
            tokens=tokens,
            n_generated=rec.n_generated,
            ttft_s=(rec.first_token_t or now) - rec.t_submit,
            latency_s=now - rec.t_submit,
        )

    def run_to_completion(self, max_steps: Optional[int] = None):
        """Drain queue and slots; for tests and the smoke script.
        Returns (all events, all completions) in production order."""
        events: List[TokenEvent] = []
        completions: List[Completion] = []
        steps = 0
        while self.has_work:
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"run_to_completion exceeded {max_steps} steps with "
                    f"work remaining (queue={len(self._queue)}, "
                    f"active={len(self._active)})"
                )
            ev, comp = self.step()
            events.extend(ev)
            completions.extend(comp)
            steps += 1
        return events, completions

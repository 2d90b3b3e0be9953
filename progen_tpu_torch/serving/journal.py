"""Request replay journal: crash-safe accounting of accepted work.

The port of the JAX package's ``serving/journal.py``. Three append-only
record kinds in ``journal.jsonl``:

    {"ev": "journal", "op": "accept", "req": ..., "prime": [...],
     "length": ..., "seed": s, "draw_offset": d, ...}  # full resume state
    {"ev": "journal", "op": "token", "req": ..., "index": i, "token": t}
    {"ev": "journal", "op": "done", "req": ..., "status": "completed"}

One ``write+flush`` per line under a lock, so a SIGKILL tears at most
the final line, which ``iter_jsonl`` skips (and counts) on read. The
scheduler journals a token before the front end shows it to a client,
so any token a client saw is in the journal and replay never emits a
journaled index again.

Replay (``replay_requests`` / ``replay_into``) rebuilds every accepted
request with no ``done`` record and resumes it by prefilling prompt plus
the tokens already emitted. A slot's draw t is a function of its seed
and t alone (``draw_seed(seed, t)``, ``sampling.py``), so starting the
resumed request at ``draw_offset + n_emitted`` makes its stream equal to
the uninterrupted one. Resumed requests are journaled again as fresh
accepts (the longer prime, the later offset), so a second crash replays
from the second accept.

The journal is also the unit of ownership in a fleet of replicas
(``serving/router.py``): a request belongs to whichever journal holds
its unsettled ``accept``. When a replica dies, the router folds its
journal (``handoff_states``), sends the unfinished requests to a
survivor and appends a ``done`` record with status ``handed_off``, so a
restart with ``--replay`` never answers them again.
"""

from __future__ import annotations

import json
import re
import threading
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from progen_tpu_torch.serving.scheduler import Request
from progen_tpu_torch.telemetry.spans import get_telemetry
from progen_tpu_torch.telemetry.trace import LineDrops, iter_jsonl

STATUS_COMPLETED = "completed"
# ownership moved to the router: settled here, answered elsewhere
STATUS_HANDED_OFF = "handed_off"


class RequestJournal:
    """Append-only journal of request acceptance, emitted-token
    watermarks, and completion. One instance per serve process; safe to
    call from the loop thread and signal handlers (per-line critical
    section, reentrant lock)."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = self.path.open("a")
        self._lock = threading.RLock()

    def emit(self, record: dict) -> None:
        """One journal line, flushed before return — after ``accept``
        returns, the request survives any kill; after ``token`` returns,
        the token may be shown to a client."""
        with self._lock:
            if self._f.closed:
                return
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()

    def accept(self, req: Request) -> None:
        """Journal everything needed to re-create ``req`` from nothing."""
        self.emit({
            "ev": "journal", "op": "accept", "ts": time.time(),
            "req": str(req.id),
            "prime": [int(t) for t in np.asarray(req.prime).reshape(-1)],
            "length": int(req.length),
            "top_k": None if req.top_k is None else int(req.top_k),
            "add_bos": bool(req.add_bos),
            "temperature": float(req.temperature),
            "top_p": None if req.top_p is None else float(req.top_p),
            "seed": int(req.seed),
            "draw_offset": int(req.draw_offset),
            "deadline_s": req.deadline_s,
            "kind": req.kind,
            # journaled so a --replay reattaches the resumed stream to
            # the same trace
            "trace_id": req.trace_id,
            "template": (
                None if req.template is None
                else [int(t) for t in np.asarray(req.template).reshape(-1)]
            ),
            "frozen": (
                None if req.frozen is None
                else [bool(b) for b in np.asarray(req.frozen).reshape(-1)]
            ),
        })

    def token(self, request_id: str, index: int, token: int) -> None:
        self.emit({
            "ev": "journal", "op": "token", "ts": time.time(),
            "req": str(request_id), "index": int(index),
            "token": int(token),
        })

    def done(self, request_id: str, status: str,
             n_generated: int = 0,
             resumed_by: Optional[str] = None) -> None:
        """Terminal record: ``completed``, ``handed_off``, or a shed
        reason (``deadline_exceeded``/``draining``); either way the
        request is settled with its client and is never replayed.
        ``resumed_by`` names the replica a ``handed_off`` request went to
        (``router`` while it waits in the router's queue)."""
        rec = {
            "ev": "journal", "op": "done", "ts": time.time(),
            "req": str(request_id), "status": str(status),
            "n_generated": int(n_generated),
        }
        if resumed_by is not None:
            rec["resumed_by"] = str(resumed_by)
        self.emit(rec)

    def close(self) -> None:
        with self._lock:
            self._f.close()


def _read_state(path, drops: Optional[LineDrops] = None,
                normalize=None) -> dict:
    """Fold the journal into per-request state. Re-accepts (a replayed
    run journals resumed requests again) overwrite the resume
    parameters; token watermarks accumulate by index across accepts (the
    indices of successive rounds never overlap, because each re-accept
    folds the earlier tokens into its prime). ``normalize`` rewrites the
    ids before the fold (the router strips the connection namespace, so
    accepts over two connections fold as one request's)."""
    state: dict = {}
    for rec in iter_jsonl(path, drops):
        if rec.get("ev") != "journal":
            continue
        rid = rec.get("req")
        if normalize is not None:
            rid = normalize(rid)
        entry = state.setdefault(
            rid, {"accept": None, "tokens": {}, "done": None}
        )
        op = rec.get("op")
        if op == "accept":
            entry["accept"] = rec
        elif op == "token":
            entry["tokens"][int(rec["index"])] = int(rec["token"])
        elif op == "done":
            entry["done"] = rec
    return state


def _classify(entry: dict) -> dict:
    """One folded request (with an ``accept``) -> resume state. ``kind``
    is ``done`` (a terminal record), ``finished`` (the journaled stream
    already meets the stop rule: it reached its length, or emitted the
    second zero) or ``pending`` (resumable mid-stream). ``start`` is the
    index of the first token this accept emits."""
    acc = entry["accept"]
    prime = [int(t) for t in acc["prime"]]
    add_bos = bool(acc.get("add_bos", False))
    start = len(prime) + (1 if add_bos else 0)
    # contiguous emitted run from this accept's first write position
    emitted: List[int] = []
    while start + len(emitted) in entry["tokens"]:
        emitted.append(entry["tokens"][start + len(emitted)])
    length = int(acc["length"])
    zeros = (
        (1 if add_bos else 0)
        + sum(1 for t in prime if t == 0)
        + sum(1 for t in emitted if t == 0)
    )
    if entry["done"] is not None:
        kind = "done"
    elif acc.get("kind") == "embed":
        # embeds emit no tokens (start >= length would settle them as
        # finished): an unsettled embed accept is always resumable
        kind = "pending"
    elif start + len(emitted) >= length or zeros >= 2:
        kind = "finished"
    else:
        kind = "pending"
    return {"kind": kind, "accept": acc, "emitted": emitted,
            "start": start, "length": length, "done": entry["done"]}


def resume_request(rid: str, cls: dict) -> Request:
    """The resubmittable Request for a ``pending`` classification: prime
    = the original prime + every journaled token, the draw offset moved
    past the emitted tokens, the same length and knobs, so the resumed
    stream equals the uninterrupted one. The deadline is dropped: it
    measured the queue wait of the dead process."""
    acc = cls["accept"]
    prime = [int(t) for t in acc["prime"]]
    template = acc.get("template")
    frozen = acc.get("frozen")
    return Request(
        id=rid,
        prime=np.asarray(prime + cls["emitted"], np.int64),
        length=cls["length"],
        top_k=acc.get("top_k"),
        add_bos=bool(acc.get("add_bos", False)),
        temperature=float(acc.get("temperature", 1.0)),
        top_p=acc.get("top_p"),
        seed=int(acc["seed"]),
        draw_offset=int(acc["draw_offset"]) + len(cls["emitted"]),
        deadline_s=None,
        kind=acc.get("kind", "generate"),
        template=None if template is None else np.asarray(template, np.int64),
        frozen=None if frozen is None else np.asarray(frozen, bool),
        trace_id=acc.get("trace_id"),
    )


# socket transports journal ids namespaced by connection: "{fd}:{id}"
_CONN_NS_RE = re.compile(r"^\d+:")


def handoff_states(path, drops: Optional[LineDrops] = None) -> dict:
    """The router's ownership view of a (dead) replica's journal: every
    journaled request classified for handoff, ``{rid: cls}`` with ``cls``
    the ``_classify`` output plus ``"jids"``: the raw (connection-
    namespaced) journal ids that contributed, against which a
    ``handed_off`` mark must be written so a later ``--replay`` of the
    same journal skips them. Ids are normalised by stripping the
    ``{fd}:`` namespace, so a request the router sent to the same
    replica again over a later connection folds with its first accept,
    as an in-process re-accept does."""
    jids: dict = {}

    def norm(rid):
        rid = str(rid)
        base = rid.split(":", 1)[1] if _CONN_NS_RE.match(rid) else rid
        jids.setdefault(base, set()).add(rid)
        return base

    out: dict = {}
    for rid, entry in _read_state(path, drops, normalize=norm).items():
        if entry["accept"] is None:
            if entry["done"] is None:
                continue  # tokens without an accept: torn journal head
            cls = {"kind": "done", "accept": None, "emitted": [],
                   "start": 0, "length": 0, "done": entry["done"]}
        else:
            cls = _classify(entry)
        cls["jids"] = sorted(jids.get(rid, {rid}))
        out[rid] = cls
    return out


def replay_requests(
    path, drops: Optional[LineDrops] = None
) -> Tuple[List[Request], List[dict], int]:
    """Reconstruct unfinished work from a journal.

    Returns ``(pending, finished, n_done)``:
      * ``pending`` — Requests ready to resubmit (``resume_request``);
      * ``finished`` — requests whose journaled stream already satisfies
        the stop rule (hit length, or emitted the second zero) but died
        before the ``done`` record: nothing to decode, the caller
        settles them with ``emitted`` as the generated suffix;
      * ``n_done`` — requests with a terminal record, skipped entirely
        (the dedup half of the no-duplicate guarantee).
    """
    pending: List[Request] = []
    finished: List[dict] = []
    n_done = 0
    for rid, entry in _read_state(path, drops).items():
        if entry["done"] is not None:
            n_done += 1
            continue
        if entry["accept"] is None:
            continue  # tokens without an accept: torn journal head
        cls = _classify(entry)
        if cls["kind"] == "finished":
            finished.append(
                {"id": rid, "emitted": cls["emitted"],
                 "accept": cls["accept"]}
            )
        else:
            pending.append(resume_request(rid, cls))
    return pending, finished, n_done


def replay_into(scheduler, path) -> dict:
    """Resubmit a journal's unfinished work into a (fresh) scheduler.
    Requests that already satisfied their stop rule are settled
    directly: a ``done`` journal record is written so a second replay
    skips them, and they are returned for the front-end to answer.
    Returns ``{"resumed": [Request...], "finished": [{"id", "emitted"}],
    "skipped_done": n, "rejected": [(id, reason)], "dropped_lines": n}``.
    """
    drops = LineDrops()
    pending, finished, n_done = replay_requests(path, drops)
    resumed: List[Request] = []
    rejected: List[Tuple[str, str]] = []
    for req in pending:
        ok, reason = scheduler.submit(req)
        if ok:
            resumed.append(req)
        else:
            rejected.append((req.id, reason or "rejected"))
    journal = scheduler.journal
    if journal is not None:
        for f in finished:
            journal.done(f["id"], STATUS_COMPLETED, 0)
    scheduler.metrics.inc("journal_replayed", len(resumed))
    get_telemetry().emit({
        "ev": "journal_replay", "ts": time.time(),
        "resumed": len(resumed), "finished": len(finished),
        "skipped_done": n_done, "rejected": len(rejected),
        "dropped_lines": drops.count,
    })
    return {
        "resumed": resumed,
        "finished": finished,
        "skipped_done": n_done,
        "rejected": rejected,
        "dropped_lines": drops.count,
    }

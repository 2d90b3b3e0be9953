"""Serving CLI: the continuous-batching engine loop against a checkpoint,
the port of the JAX package's ``cli/serve.py``.

Runs the slot-pool engine (``progen_tpu_torch/serving/``) as a
single-threaded event loop. Requests arrive as JSON lines, one object a
request:

    {"id": "r1", "prime": "[tax=Mammalia] #", "length": 256,
     "temperature": 0.8, "top_p": 0.95, "top_k": 25, "seed": 7}

(``id`` and ``prime`` required; ``length`` defaults to --max-len, the
knobs and ``seed`` to their flags.) The resume wire adds three optional
fields: ``prime_tokens`` (raw token ids, bypassing the tokenizer),
``draw_offset`` (the first draw of the seed's stream, default 0) and
``add_bos`` (default true); with them a request continues another
process's stream exactly (the router's handoff sends them). Two
protein-design shapes ride the same wire:

    {"id": "f1", "template": "MK?LV??G", "free_char": "?", ...}
    {"id": "e1", "prime": "[tax=Mammalia] # MKLV", "embed": true}

``template`` is fixed-position infilling (``workloads/infill.py``):
frozen characters are kept, ``free_char`` positions are sampled; the
leading frozen run becomes the prime and the template's width the
length (the resume wire may carry buffer-aligned ``template_tokens`` and
``frozen`` lists instead). ``embed: true`` asks for the mean-pooled
final-norm embedding of the prime. Responses stream back as JSON lines,
interleaved across requests as the engine produces them:

    {"event": "token", "id": "r1", "token": 77, "text": "L", "index": 18}
    {"event": "done", "id": "r1", "text": "...", "n_generated": 238,
     "ttft_s": 0.01, "latency_s": 0.9}
    {"event": "embedding", "id": "e1", "dim": 1024, "values": [...],
     "latency_s": 0.02}
    {"event": "rejected", "id": "r9", "reason": "queue_full"}

Three transports, one protocol:
  * default: requests on stdin, events on stdout (EOF drains the queue
    and exits);
  * ``--socket PATH``: a unix-socket server; each connection submits
    requests and receives exactly its own events;
  * ``--tcp HOST:PORT``: the same over framed TCP (``fleet/transport.py``:
    every frame's payload is exactly one of these lines, so streams are
    the same as over the unix socket, and the journal, replay and
    handoff work unchanged). PORT 0 binds an ephemeral port, printed on
    stderr as "listening on tcp HOST:PORT"; ``--idle_timeout`` drops a
    peer silent for longer.

The connection transports also answer a control line,
``{"ctl": "release", "id": ...}``: the router asking this replica to
give back one still-queued request (``{"event": "released", "id": ...,
"released": true|false}``; a granted release is journaled
``done(handed_off)``, so --replay skips it).

The first SIGTERM or SIGINT closes intake, sheds the queue
(``rejected: draining``) and lets the slots finish; a second exits at
once. SIGHUP loads the newest verified checkpoint on a background
thread and copies it into the served model between two decode steps
(``serving/reload.py``; "reload: now serving ckpt_N" on stderr), with
no request dropped; ``--reload_watch N`` polls the checkpoint directory
every N seconds and reloads a newer checkpoint by itself;
``--reload_pin FILE`` names the checkpoint to serve (restored at start,
loaded by the poll, answered through FILE.ack). ``--journal_dir DIR``
journals accepted requests and emitted tokens to DIR/journal.jsonl, and
a later ``--replay DIR`` resumes every unfinished accepted request with
its uninterrupted stream (a slot's draw t is ``draw_seed(seed, t)``, so
the journal carries a draw offset, not a key). ``--int8`` serves int8
weight-quantised matrix products and prints the calibration line
"int8 weights: ..." to stderr. ``PROGEN_CHAOS`` arms the fault sites
(``serve/prefill``, ``serve/prefill_chunk``, ``serve/decode``,
``serve/reload``, ``serve/reload_commit``, ``transport/accept``,
``transport/frame``). ``--prom_file`` writes the metrics' Prometheus
exposition (prefix ``progen_serve_``; on the ``--metrics-every``
cadence and at exit, and at least every ``--heartbeat`` seconds when
set), with the process's own kernel launches as
``progen_serve_kernel_launches_<id>`` gauges (the embed forwards' A1,
L1 and L2 on the card; the plain versions on the CPU count none) and
the served checkpoint's identity as ``progen_serve_checkpoint_digest``
(the first 48 bits of ``checkpoint_digest``, rewritten on every
committed reload: the deploy controller's and the router's view);
``--prom_port`` serves it over HTTP on localhost. ``--flight_dir``
arms the flight recorder (``telemetry/flight.py``: a ring of recent
records, dumped atomically on a chaos kill, a stall escalation, an SLO
``burning`` edge, an unhandled exception or a second signal);
``--profile_pin FILE`` opens a bounded ``torch.profiler`` window on the
live loop when a token is written there (polled between decode steps,
answered through FILE.ack, traces under ``--profile_out``).

Run: python -m progen_tpu_torch.cli.serve --checkpoint_path ./ckpts
"""

from __future__ import annotations

import argparse
import json
import os
import select
import signal
import socket
import sys
import time

import numpy as np

from progen_tpu_torch._device import resolve_device
from progen_tpu_torch.checkpoint import checkpoint_digest, digest_gauge
from progen_tpu_torch.cli.eval import load_model
from progen_tpu_torch.data.tokenizer import decode_tokens, encode_tokens
from progen_tpu_torch.fleet.transport import (
    FramedListener,
    UnixListener,
    parse_hostport,
)
from progen_tpu_torch.ops import launches
from progen_tpu_torch.resilience.chaos import install_from_env
from progen_tpu_torch.serving import (
    PrefixCache,
    Request,
    RequestJournal,
    Scheduler,
    ServeEngine,
    WeightReloader,
    replay_into,
)
from progen_tpu_torch.telemetry import flight as flight_mod
from progen_tpu_torch.telemetry import (
    prometheus_text,
    spans,
    start_prometheus_server,
    write_prometheus,
)
from progen_tpu_torch.tracking import JsonlTracker
from progen_tpu_torch.workloads.infill import (
    infill_request_arrays,
    parse_template,
)

def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="progen_tpu_torch.cli.serve", allow_abbrev=False,
        description="Serve generation and embedding requests from the "
                    "newest checkpoint over stdin/stdout JSON lines.")
    p.add_argument("--checkpoint_path", default="./ckpts")
    p.add_argument("--max-slots", dest="max_slots", default=8, type=int,
                   help="decode lanes: concurrent requests advanced per "
                        "step")
    p.add_argument("--max-queue", dest="max_queue", default=64, type=int,
                   help="bounded admission queue; submits beyond it are "
                        "rejected with reason 'queue_full'")
    p.add_argument("--max-len", dest="max_len", default=None, type=int,
                   help="longest servable sequence (default: the model's "
                        "seq_len); also the per-request length default")
    p.add_argument("--int8", dest="quantize_int8",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="serve int8 weight-quantised matrix products "
                        "(per-channel symmetric, dequantised on the device "
                        "each step); prints a calibration report at load")
    p.add_argument("--prefill_chunk", default=0, type=int,
                   help="admit prompts N prime tokens per decode step "
                        "(0 = the whole prime at once); streams are the "
                        "same either way")
    p.add_argument("--prefix_cache_mb", default=0, type=int,
                   help="LRU cache of prefill snapshots keyed on the token "
                        "prefix, in MiB of device memory (0 = off)")
    p.add_argument("--top_k", default=25, type=int,
                   help="default per-request top_k")
    p.add_argument("--temperature", default=1.0, type=float,
                   help="default per-request temperature")
    p.add_argument("--top_p", default=None, type=float,
                   help="default per-request nucleus mass")
    p.add_argument("--seed", default=42, type=int,
                   help="default per-request seed")
    p.add_argument("--journal_dir", default=None,
                   help="journal accepted requests and emitted tokens to "
                        "DIR/journal.jsonl, so a later --replay loses no "
                        "accepted work")
    p.add_argument("--replay", dest="replay_dir", default=None,
                   help="at start, resume every accepted but unfinished "
                        "request of DIR/journal.jsonl")
    p.add_argument("--metrics-every", dest="metrics_every", default=0,
                   type=int,
                   help="log a serve/ metrics snapshot to the tracker (and "
                        "rewrite --prom_file) every N decode steps (0 = "
                        "only at exit)")
    p.add_argument("--prom_file", default=None,
                   help="write Prometheus text exposition here (atomic "
                        "rewrite on the --metrics-every cadence and at "
                        "exit; node-exporter textfile-collector "
                        "compatible)")
    p.add_argument("--prom_port", default=0, type=int,
                   help="serve Prometheus text exposition over HTTP on "
                        "this localhost port (0 = off)")
    p.add_argument("--heartbeat", default=0.0, type=float,
                   help="rewrite --prom_file at least every N seconds even "
                        "when idle (0 = only on the --metrics-every "
                        "cadence). A collector reading the exposition's "
                        "mtime as liveness sees an idle but healthy "
                        "server as alive")
    p.add_argument("--socket", dest="socket_path", default=None,
                   help="serve a unix-socket server at PATH instead of "
                        "stdin/stdout")
    p.add_argument("--tcp", dest="tcp_hostport", default=None,
                   help="serve framed TCP at HOST:PORT (the fleet "
                        "transport; PORT 0 = ephemeral, the bound port is "
                        "printed on stderr)")
    p.add_argument("--idle_timeout", default=0.0, type=float,
                   help="drop a --tcp peer silent for more than N seconds "
                        "(0 = never)")
    p.add_argument("--reload_watch", default=0.0, type=float,
                   help="poll the checkpoint directory every N seconds and "
                        "hot-reload a newer complete checkpoint (0 = off; "
                        "SIGHUP always reloads)")
    p.add_argument("--reload_pin", dest="reload_pin_path", default=None,
                   help="pin control file: when it names a checkpoint, the "
                        "poll loads exactly that one (newest-wins "
                        "suspended) and answers through FILE.ack; at start "
                        "a pinned checkpoint is restored directly. Implies "
                        "--reload_watch 2 when that is unset")
    p.add_argument("--flight_dir", default=None,
                   help="arm the flight recorder: keep the last "
                        "events/spans/requests in a bounded in-memory ring "
                        "and dump an atomic flight-<host>-<ts>.json here on "
                        "crash paths (chaos kill, stall escalation, "
                        "unhandled exception, second kill signal)")
    p.add_argument("--profile_pin", dest="profile_pin_path", default=None,
                   help="profile.pin control file: when it carries a token "
                        "(optionally '<token> <seconds>'), start a bounded "
                        "torch.profiler trace window on the live process "
                        "and answer through FILE.ack — no restart. Polled "
                        "every 2s between decode steps")
    p.add_argument("--profile_out", default=None,
                   help="directory for on-demand profiler trace windows "
                        "(default: <profile_pin dir>/profiles)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def parse_request(line: str, defaults: dict):
    """JSON line -> (Request, None), or (Request or None, error). The
    prime is tokenised and the server's defaults applied; a malformed
    line becomes a rejection, never a crash."""
    try:
        obj = json.loads(line)
        if not isinstance(obj, dict):
            raise ValueError("request must be a JSON object")
        rid = str(obj["id"])
    except (ValueError, KeyError) as e:
        return None, f"bad request line: {e}"
    try:
        if obj.get("prime_tokens") is not None:
            prime = np.asarray([int(t) for t in obj["prime_tokens"]],
                               np.int64)
        else:
            prime = encode_tokens(str(obj.get("prime", ""))).astype(np.int64)
        add_bos = bool(obj.get("add_bos", True))
        length = int(obj.get("length", defaults["length"]))
        template = frozen = None
        if obj.get("template") is not None:
            # the template fixes prime and length
            toks, frz = parse_template(str(obj["template"]),
                                       str(obj.get("free_char", "?")))
            prime, length, template, frozen = infill_request_arrays(
                toks, frz, add_bos=add_bos)
        elif obj.get("template_tokens") is not None:
            template = np.asarray([int(t) for t in obj["template_tokens"]],
                                  np.int64)
            frozen = np.asarray([bool(f) for f in obj.get("frozen", [])],
                                bool)

        def knob(name, cast):
            value = obj.get(name, defaults[name])
            return None if value is None else cast(value)

        req = Request(
            id=rid, prime=prime, length=length,
            kind="embed" if obj.get("embed") else "generate",
            template=template, frozen=frozen,
            top_k=knob("top_k", int), add_bos=add_bos,
            temperature=float(obj.get("temperature",
                                      defaults["temperature"])),
            top_p=knob("top_p", float),
            seed=int(obj.get("seed", defaults["seed"])),
            draw_offset=int(obj.get("draw_offset", 0)),
            deadline_s=(None if obj.get("deadline_s") is None
                        else float(obj["deadline_s"])),
            trace_id=(None if obj.get("trace_id") is None
                      else str(obj["trace_id"])),
        )
        return req, None
    except (ValueError, TypeError) as e:
        # keep the id, so the rejection reaches its request
        return (Request(id=rid, prime=np.zeros(0, np.int64), length=-1),
                f"bad request fields: {e}")


def _start(req: Request) -> int:
    return len(req.prime) + (1 if req.add_bos else 0)


def event_lines(events, completions, starts: dict) -> list:
    """Engine step output -> protocol lines. ``starts`` maps a request id
    to its primed positions, so a done line carries the generated suffix
    alone."""
    lines = [json.dumps({"event": "token", "id": ev.request_id,
                         "token": int(ev.token),
                         "text": decode_tokens([ev.token]),
                         "index": int(ev.index)}) for ev in events]
    for c in completions:
        start = starts.pop(c.request_id, 0)
        if c.embedding is not None:
            lines.append(json.dumps({
                "event": "embedding", "id": c.request_id,
                "dim": int(c.embedding.shape[0]),
                "values": [round(float(x), 6) for x in c.embedding],
                "latency_s": round(c.latency_s, 6)}))
        else:
            lines.append(json.dumps({
                "event": "done", "id": c.request_id,
                "text": decode_tokens(c.tokens[start:]),
                "n_generated": int(c.n_generated),
                "ttft_s": round(c.ttft_s, 6),
                "latency_s": round(c.latency_s, 6)}))
    return lines


def _submit_line(sched, line: str, defaults: dict, starts: dict):
    """Parse and submit one request line; a rejection line, or None."""
    req, err = parse_request(line, defaults)
    if err is None:
        ok, err = sched.submit(req)
        if ok:
            starts[req.id] = _start(req)
            return None
    return json.dumps({"event": "rejected",
                       "id": None if req is None else req.id,
                       "reason": err})


def _replay(sched, replay_dir: str, starts: dict) -> list:
    """Resume a journal's unfinished requests; returns the done lines of
    those that had already met their stop rule."""
    jpath = os.path.join(replay_dir, "journal.jsonl")
    if not os.path.exists(jpath):
        print(f"replay: no journal at {jpath}", file=sys.stderr)
        return []
    summary = replay_into(sched, jpath)
    for req in summary["resumed"]:
        starts[req.id] = _start(req)
    print(f"replay: resumed {len(summary['resumed'])} request(s), settled "
          f"{len(summary['finished'])} already-finished, skipped "
          f"{summary['skipped_done']} done ({summary['dropped_lines']} torn "
          "journal line(s))", file=sys.stderr)
    return [json.dumps({"event": "done", "id": f["id"],
                        "text": decode_tokens(f["emitted"]),
                        "n_generated": 0, "ttft_s": 0.0, "latency_s": 0.0,
                        "replayed": True}) for f in summary["finished"]]


def serve_stdio(sched, defaults: dict, starts: dict, shutdown: dict,
                publish, metrics_every: int, preamble=(),
                tick=None) -> None:
    """The stdin/stdout loop: read the lines waiting on stdin between
    decode steps, so requests join mid-flight; EOF stops intake and the
    loop drains what is left. A drain signal stops intake and sheds the
    queue; the slots run to completion. ``tick`` runs once per loop
    iteration (the exposition's heartbeat)."""
    out = sys.stdout

    def emit(lines):
        for ln in lines:
            out.write(ln + "\n")
        out.flush()

    emit(list(preamble))
    eof = drained = False
    steps = 0
    buf = ""  # what came off the pipe after the last newline
    while (not eof and not shutdown["flag"]) or sched.has_work:
        if tick is not None:
            tick()
        if shutdown["flag"] and not drained:
            drained = True
            sched.drain_queue()
        # the raw fd into an explicit buffer: select() + readline() would
        # strand the lines readline pulled into its own buffer
        while not eof and not shutdown["flag"]:
            nl = buf.find("\n")
            if nl < 0:
                try:
                    ready, _, _ = select.select(
                        [sys.stdin], [], [], 0.0 if sched.has_work else 0.2)
                except OSError:
                    break
                if not ready:
                    break
                data = os.read(sys.stdin.fileno(), 65536)
                if data:
                    buf += data.decode("utf-8", errors="replace")
                    continue
                eof = True
                line, buf = buf, ""  # a last unterminated line is answered
            else:
                line, buf = buf[:nl], buf[nl + 1:]
            if line.strip():
                rej = _submit_line(sched, line, defaults, starts)
                if rej is not None:
                    emit([rej])
        if sched.has_work:
            events, comps = sched.step()
            emit(event_lines(events, comps, starts))
            steps += 1
            if metrics_every and steps % metrics_every == 0:
                publish(steps)
        # requests shed this turn (deadlines, the drain) are answered
        shed = sched.pop_expired()
        for req, _ in shed:
            starts.pop(req.id, None)
        emit([json.dumps({"event": "rejected", "id": req.id,
                          "reason": reason}) for req, reason in shed])


def _shed_lines(sched, starts: dict, owners: dict) -> list:
    """The requests the scheduler shed (deadlines, the drain) as
    (connection, rejected line) pairs for their owners."""
    out = []
    for req, reason in sched.pop_expired():
        starts.pop(req.id, None)
        cid, public = owners.pop(req.id, (None, None))
        if cid is not None:
            out.append((cid, json.dumps({"event": "rejected", "id": public,
                                         "reason": reason})))
    return out


def _handle_client_line(sched, line: str, defaults: dict, cid: int,
                        owners: dict, starts: dict, send) -> None:
    """One line from a connection: a release control line or a request.
    Request ids are namespaced by connection (``{cid}:{id}``), so two
    clients may both call their request "1"."""
    try:
        ctl = json.loads(line)
    except ValueError:
        ctl = None
    if isinstance(ctl, dict) and ctl.get("ctl") == "release":
        public = str(ctl.get("id"))
        internal = f"{cid}:{public}"
        released = sched.release(internal)
        if released:
            owners.pop(internal, None)
            starts.pop(internal, None)
        send(cid, [json.dumps({"event": "released", "id": public,
                               "released": released})])
        return
    req, err = parse_request(line, defaults)
    public = None if req is None else req.id
    if err is None:
        req.id = f"{cid}:{public}"
        ok, err = sched.submit(req)
        if ok:
            owners[req.id] = (cid, public)
            starts[req.id] = _start(req)
            return
    send(cid, [json.dumps({"event": "rejected", "id": public,
                           "reason": err})])


def serve_connections(sched, defaults: dict, listener, shutdown: dict,
                      publish, metrics_every: int, tick=None) -> None:
    """The connection transports' loop: one select over the listener and
    its clients between decode steps; every client receives exactly its
    own events. On a drain signal the listener closes (new connections
    are refused), the queue is shed and the slots finish streaming to
    their clients; then the loop ends."""
    clients: dict = {}  # connection id -> connection
    owners: dict = {}  # internal request id -> (connection id, public id)
    starts: dict = {}
    conn_ids = iter(range(1, 1 << 62))  # never reused, unlike fds
    steps = 0

    def drop(cid):
        conn = clients.pop(cid, None)
        if conn is not None:
            conn.close()

    def send(cid, lines):
        conn = clients.get(cid)
        if conn is None:
            return
        try:
            for ln in lines:
                conn.send_line(ln)
        except OSError:
            drop(cid)

    drained = False
    try:
        while True:
            if tick is not None:
                tick()
            for cid, conn in list(clients.items()):
                if conn.idle_expired():
                    drop(cid)
            if shutdown["flag"]:
                if not drained:
                    drained = True
                    listener.close()
                    sched.drain_queue()
                    for cid, ln in _shed_lines(sched, starts, owners):
                        send(cid, [ln])
                if not sched.has_work:
                    break
            rlist = ([] if drained else [listener]) + list(clients.values())
            try:
                ready = select.select(
                    rlist, [], [], 0.0 if sched.has_work else 0.2)[0]
            except OSError:
                continue  # a peer vanished between the list and select
            for obj in ready:
                if obj is listener:
                    conn = listener.accept()
                    if conn is not None:
                        conn.cid = next(conn_ids)
                        clients[conn.cid] = conn
                    continue
                if obj.sock is None:
                    continue  # dropped earlier in this turn
                lines, eof = obj.recv_lines()
                for line in lines:
                    if line.strip():
                        _handle_client_line(sched, line, defaults, obj.cid,
                                            owners, starts, send)
                if eof:
                    drop(obj.cid)
            if sched.has_work:
                events, comps = sched.step()
                for cid, ln in _shed_lines(sched, starts, owners):
                    send(cid, [ln])
                for ev in events:
                    cid, public = owners.get(ev.request_id, (None, None))
                    if cid is not None:
                        ev.request_id = public
                        send(cid, event_lines([ev], [], {}))
                for c in comps:
                    cid, public = owners.pop(c.request_id, (None, None))
                    start = starts.pop(c.request_id, 0)
                    if cid is not None:
                        c.request_id = public
                        send(cid, event_lines([], [c], {public: start}))
                steps += 1
                if metrics_every and steps % metrics_every == 0:
                    publish(steps)
    finally:
        for cid in list(clients):
            drop(cid)
        listener.close()


def _load(args, dev, pin):
    """(model, package): the pinned checkpoint when ``pin`` restores,
    else the newest. An unloadable pin falls back to the newest (the
    replica must come up serving something); the reloader's startup ack
    tells the pin's writer it was not honoured."""
    if pin is not None:
        loaded = load_model(args.checkpoint_path, dev, at=pin)
        if loaded is not None:
            return loaded
        print(f"reload pin {pin}: not restorable, falling back to the "
              "newest checkpoint", file=sys.stderr)
    return load_model(args.checkpoint_path, dev)


def run(argv=None) -> dict:
    """Serve until intake closes (EOF on stdin, or a drain signal) and the
    work is done; returns the final metrics snapshot."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    # the serving fault sites arm from the environment alone
    install_from_env()
    t0 = time.perf_counter()
    journal = (RequestJournal(os.path.join(args.journal_dir,
                                           "journal.jsonl"))
               if args.journal_dir else None)
    startup_pin, reload_watch = None, args.reload_watch
    if args.reload_pin_path:
        reload_watch = reload_watch or 2.0  # a pin nobody polls is dead
        try:
            with open(args.reload_pin_path) as f:
                startup_pin = f.read().strip() or None
        except OSError:
            startup_pin = None
    model, pkg = _load(args, dev, startup_pin)
    seq_len = model.config.seq_len
    engine = ServeEngine(model, max_slots=args.max_slots,
                         max_len=min(args.max_len or seq_len, seq_len),
                         quantize_int8=args.quantize_int8)
    if engine.quant_report is not None:
        r = engine.quant_report
        print(f"int8 weights: {r['quantized_leaves']} kernels, "
              f"{r['bytes_fp']} -> {r['bytes_int8']} bytes, "
              f"calib logits max-abs-err {r['logits_max_abs_err']:.3g}",
              file=sys.stderr)
    prefix_cache = (PrefixCache(args.prefix_cache_mb << 20)
                    if args.prefix_cache_mb else None)
    sched = Scheduler(engine, max_queue=args.max_queue, journal=journal,
                      prefill_chunk=args.prefill_chunk,
                      prefix_cache=prefix_cache)
    defaults = {"length": engine.max_len, "top_k": args.top_k,
                "temperature": args.temperature, "top_p": args.top_p,
                "seed": args.seed}
    # a local run directory, never wandb: a server must not block on a
    # login or reach for the network
    tracker = JsonlTracker("progen-serve", None, "./runs")
    # the scheduler's per-request records and the engine's spans
    events = spans.EventLog(tracker.path / "events.jsonl")
    spans.configure(sink=events.emit)
    print(f"request traces: {events.path}", file=sys.stderr)

    # forensics: the black-box ring and the on-demand profiler window,
    # each armed only when asked
    if args.flight_dir:
        flight_mod.arm(args.flight_dir, metrics_fn=sched.metrics.snapshot)
        print(f"flight recorder armed: dumps to {args.flight_dir}",
              file=sys.stderr)
    prof_watcher = None
    if args.profile_pin_path:
        prof_out = args.profile_out or os.path.join(
            os.path.dirname(args.profile_pin_path) or ".", "profiles")
        prof_watcher = flight_mod.ProfilePinWatcher(
            args.profile_pin_path, prof_out,
            profiler=flight_mod.TorchProfiler(cuda=dev.type == "cuda"))
        print(f"profile pin watched: {args.profile_pin_path} "
              f"(windows to {prof_out})", file=sys.stderr)

    beat = {"last": time.monotonic()}
    ckpt_name = os.path.basename(pkg.path)

    def note_checkpoint(name):
        # live checkpoint identity (the first 48 digest bits as a float),
        # in every exposition from the first: the deploy controller and
        # the router read fleet skew from this
        sched.metrics.set_gauge("checkpoint_digest", digest_gauge(
            checkpoint_digest(os.path.join(args.checkpoint_path, name))))

    note_checkpoint(ckpt_name)

    def publish(step=None):
        # the process's own kernel launches (the embed forwards'), so a
        # scrape shows which kernels this replica's work went through
        for rid, n in launches.launch_counts().items():
            sched.metrics.set_gauge(launches.gauge_name(rid), n)
        sched.metrics.log_to(tracker, step=step)
        if args.prom_file:
            write_prometheus(args.prom_file, prometheus_text(sched.metrics))
            beat["last"] = time.monotonic()

    # hot reload: SIGHUP (or the --reload_watch poll) stages a checkpoint
    # on a background thread; tick() commits it between decode steps
    reloader = WeightReloader(engine, args.checkpoint_path,
                              metrics=sched.metrics, current=ckpt_name,
                              pin_path=args.reload_pin_path)
    # answer a pin file that predates this process now: committed when
    # it was restored, rejected when the start fell back
    reloader.note_startup_pin()
    reload_req = {"flag": False}

    def tick():
        """Once a loop turn, between decode steps."""
        # an exposition rewrite only (no tracker row): the file's mtime
        # stays fresh for a collector while the server idles
        if args.heartbeat and args.prom_file and \
                time.monotonic() - beat["last"] >= args.heartbeat:
            write_prometheus(args.prom_file, prometheus_text(sched.metrics))
            beat["last"] = time.monotonic()
        if reload_req["flag"]:
            reload_req["flag"] = False
            if reloader.request_reload():
                print("reload: loading newest checkpoint in background",
                      file=sys.stderr)
        if reload_watch:
            reloader.poll_watch(reload_watch)
        if prof_watcher is not None:
            prof_watcher.poll_watch()
        name = reloader.maybe_commit()
        if name is not None:
            note_checkpoint(name)
            print(f"reload: now serving {name} (load + commit "
                  f"{reloader.last_duration_s:.3f} s)", file=sys.stderr)
            publish()  # the digest gauge must not wait a metrics cadence
        elif reloader.last_error is not None:
            print(f"reload: rejected ({reloader.last_error}), still "
                  f"serving {reloader.current}", file=sys.stderr)
            reloader.last_error = None

    prom_srv = None
    if args.prom_port:
        prom_srv = start_prometheus_server(
            lambda: prometheus_text(sched.metrics), port=args.prom_port)
        print(f"prometheus on http://127.0.0.1:"
              f"{prom_srv.server_address[1]}/metrics", file=sys.stderr)

    starts: dict = {}
    preamble = _replay(sched, args.replay_dir, starts) \
        if args.replay_dir else []
    print(f"serving: max_slots={engine.max_slots} max_len={engine.max_len} "
          f"max_queue={sched.max_queue} checkpoint={ckpt_name} device={dev} "
          f"loaded in {time.perf_counter() - t0:.1f} s", file=sys.stderr)

    shutdown = {"flag": False}

    def request_drain(signum, frame):
        if shutdown["flag"]:
            print(f"signal {signum} again: exiting now", file=sys.stderr)
            try:
                sched.close_tracks("killed")
            except Exception:
                pass  # a torn trace line beats a hung exit
            # last act: the black box (atomic, and dump_now never raises)
            flight_mod.dump_now("killed", note=f"signal {signum}")
            sys.stderr.flush()
            os._exit(1)
        shutdown["flag"] = True
        print(f"signal {signum}: draining: intake closed, finishing "
              "in-flight requests; signal again to kill", file=sys.stderr)

    def request_reload(signum, frame):
        reload_req["flag"] = True  # tick() does the work

    old = {s: signal.signal(s, request_drain)
           for s in (signal.SIGTERM, signal.SIGINT)}
    old[signal.SIGHUP] = signal.signal(signal.SIGHUP, request_reload)
    t0 = time.perf_counter()
    try:
        if args.tcp_hostport or args.socket_path:
            if args.tcp_hostport:
                listener = FramedListener(
                    *parse_hostport(args.tcp_hostport),
                    idle_timeout=args.idle_timeout)
                where = f"tcp {listener.host}:{listener.port}"
            else:
                listener = UnixListener(args.socket_path)
                where = args.socket_path
            # the startup handshake: with PORT 0 the only place the port
            # is told
            print(f"listening on {where}", file=sys.stderr)
            sys.stderr.flush()
            serve_connections(sched, defaults, listener, shutdown, publish,
                              args.metrics_every, tick=tick)
        else:
            serve_stdio(sched, defaults, starts, shutdown, publish,
                        args.metrics_every, preamble, tick=tick)
    finally:
        for s, handler in old.items():
            signal.signal(s, handler)
        publish()
        if prom_srv is not None:
            prom_srv.shutdown()
        if prof_watcher is not None:
            prof_watcher.close()  # flush an open profiler window
        flight_mod.disarm()
        spans.configure()
        events.close()
        tracker.finish()
        if journal is not None:
            journal.close()
    snap = sched.metrics.snapshot()
    print(f"served {int(snap.get('requests_completed', 0))} request(s) and "
          f"{int(snap.get('embed_requests', 0))} embedding(s) in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return snap


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

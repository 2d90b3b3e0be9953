"""Serving CLI: the continuous-batching engine loop against a checkpoint,
the JAX package's ``cli/serve.py`` on its stdin/stdout transport.

Runs the slot-pool engine (``progen_tpu_torch/serving/``) as a
single-threaded event loop. Requests arrive on stdin as JSON lines, one
object a request:

    {"id": "r1", "prime": "[tax=Mammalia] #", "length": 256,
     "temperature": 0.8, "top_p": 0.95, "top_k": 25, "seed": 7}

(``id`` and ``prime`` required; ``length`` defaults to --max-len, the
knobs and ``seed`` to their flags.) The resume wire adds three optional
fields: ``prime_tokens`` (raw token ids, bypassing the tokenizer),
``draw_offset`` (the first draw of the seed's stream, default 0) and
``add_bos`` (default true); with them a request continues another
process's stream exactly. Two protein-design shapes ride the same wire:

    {"id": "f1", "template": "MK?LV??G", "free_char": "?", ...}
    {"id": "e1", "prime": "[tax=Mammalia] # MKLV", "embed": true}

``template`` is fixed-position infilling (``workloads/infill.py``):
frozen characters are kept, ``free_char`` positions are sampled; the
leading frozen run becomes the prime and the template's width the
length (the resume wire may carry buffer-aligned ``template_tokens`` and
``frozen`` lists instead). ``embed: true`` asks for the mean-pooled
final-norm embedding of the prime. Responses stream to stdout as JSON
lines, interleaved across requests as the engine produces them:

    {"event": "token", "id": "r1", "token": 77, "text": "L", "index": 18}
    {"event": "done", "id": "r1", "text": "...", "n_generated": 238,
     "ttft_s": 0.01, "latency_s": 0.9}
    {"event": "embedding", "id": "e1", "dim": 1024, "values": [...],
     "latency_s": 0.02}
    {"event": "rejected", "id": "r9", "reason": "queue_full"}

EOF on stdin drains the queue and exits. The first SIGTERM or SIGINT
closes intake, sheds the queue (``rejected: draining``) and lets the
slots finish; a second exits at once. ``--journal_dir DIR`` journals
accepted requests and emitted tokens to DIR/journal.jsonl, and a later
``--replay DIR`` resumes every unfinished accepted request with its
uninterrupted stream (a slot's draw t is ``draw_seed(seed, t)``, so the
journal carries a draw offset, not a key). ``--int8`` serves int8
weight-quantised matrix products and prints the calibration line
"int8 weights: ..." to stderr. ``PROGEN_CHAOS`` arms the fault sites
(``serve/prefill``, ``serve/prefill_chunk``, ``serve/decode``).
``--prom_file`` writes the metrics' Prometheus exposition (prefix
``progen_serve_``; on the ``--metrics-every`` cadence and at exit, and at
least every ``--heartbeat`` seconds when set), ``--prom_port`` serves it
over HTTP on localhost. The flags of the JAX CLI that are not ported yet
are refused with the ROADMAP item that carries them.

Run: python -m progen_tpu_torch.cli.serve --checkpoint_path ./ckpts
"""

from __future__ import annotations

import argparse
import json
import os
import select
import signal
import sys
import time

import numpy as np

from progen_tpu_torch._device import resolve_device
from progen_tpu_torch.cli.eval import load_model
from progen_tpu_torch.data.tokenizer import decode_tokens, encode_tokens
from progen_tpu_torch.resilience.chaos import install_from_env
from progen_tpu_torch.serving import (
    PrefixCache,
    Request,
    RequestJournal,
    Scheduler,
    ServeEngine,
    replay_into,
)
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

_ITEM_2 = "ROADMAP queue 1 item 2 (the serving fleet's data plane)"
_ITEM_3 = "ROADMAP queue 1 item 3 (the telemetry back end and the flight " \
    "recorder)"
NOT_PORTED = {
    "--socket": _ITEM_2, "--tcp": _ITEM_2, "--idle_timeout": _ITEM_2,
    "--reload_watch": _ITEM_2, "--reload_pin": _ITEM_2,
    "--flight_dir": _ITEM_3, "--profile_pin": _ITEM_3,
    "--profile_out": _ITEM_3,
}


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
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    for flag in NOT_PORTED:
        p.add_argument(flag, nargs="?", const=True, default=None,
                       help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for flag, item in NOT_PORTED.items():
        if getattr(args, flag[2:]) is not None:
            p.error(f"{flag} is not ported yet: {item}")
    return args


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


def run(argv=None) -> dict:
    """Serve until stdin closes (or a drain signal) and the work is done;
    returns the final metrics snapshot."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    # the serving fault sites (serve/prefill, serve/prefill_chunk,
    # serve/decode) arm from the environment alone
    install_from_env()
    t0 = time.perf_counter()
    journal = (RequestJournal(os.path.join(args.journal_dir,
                                           "journal.jsonl"))
               if args.journal_dir else None)
    model, pkg = load_model(args.checkpoint_path, dev)
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

    beat = {"last": time.monotonic()}

    def publish(step=None):
        sched.metrics.log_to(tracker, step=step)
        if args.prom_file:
            write_prometheus(args.prom_file, prometheus_text(sched.metrics))
            beat["last"] = time.monotonic()

    def tick():
        # an exposition rewrite only (no tracker row): the file's mtime
        # stays fresh for a collector while the server idles
        if args.heartbeat and args.prom_file and \
                time.monotonic() - beat["last"] >= args.heartbeat:
            write_prometheus(args.prom_file, prometheus_text(sched.metrics))
            beat["last"] = time.monotonic()

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
          f"max_queue={sched.max_queue} checkpoint="
          f"{os.path.basename(pkg.path)} device={dev} loaded in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)

    shutdown = {"flag": False}

    def request_drain(signum, frame):
        if shutdown["flag"]:
            print(f"signal {signum} again: exiting now", file=sys.stderr)
            sched.close_tracks("killed")
            sys.stderr.flush()
            os._exit(1)
        shutdown["flag"] = True
        print(f"signal {signum}: draining: intake closed, finishing "
              "in-flight requests; signal again to kill", file=sys.stderr)

    old = {s: signal.signal(s, request_drain)
           for s in (signal.SIGTERM, signal.SIGINT)}
    t0 = time.perf_counter()
    try:
        serve_stdio(sched, defaults, starts, shutdown, publish,
                    args.metrics_every, preamble, tick=tick)
    finally:
        for s, handler in old.items():
            signal.signal(s, handler)
        publish()
        if prom_srv is not None:
            prom_srv.shutdown()
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

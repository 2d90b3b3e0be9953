"""Router CLI: the elastic multi-replica serving front end, the port of
the JAX package's ``cli/router.py`` (argparse in place of click).

Fans the JSON-lines protocol ``cli.serve`` speaks across N serve
replicas (each ``cli.serve --socket ... --journal_dir ...`` with its own
journal) and survives a replica's death by the journal-ownership handoff
(``serving/router.py``). Two ways to a fleet:

  * point at running replicas:

        python -m progen_tpu_torch.cli.router \\
          --replica sock=/run/r0.sock,journal=/var/r0,prom=/var/r0/m.prom \\
          --replica tcp=10.0.0.5:7000,journal=/var/r1,prom=/var/r1/m.prom

  * or spawn them: ``--spawn 2 --checkpoint_path ./ckpts --fleet_dir
    ./fleet`` starts two ``cli.serve`` children, each under
    ``fleet_dir/replica{i}/`` (``serve.sock``, ``journal.jsonl``,
    ``metrics.prom``, ``replica.log``), on ``--device`` (the card unless
    the caller asks for the CPU); ``--respawn`` restarts a dead one with
    ``--replay`` of its own journal, which is safe because the handoff
    writes its ``handed_off`` marks before a restart can replay.

Requests arrive on stdin (default; EOF drains and exits), a unix socket
(``--socket PATH``) or framed TCP (``--listen_tcp HOST:PORT``), as
``cli.serve`` takes them: one JSON object a line, ``id`` required, an
optional ``tenant`` for ``--tenant_quota``. Token, done, embedding and
rejected events stream back interleaved. The router's own shedding
reasons: ``router_queue_full``, ``tenant_quota``, ``draining``,
``no_replicas``, ``replica_lost``.

SIGTERM/SIGINT drains: intake closes, queued requests are shed
(``draining``), in-flight streams (and any handoff a replica's death
forces) run to the end, then exit 0. A second signal exits at once,
after closing the open request tracks (reason ``killed``). Metrics
render under the ``progen_router_`` Prometheus prefix (``--prom_file``,
``--prom_port``); route and request records go to
``runs/progen-router/<id>/events.jsonl``. ``PROGEN_CHAOS`` arms
``router/connect``, ``router/dispatch``, ``router/handoff`` and
``autoscaler/decide``. ``--flight_dir`` arms the router's own flight
recorder; ``--replica_profile_watch`` gives each spawned replica
``--profile_pin replica{i}/profile.pin`` and ``--flight_dir
replica{i}/flight``.

``--autoscale POLICY.toml --autoscale_tsdb DIR`` scales a ``--spawn``
fleet from the fleet collector's TSDB (``fleet/autoscaler.py`` decides,
this CLI acts): scale-up revives the lowest retired slot or grows the
fleet, and spawns its replica with ``--replay`` of its journal;
scale-down retires the highest live link, waits out its in-flight streams
up to a grace, then sends SIGTERM (the replica's graceful drain).

Run: python -m progen_tpu_torch.cli.router --spawn 2 --checkpoint_path
./ckpts
"""

from __future__ import annotations

import argparse
import json
import os
import select
import signal
import subprocess
import sys
import time

from progen_tpu_torch.fleet.transport import (
    FramedListener,
    UnixListener,
    parse_hostport,
)
from progen_tpu_torch.resilience.chaos import ChaosError, install_from_env
from progen_tpu_torch.serving.router import Router, parse_replica_spec
from progen_tpu_torch.telemetry import flight as flight_mod
from progen_tpu_torch.telemetry import (
    prometheus_text,
    spans,
    start_prometheus_server,
    write_prometheus,
)
from progen_tpu_torch.tracking import JsonlTracker
from progen_tpu_torch.utils.env import load_env_file

def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="progen_tpu_torch.cli.router", allow_abbrev=False,
        description="Route serving requests across cli.serve replicas and "
                    "hand a dead replica's journaled work to a survivor.")
    p.add_argument("--replica", dest="replica_specs", action="append",
                   default=[],
                   help="replica endpoint, repeatable: 'sock=PATH' or "
                        "'tcp=HOST:PORT', then "
                        "'[,journal=DIR][,prom=FILE][,name=N]', or a bare "
                        "socket path (no journal: no handoff, only a "
                        "fresh dispatch of requests that streamed "
                        "nothing)")
    p.add_argument("--spawn", default=0, type=int,
                   help="spawn N cli.serve replicas under --fleet_dir "
                        "instead of connecting to --replica endpoints")
    p.add_argument("--checkpoint_path", default="./ckpts",
                   help="the spawned replicas' checkpoint directory")
    p.add_argument("--fleet_dir", default="./fleet",
                   help="each spawned replica's socket, journal, prom file "
                        "and log go under FLEET_DIR/replica{i}/")
    p.add_argument("--respawn", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="restart a dead spawned replica with --replay of "
                        "its own journal")
    p.add_argument("--replica-max-slots", dest="replica_max_slots",
                   default=8, type=int,
                   help="--max-slots of the spawned replicas")
    p.add_argument("--replica-max-queue", dest="replica_max_queue",
                   default=64, type=int,
                   help="--max-queue of the spawned replicas")
    p.add_argument("--max-len", dest="max_len", default=None, type=int,
                   help="--max-len of the spawned replicas")
    p.add_argument("--replica_reload_watch", default=0.0, type=float,
                   help="the spawned replicas poll their checkpoint "
                        "directory every N seconds (serve --reload_watch) "
                        "and honour FLEET_DIR/replica{i}/reload.pin (serve "
                        "--reload_pin); 0 = off")
    p.add_argument("--replica_profile_watch", action="store_true",
                   help="spawned replicas watch FLEET_DIR/replica{i}/"
                        "profile.pin for on-demand torch.profiler windows "
                        "and arm their flight recorders under "
                        "FLEET_DIR/replica{i}/flight")
    p.add_argument("--flight_dir", default=None,
                   help="arm the ROUTER's own flight recorder: bounded ring "
                        "of recent routing telemetry, dumped atomically "
                        "here on crash paths and a second signal")
    p.add_argument("--device", default="cuda",
                   help="the spawned replicas' device: cuda (default) or "
                        "cpu")
    p.add_argument("--max-queue", dest="max_queue", default=256, type=int,
                   help="the router's queue bound (shed reason "
                        "'router_queue_full' beyond it)")
    p.add_argument("--tenant_quota", default=0, type=int,
                   help="outstanding requests a 'tenant' may hold (0 = no "
                        "bound; shed reason 'tenant_quota')")
    p.add_argument("--heartbeat_timeout", default=30.0, type=float,
                   help="deprioritise a replica whose prom file is older "
                        "than this many seconds")
    p.add_argument("--socket", dest="socket_path", default=None,
                   help="serve a unix socket at PATH instead of "
                        "stdin/stdout")
    p.add_argument("--listen_tcp", default=None,
                   help="serve framed TCP at HOST:PORT (PORT 0 = "
                        "ephemeral, the bound port is printed on stderr)")
    p.add_argument("--autoscale", dest="autoscale_policy", default=None,
                   help="autoscale the --spawn fleet from the [autoscaler] "
                        "table of this TOML (configs/serving/"
                        "autoscaler.toml)")
    p.add_argument("--autoscale_tsdb", default=None,
                   help="the fleet collector's ring-TSDB directory the "
                        "autoscaler reads its signals from (cli.collector "
                        "--tsdb)")
    p.add_argument("--metrics-every", dest="metrics_every", default=0,
                   type=int,
                   help="log a router/ metrics snapshot (and rewrite "
                        "--prom_file) every N loop turns (0 = only at "
                        "exit)")
    p.add_argument("--prom_file", default=None,
                   help="write progen_router_* Prometheus text here")
    p.add_argument("--prom_port", default=0, type=int,
                   help="serve progen_router_* metrics over HTTP on this "
                        "localhost port (0 = off)")
    args = p.parse_args(argv)
    if args.spawn and args.replica_specs:
        p.error("use --spawn or --replica, not both")
    if not args.spawn and not args.replica_specs:
        p.error("no fleet: pass --replica specs or --spawn N")
    if args.autoscale_policy and not args.spawn:
        p.error("--autoscale needs --spawn (the router must own the "
                "replica processes it scales)")
    if args.autoscale_policy and not args.autoscale_tsdb:
        p.error("--autoscale needs --autoscale_tsdb DIR (the fleet "
                "collector's TSDB is the policy's signal source)")
    return args


def _submit_line(router, line: str, client=None):
    """Parse and submit one request line; a rejection event, or None."""
    try:
        obj = json.loads(line)
        if not isinstance(obj, dict):
            raise ValueError("request must be a JSON object")
    except ValueError as e:
        return {"event": "rejected", "id": None,
                "reason": f"bad request line: {e}"}
    return router.submit(obj, client=client)


def front_stdio(router, shutdown: dict, publish, metrics_every: int,
                tick=None) -> None:
    """The stdin front: one select over stdin and the replica sockets, so
    requests and replica events interleave without sleeps. EOF or a
    drain signal closes intake; the loop runs until the router has
    settled everything it accepted."""
    out = sys.stdout

    def emit(ev):
        out.write(json.dumps(ev) + "\n")
        out.flush()

    eof = drained = False
    buf = ""
    ticks = 0
    while True:
        if shutdown["flag"] and not drained:
            drained = True
            router.drain()
        closed = eof or shutdown["flag"]
        if closed and not router.has_work:
            break
        rlist = ([] if closed else [sys.stdin]) + router.fds()
        # a bounded wait: backoffs and reconnects need the loop to turn
        try:
            if rlist:
                select.select(rlist, [], [],
                              0.05 if router.has_work else 0.2)
        except OSError:
            pass  # a replica socket died between fds() and select
        # the raw fd into an explicit buffer, as cli.serve reads it
        while not eof and not shutdown["flag"]:
            nl = buf.find("\n")
            if nl < 0:
                try:
                    ready, _, _ = select.select([sys.stdin], [], [], 0.0)
                except OSError:
                    break
                if not ready:
                    break
                data = os.read(sys.stdin.fileno(), 65536)
                if data:
                    buf += data.decode("utf-8", errors="replace")
                    continue
                eof = True
                line, buf = buf, ""
            else:
                line, buf = buf[:nl], buf[nl + 1:]
            if line.strip():
                rej = _submit_line(router, line)
                if rej is not None:
                    emit(rej)
        for _, ev in router.poll():
            emit(ev)
        if tick is not None:
            tick()
        ticks += 1
        if metrics_every and ticks % metrics_every == 0:
            publish(ticks)


def front_connections(router, listener, shutdown: dict, publish,
                      metrics_every: int, tick=None) -> None:
    """The unix-socket or framed-TCP front: each connection submits
    requests and receives exactly its own events (a connection is the
    router's per-request ``client`` handle). On a drain signal the
    listener closes, the queue is shed and in-flight streams finish to
    their clients; then the loop ends."""
    clients: dict = {}  # connection id -> connection
    conn_ids = iter(range(1, 1 << 62))
    ticks = 0
    drained = False

    def drop(cid):
        conn = clients.pop(cid, None)
        if conn is not None:
            conn.close()

    def send(cid, ev):
        conn = clients.get(cid)
        if conn is None:
            return
        try:
            conn.send_line(json.dumps(ev))
        except OSError:
            drop(cid)

    try:
        while True:
            if shutdown["flag"] and not drained:
                drained = True
                listener.close()
                router.drain()
            if shutdown["flag"] and not router.has_work:
                break
            replicas = router.fds()
            rlist = (([] if drained else [listener])
                     + list(clients.values()) + replicas)
            try:
                ready = select.select(
                    rlist, [], [], 0.05 if router.has_work else 0.2)[0]
            except OSError:
                continue  # a peer vanished between the list and select
            for obj in ready:
                if obj is listener:
                    conn = listener.accept()
                    if conn is not None:
                        conn.cid = next(conn_ids)
                        clients[conn.cid] = conn
                    continue
                if obj in replicas or obj.sock is None:
                    continue  # router.poll() reads replicas
                lines, eof = obj.recv_lines()
                for line in lines:
                    if line.strip():
                        rej = _submit_line(router, line, client=obj.cid)
                        if rej is not None:
                            send(obj.cid, rej)
                if eof:
                    drop(obj.cid)
            for client, ev in router.poll():
                if client is not None:
                    send(client, ev)
            if tick is not None:
                tick()
            ticks += 1
            if metrics_every and ticks % metrics_every == 0:
                publish(ticks)
    finally:
        for cid in list(clients):
            drop(cid)
        listener.close()


def make_autoscaler(args, router, procs: dict, spawn_replica,
                    spawned_spec):
    """The autoscaler's executor over the spawned fleet: the policy
    (``fleet/autoscaler.py``) decides from the collector's TSDB, the
    returned tick acts, once a front-loop turn."""
    from progen_tpu_torch.fleet.autoscaler import (
        ACTION_DOWN,
        ACTION_UP,
        Autoscaler,
        load_policy,
    )
    from progen_tpu_torch.telemetry.tsdb import TsdbReader

    policy = load_policy(args.autoscale_policy)
    scaler = Autoscaler(policy, reader=TsdbReader(args.autoscale_tsdb))
    router.rebalance_max = policy.rebalance_max
    # a retiring replica gets this long to finish its decode slots before
    # SIGTERM stops waiting (SIGTERM is still a graceful drain there)
    drain_grace_s = max(10.0, policy.interval_s * 5)
    state = {"next": 0.0, "draining": {}}  # index -> grace deadline
    print(f"autoscaler: {policy.min_replicas}..{policy.max_replicas} "
          f"replicas, tick {policy.interval_s}s, tsdb "
          f"{args.autoscale_tsdb}", file=sys.stderr)

    def scale_up(n: int) -> None:
        for _ in range(n):
            reusable = sorted(
                link.index for link in router.links
                if link.retired and link.index not in procs
                and link.index not in state["draining"])
            if reusable:
                i = reusable[0]
                router.revive_replica(i)
            else:
                i = router.add_replica(spawned_spec(len(router.links)))
            # --replay always: a no-op on a fresh journal; on a reused
            # slot it resumes what the handoff did not settle (the
            # handed_off marks rule out serving a request twice)
            spawn_replica(i, replay=True)

    def scale_down(n: int, now: float) -> None:
        live = sorted((link.index for link in router.links
                       if not link.retired), reverse=True)
        for i in live[:n]:
            router.retire_replica(i)
            state["draining"][i] = now + drain_grace_s
            print(f"replica{i}: retiring (scale-down)", file=sys.stderr)

    def reap_draining(now: float) -> None:
        for i, deadline in list(state["draining"].items()):
            entry = procs.get(i)
            if entry is None:  # already exited and reaped
                state["draining"].pop(i)
                continue
            if router.links[i].inflight and now < deadline:
                continue  # still streaming: let it finish
            # SIGTERM is serve's graceful drain (in-flight slots finish,
            # journal and metrics flush, exit 0); what it sheds as
            # 'draining' the router re-routes, and a death instead rides
            # the handoff: no accepted request is lost either way
            entry[0].terminate()
            state["draining"].pop(i)

    def tick() -> None:
        now = time.monotonic()
        reap_draining(now)
        if now < state["next"]:
            return
        state["next"] = now + policy.interval_s
        current = sum(1 for link in router.links if not link.retired)
        try:
            decision = scaler.decide(current)
        except ChaosError:
            return  # autoscaler/decide chaos costs one tick, not the fleet
        if decision.action == ACTION_UP:
            scale_up(decision.target - current)
        elif decision.action == ACTION_DOWN:
            scale_down(current - decision.target, now)

    return tick


def run(argv=None) -> dict:
    """Route until intake closes (EOF on stdin, or a drain signal) and
    every accepted request is settled; returns the final metrics
    snapshot."""
    load_env_file()
    args = parse_args(argv)
    # the router's fault sites arm from the environment alone
    install_from_env()
    procs: dict = {}  # replica index -> (Popen, replica dir, log file)

    def replica_dir(i: int) -> str:
        return os.path.join(args.fleet_dir, f"replica{i}")

    def spawn_replica(i: int, replay: bool = False) -> None:
        rdir = replica_dir(i)
        os.makedirs(rdir, exist_ok=True)
        cmd = [sys.executable, "-m", "progen_tpu_torch.cli.serve",
               "--device", args.device,
               "--checkpoint_path", args.checkpoint_path,
               "--socket", os.path.join(rdir, "serve.sock"),
               "--journal_dir", rdir,
               "--prom_file", os.path.join(rdir, "metrics.prom"),
               "--metrics-every", "4",
               "--max-slots", str(args.replica_max_slots),
               "--max-queue", str(args.replica_max_queue)]
        if args.max_len is not None:
            cmd += ["--max-len", str(args.max_len)]
        if args.replica_reload_watch:
            cmd += ["--reload_watch", str(args.replica_reload_watch),
                    "--reload_pin", os.path.join(rdir, "reload.pin")]
        if args.replica_profile_watch:
            cmd += ["--profile_pin", os.path.join(rdir, "profile.pin"),
                    "--flight_dir", os.path.join(rdir, "flight")]
        if replay:
            cmd += ["--replay", rdir]
        log = open(os.path.join(rdir, "replica.log"), "ab")
        proc = subprocess.Popen(cmd, stdin=subprocess.DEVNULL, stdout=log,
                                stderr=log)
        procs[i] = (proc, rdir, log)
        print(f"replica{i}: pid {proc.pid}"
              + (" (replaying its journal)" if replay else ""),
              file=sys.stderr)

    def spawned_spec(i: int):
        rdir = replica_dir(i)
        return parse_replica_spec(
            f"sock={os.path.join(rdir, 'serve.sock')},journal={rdir},"
            f"prom={os.path.join(rdir, 'metrics.prom')}")

    if args.spawn:
        specs = []
        for i in range(args.spawn):
            specs.append(spawned_spec(i))
            spawn_replica(i)
    else:
        specs = [parse_replica_spec(s) for s in args.replica_specs]

    router = Router(specs, max_queue=args.max_queue,
                    tenant_quota=args.tenant_quota,
                    heartbeat_timeout=args.heartbeat_timeout)
    # a local run directory, never wandb (as cli.serve)
    tracker = JsonlTracker("progen-router", None, "./runs")
    events = spans.EventLog(tracker.path / "events.jsonl")
    spans.configure(sink=events.emit)
    if args.flight_dir:
        flight_mod.arm(args.flight_dir, metrics_fn=router.metrics.snapshot)
    print(f"router traces: {events.path}", file=sys.stderr)

    def publish(step=None):
        router.metrics.log_to(tracker, step=step, prefix="router/")
        if args.prom_file:
            write_prometheus(args.prom_file, prometheus_text(
                router.metrics, prefix="progen_router_"))

    prom_srv = None
    if args.prom_port:
        prom_srv = start_prometheus_server(
            lambda: prometheus_text(router.metrics, prefix="progen_router_"),
            port=args.prom_port)
        print(f"prometheus on http://127.0.0.1:"
              f"{prom_srv.server_address[1]}/metrics", file=sys.stderr)
    print(f"routing across {len(specs)} replica(s): "
          + ", ".join(s.endpoint for s in specs), file=sys.stderr)

    autoscale = (make_autoscaler(args, router, procs, spawn_replica,
                                 spawned_spec)
                 if args.autoscale_policy else None)
    shutdown = {"flag": False}

    def request_drain(signum, frame):
        if shutdown["flag"]:
            print(f"signal {signum} again: exiting now", file=sys.stderr)
            try:
                router.close_tracks("killed")
            except Exception:
                pass  # a torn trace line beats a hung exit
            flight_mod.dump_now("killed", note=f"signal {signum}")
            sys.stderr.flush()
            os._exit(1)
        shutdown["flag"] = True
        print(f"signal {signum}: draining: intake closed, queued requests "
              "shed, in-flight streams finishing; signal again to kill",
              file=sys.stderr)

    def tick():
        """Once a front-loop turn, after router.poll(): a dead spawned
        replica's handoff (set off by its socket's EOF inside poll) has
        written its ownership marks before a --respawn replay reads the
        journal."""
        if shutdown["flag"]:
            return
        for i, (proc, _, log) in list(procs.items()):
            if proc.poll() is None:
                continue
            del procs[i]
            log.close()
            print(f"replica{i}: exited rc={proc.returncode}",
                  file=sys.stderr)
            # a retired replica's exit is the scale-down completing, not
            # a death to heal
            link = router.links[i]
            if args.respawn and not link.up and not link.retired:
                spawn_replica(i, replay=True)
        if autoscale is not None:
            autoscale()

    old = {s: signal.signal(s, request_drain)
           for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        if args.listen_tcp or args.socket_path:
            if args.listen_tcp:
                listener = FramedListener(*parse_hostport(args.listen_tcp))
                where = f"tcp {listener.host}:{listener.port}"
            else:
                listener = UnixListener(args.socket_path)
                where = args.socket_path
            print(f"listening on {where}", file=sys.stderr)
            sys.stderr.flush()
            front_connections(router, listener, shutdown, publish,
                              args.metrics_every, tick=tick)
        else:
            front_stdio(router, shutdown, publish, args.metrics_every,
                        tick=tick)
    finally:
        for s, handler in old.items():
            signal.signal(s, handler)
        publish()
        if prom_srv is not None:
            prom_srv.shutdown()
        for proc, _, _ in procs.values():
            proc.terminate()
        for proc, _, log in procs.values():
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log.close()
        flight_mod.disarm()
        spans.configure()
        events.close()
        tracker.finish()
    return router.metrics.snapshot()


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

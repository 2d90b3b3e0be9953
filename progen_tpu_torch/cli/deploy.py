"""``progen-tpu-torch-deploy`` — continuous deployment for a serve fleet,
the port's copy of the JAX package's ``cli/deploy.py`` (argparse in place
of click, with the same flags, stderr lines and exit codes, and
``--device``).

Watches a checkpoint directory and runs the canary → probe → promote →
converge pipeline (``progen_tpu_torch/deploy/controller.py``) against a
fleet of replicas that honor ``reload.pin`` control files (serve
``--reload_pin``, or router ``--spawn --replica_reload_watch``). Every
decision lands in the fsync'd ``deploy.jsonl`` ledger under
``--deploy_dir``; kill the controller at any phase and a restart replays
the ledger and resumes idempotently.

Point it at a spawned fleet's directory (replicas discovered as
``FLEET_DIR/replica*/``):

    progen-tpu-torch-deploy --checkpoint_path ./ckpts --fleet_dir ./fleet \\
        --probe_fasta probe.fasta --policy configs/serving/deploy.toml \\
        --tsdb ./tsdb --alerts ./fleet/alerts.jsonl

or name replicas explicitly with ``--replica name=DIR`` (DIR holds the
replica's reload.pin / reload.pin.ack). Start the controller BEFORE
publishing candidate checkpoints: its adopt step pins every replica to
the current fleet checkpoint, so no replica's newest-wins watcher can
self-upgrade past the canary gate.

The probe scores ``--probe_fasta`` on ``--device`` (the card by default;
``cpu`` only when asked): one full forward a batch through the kernels
A1, L1 and L2. The closing summary line on stderr carries the process's
kernel launches (``launches {...}``).

Rollbacks page through the alert pipeline: ``--alerts`` appends
``deploy_rollback`` alerts to an AlertSink ledger (edge-deduped =
exactly-once per checkpoint across restarts) and ``--alert_config``
additionally routes them (webhook/stderr/file + escalation chains,
``telemetry/alert_router.py``). ``PROGEN_CHAOS`` arms the sites
``deploy/canary``, ``deploy/probe``, ``deploy/promote`` and
``deploy/rollback``. SIGTERM or SIGINT stops the loop after the
current tick; the exit code is 0.

Run: python -m progen_tpu_torch.cli.deploy --checkpoint_path ./ckpts \\
         --fleet_dir ./fleet --once
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import signal
import sys
import time

from progen_tpu_torch.cli import echo
from progen_tpu_torch.utils.env import load_env_file


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="progen_tpu_torch.cli.deploy", allow_abbrev=False,
        description="Continuous deployment: canary, probe, promote, "
                    "rollback across a serve fleet.")
    p.add_argument("--checkpoint_path", default="./ckpts",
                   help="the checkpoint dir the trainer publishes into")
    p.add_argument("--fleet_dir", default=None,
                   help="discover replicas as FLEET_DIR/replica*/ (the "
                        "router --spawn layout)")
    p.add_argument("--replica", dest="replica_specs", action="append",
                   default=[],
                   help="explicit replica, repeatable: 'name=DIR' (DIR "
                        "holds reload.pin/reload.pin.ack)")
    p.add_argument("--deploy_dir", default=None,
                   help="ledger + probe outputs land here (default: "
                        "FLEET_DIR/deploy)")
    p.add_argument("--probe_fasta", default=None,
                   help="held-out probe set; without it the probe/ppl gate "
                        "is skipped (canary ack alone gates promotion)")
    p.add_argument("--policy", dest="policy_path", default=None,
                   help="[deploy] TOML policy (configs/serving/deploy.toml)")
    p.add_argument("--tsdb", default=None,
                   help="the fleet collector's ring-TSDB dir (live ttft "
                        "baseline; optional)")
    p.add_argument("--alerts", dest="alerts_path", default=None,
                   help="append deploy_rollback alerts to this AlertSink "
                        "ledger (alerts.jsonl)")
    p.add_argument("--alert_config", default=None,
                   help="route alerts through this [route_*] TOML "
                        "(webhooks/escalation; needs --alerts)")
    p.add_argument("--canary", default=None,
                   help="canary replica name (overrides the policy; "
                        "default: first replica)")
    p.add_argument("--interval", default=None, type=float,
                   help="tick cadence in seconds (overrides the policy)")
    p.add_argument("--once", action="store_true",
                   help="one tick, then exit (smoke/CI)")
    p.add_argument("--flight_dir", default=None,
                   help="arm the deploy controller's flight recorder: "
                        "bounded ring of recent deploy telemetry, dumped "
                        "atomically here on crash paths and on anomaly "
                        "rollback")
    p.add_argument("--max_ticks", default=0, type=int,
                   help="exit after N ticks (0 = run until signalled)")
    p.add_argument("--device", default="cuda",
                   help="the probe's device: cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    load_env_file()  # env flags (PROGEN_CHAOS, ...) before they are read
    args = build_parser().parse_args(argv)

    from progen_tpu_torch import telemetry
    from progen_tpu_torch.deploy import (
        DeployController,
        DeployPolicy,
        Replica,
        load_deploy_policy,
    )
    from progen_tpu_torch.ops import launches
    from progen_tpu_torch.resilience.chaos import install_from_env
    from progen_tpu_torch.telemetry import flight as flight_mod
    from progen_tpu_torch.tracking import JsonlTracker

    # deploy chaos sites (deploy/canary, deploy/probe, deploy/promote,
    # deploy/rollback) arm from the environment, same as cli/serve.py
    install_from_env()

    replicas = []
    for spec in args.replica_specs:
        name, sep, path = spec.partition("=")
        if not sep or not name or not path:
            sys.exit(f"bad --replica {spec!r}: expected name=DIR")
        replicas.append(Replica(name, path))
    if args.fleet_dir:
        for rdir in sorted(glob.glob(os.path.join(args.fleet_dir,
                                                  "replica*"))):
            if os.path.isdir(rdir):
                replicas.append(Replica(os.path.basename(rdir), rdir))
    if not replicas:
        sys.exit("no replicas: pass --fleet_dir or --replica name=DIR")
    deploy_dir = args.deploy_dir
    if deploy_dir is None:
        if not args.fleet_dir:
            sys.exit("--deploy_dir is required without --fleet_dir")
        deploy_dir = os.path.join(args.fleet_dir, "deploy")

    policy = (
        load_deploy_policy(args.policy_path) if args.policy_path
        else DeployPolicy()
    )
    if args.canary is not None:
        policy = dataclasses.replace(policy, canary=args.canary)
    tick_s = policy.interval_s if args.interval is None \
        else float(args.interval)

    reader = None
    if args.tsdb is not None:
        from progen_tpu_torch.telemetry.tsdb import TsdbReader

        reader = TsdbReader(args.tsdb)
    alerts = None
    router = None
    if args.alert_config is not None and args.alerts_path is None:
        sys.exit("--alert_config needs --alerts (the sink the router "
                 "relays from)")
    if args.alerts_path is not None:
        from progen_tpu_torch.telemetry.alerts import AlertSink

        if args.alert_config is not None:
            from progen_tpu_torch.telemetry.alert_router import (
                AlertRouter,
                load_router_config,
            )

            severity, routes = load_router_config(args.alert_config)
            router = AlertRouter(
                os.path.join(
                    os.path.dirname(args.alerts_path) or ".",
                    "notifications.jsonl",
                ),
                routes, severity=severity,
            )
        alerts = AlertSink(
            args.alerts_path,
            relay=router.handle if router is not None else None,
        )

    # a local run directory, never wandb: a controller must not block on
    # a login or reach for the network
    tracker = JsonlTracker("progen-deploy", None, "./runs")
    telemetry.configure(sink=tracker.log_event)
    if args.flight_dir:
        flight_mod.arm(args.flight_dir)
    ctrl = DeployController(
        args.checkpoint_path, replicas, deploy_dir, policy,
        probe_fasta=args.probe_fasta, reader=reader, alerts=alerts,
        device=args.device,
    )
    echo(
        f"deploy: {len(replicas)} replica(s), canary "
        f"{ctrl.canary.name}, ledger {ctrl.ledger.path}"
        + (f", probe {args.probe_fasta}" if args.probe_fasta
           else ", no probe")
        + (f", tsdb {args.tsdb}" if args.tsdb else ""),
        err=True,
    )

    stop = {"flag": False}

    def _stop(signum, frame):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)

    ticks = 0
    ops = {"rollback": 0, "converged": 0}
    try:
        while not stop["flag"]:
            op = ctrl.tick()
            if op is not None:
                echo(
                    f"deploy: {op} "
                    f"(fleet {ctrl.state.fleet}, "
                    f"candidate {ctrl.state.candidate})",
                    err=True,
                )
                if op in ops:
                    ops[op] += 1
            if router is not None:
                router.tick()
            ticks += 1
            if args.once or (args.max_ticks and ticks >= args.max_ticks):
                break
            deadline = time.time() + tick_s
            while not stop["flag"] and time.time() < deadline:
                time.sleep(min(0.2, tick_s))
    finally:
        ctrl.close()
        if alerts is not None:
            alerts.close()
        if router is not None:
            router.close()
        flight_mod.disarm()
        telemetry.configure()  # detach before the sink closes
        tracker.finish()
    # the probes' kernel launches in this process (none on the CPU)
    echo(
        f"deploy: {ticks} ticks, fleet {ctrl.state.fleet}, "
        f"{ops['converged']} converged, {ops['rollback']} rolled back, "
        f"launches {json.dumps(launches.launch_counts(), sort_keys=True)}",
        err=True,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

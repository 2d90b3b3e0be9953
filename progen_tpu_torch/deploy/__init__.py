"""Continuous deployment: canary, promote, rollback — zero drops. The
port's copy of the JAX package's ``deploy/``.

The train-to-serve loop closer (``progen-tpu-torch-deploy``): watch the
checkpoint dir the trainer writes, canary each new checkpoint on ONE
replica through the digest-verify + pinned-reload chain, score a
held-out probe set on it with the batch scorer, compare against the
fleet baseline (own probe of the fleet checkpoint, plus live ttft from
the collector's TSDB), then promote replica-by-replica or roll back.
Every decision is a fsync'd ``ev:"deploy"`` ledger record the
controller replays on start — SIGKILL at any phase resumes
idempotently. See ``deploy/controller.py``.
"""

from progen_tpu_torch.deploy.controller import (
    DeployController,
    DeployPolicy,
    Replica,
    load_deploy_policy,
    probe_stats,
)
from progen_tpu_torch.deploy.ledger import (
    DEPLOY_OPS,
    DeployLedger,
    LedgerState,
    fold,
    read_ledger,
    replay_state,
)

__all__ = [
    "DEPLOY_OPS",
    "DeployController",
    "DeployLedger",
    "DeployPolicy",
    "LedgerState",
    "fold",
    "Replica",
    "load_deploy_policy",
    "probe_stats",
    "read_ledger",
    "replay_state",
]

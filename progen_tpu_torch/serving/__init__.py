"""Continuous-batching serving: the slot-pool engine and its FIFO
scheduler, with the request journal, the prefix cache, the hot weight
reloader and the failover router; the port of the JAX package's
``serving/``. See engine.py for the design. Typical use:

    engine = ServeEngine(model, max_slots=8, max_len=512)
    sched = Scheduler(engine, max_queue=64)
    ok, reason = sched.submit(Request(id="r0", prime=toks, length=128))
    while sched.has_work:
        events, completions = sched.step()

Give the scheduler a ``RequestJournal`` and accepted work survives a
kill: ``replay_into`` resumes it with the uninterrupted stream.
``WeightReloader`` swaps checkpoints in between decode steps; ``Router``
fronts several ``cli.serve`` replicas and hands a dead one's journaled
work to a survivor (``handoff_states``).
"""

from progen_tpu_torch.serving.engine import (
    PendingPrefill,
    PreparedParams,
    ServeEngine,
    SlotBatch,
)
from progen_tpu_torch.serving.journal import (
    STATUS_HANDED_OFF,
    RequestJournal,
    handoff_states,
    replay_into,
    replay_requests,
)
from progen_tpu_torch.serving.metrics import ServingMetrics
from progen_tpu_torch.serving.prefix_cache import PrefixCache
from progen_tpu_torch.serving.reload import WeightReloader
from progen_tpu_torch.serving.router import (
    ReplicaSpec,
    Router,
    parse_replica_spec,
)
from progen_tpu_torch.serving.scheduler import (
    REJECT_DEADLINE,
    REJECT_DRAINING,
    REJECT_QUEUE_FULL,
    Completion,
    Request,
    Scheduler,
    TokenEvent,
)

__all__ = [
    "ServeEngine",
    "SlotBatch",
    "PendingPrefill",
    "PreparedParams",
    "PrefixCache",
    "ServingMetrics",
    "Scheduler",
    "Request",
    "TokenEvent",
    "Completion",
    "RequestJournal",
    "replay_into",
    "replay_requests",
    "handoff_states",
    "STATUS_HANDED_OFF",
    "WeightReloader",
    "Router",
    "ReplicaSpec",
    "parse_replica_spec",
    "REJECT_QUEUE_FULL",
    "REJECT_DEADLINE",
    "REJECT_DRAINING",
]

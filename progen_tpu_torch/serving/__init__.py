"""Continuous-batching serving: the slot-pool engine and its FIFO
scheduler, with the request journal and the prefix cache; the port of
the JAX package's ``serving/`` without the router and the weight
reloader. See engine.py for the design. Typical use:

    engine = ServeEngine(model, max_slots=8, max_len=512)
    sched = Scheduler(engine, max_queue=64)
    ok, reason = sched.submit(Request(id="r0", prime=toks, length=128))
    while sched.has_work:
        events, completions = sched.step()

Give the scheduler a ``RequestJournal`` and accepted work survives a
kill: ``replay_into`` resumes it with the uninterrupted stream.
"""

from progen_tpu_torch.serving.engine import (
    PendingPrefill,
    PreparedParams,
    ServeEngine,
    SlotBatch,
)
from progen_tpu_torch.serving.journal import (
    RequestJournal,
    replay_into,
    replay_requests,
)
from progen_tpu_torch.serving.metrics import ServingMetrics
from progen_tpu_torch.serving.prefix_cache import PrefixCache
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
    "REJECT_QUEUE_FULL",
    "REJECT_DEADLINE",
    "REJECT_DRAINING",
]

"""The serving fleet's network transport, the port's copy of the JAX
package's ``fleet/``: ``transport.py``, a length-prefixed binary framing
(magic + version + auth-token envelope + the JSONL line as payload)
served over TCP by ``cli.serve --tcp`` and ``cli.router --listen_tcp``,
and dialled by ``--replica tcp=HOST:PORT`` specs, with the unix-socket
wire behind the same interface (``LineConnection``, ``UnixListener``). The payload of every
frame is exactly the line the unix-socket path carries, so streams are
the same over either wire and the journal, replay and handoff work over
TCP unchanged. ``autoscaler.py`` is the policy engine over the fleet
collector's ring TSDB: queue depth, slot occupancy and latency quantiles
drive scale-up and scale-down decisions with hysteresis, cooldowns and
min/max bounds, executed by ``cli.router --autoscale``. Host-side only:
nothing here touches the card.
"""

from progen_tpu_torch.fleet.autoscaler import (
    ACTION_DOWN,
    ACTION_HOLD,
    ACTION_UP,
    Autoscaler,
    Decision,
    ScalingPolicy,
    load_policy,
)

from progen_tpu_torch.fleet.transport import (
    DEFAULT_MAX_FRAME,
    FrameDecoder,
    FrameError,
    FramedConnection,
    FramedListener,
    LineConnection,
    UnixListener,
    connect_tcp,
    encode_frame,
    fleet_token,
    parse_hostport,
)

__all__ = [
    "ACTION_DOWN",
    "ACTION_HOLD",
    "ACTION_UP",
    "Autoscaler",
    "Decision",
    "ScalingPolicy",
    "load_policy",
    "DEFAULT_MAX_FRAME",
    "FrameDecoder",
    "FrameError",
    "FramedConnection",
    "FramedListener",
    "LineConnection",
    "UnixListener",
    "connect_tcp",
    "encode_frame",
    "fleet_token",
    "parse_hostport",
]

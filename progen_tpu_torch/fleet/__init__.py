"""The serving fleet's network transport, the port's copy of the JAX
package's ``fleet/``: ``transport.py``, a length-prefixed binary framing
(magic + version + auth-token envelope + the JSONL line as payload)
served over TCP by ``cli.serve --tcp`` and ``cli.router --listen_tcp``,
and dialled by ``--replica tcp=HOST:PORT`` specs, with the unix-socket
wire behind the same interface (``LineConnection``, ``UnixListener``). The payload of every
frame is exactly the line the unix-socket path carries, so streams are
the same over either wire and the journal, replay and handoff work over
TCP unchanged. The JAX package's ``autoscaler.py`` comes with ROADMAP
queue 1 item 3. Host-side only: nothing here touches the card.
"""

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

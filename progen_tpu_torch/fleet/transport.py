"""Length-prefixed framed TCP transport for the serving fleet: the port's
copy of the JAX package's ``fleet/transport.py``, byte for byte on the
wire.

Newline-JSONL over a unix socket needs no framing: the kernel delivers
whole writes to one host and a torn final line is the writer's crash
signature. TCP gives neither guarantee to strangers — any process that
can reach the port can write bytes at it — so the fleet wire wraps
every JSONL line in a binary envelope the receiver can validate before
parsing a single byte of payload:

    magic(2B)=b"PG" | version(1B)=1 | auth_len(1B) | payload_len(4B BE)
    | auth[auth_len] | payload[payload_len]

The payload of a frame is EXACTLY the UTF-8 JSON line the unix-socket
transport would carry — the framing is transparent above this module,
which is what keeps TCP streams bit-identical to unix-socket streams
(held by the fleet kill matrix) and journal/replay/handoff
working unchanged over either wire.

Enforcement, all before payload parse:

  * bad magic / unknown version — the peer is not speaking this
    protocol (or the stream lost sync): the frame is dropped and the
    connection is condemned (``FrameError``); resync is hopeless once
    the length prefix can't be trusted;
  * auth mismatch — every frame carries the shared fleet token
    (``PROGEN_FLEET_TOKEN``); a frame with the wrong token is dropped
    and the connection condemned. Not cryptography — a fence against
    accidental cross-fleet dials and port scans; TLS is the ROADMAP
    follow-up;
  * oversized frame — ``payload_len`` above ``max_frame`` is rejected
    WITHOUT buffering the payload (a 4GB length prefix must not
    allocate 4GB);
  * idle timeout — a connection that has produced no bytes for
    ``idle_timeout`` seconds is closed by its owner loop (half-open
    TCP peers hold sockets forever; unix sockets never needed this).

Torn frames are the normal case, not an error: ``FrameDecoder`` is a
byte-stream accumulator that yields complete payloads and keeps the
tail buffered across ``feed()`` calls, so a frame split across any
number of reads reassembles exactly (the serve kill-matrix SIGKILLs a
peer mid-frame and the survivor must neither crash nor mis-parse).

``LineConnection`` and ``UnixListener`` give a unix socket the same
interface (newline-ended lines, no envelope), so one owner loop serves
either wire.

Every dropped frame leaves an ``{"ev": "frame_drop", "reason": ...}``
record plus a ``frame_drops`` counter in the process registry — a wire that silently eats frames is indistinguishable from a
healthy one until requests go missing.

Chaos sites (``PROGEN_CHAOS``, ``resilience/chaos.py``):

  * ``transport/accept`` — fires in the listener's accept path: the
    connection is accepted and immediately dropped (a flaky fronting
    LB); ``kill@N`` dies in accept;
  * ``transport/frame``  — fires per decoded frame: the frame is
    dropped and the connection condemned (a corrupted/truncated frame
    on the wire); the router treats the condemned link as replica-down
    and runs the journal-ownership handoff.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Callable, List, Optional, Tuple

from progen_tpu_torch.resilience.chaos import ChaosError, maybe_inject
from progen_tpu_torch.telemetry.registry import get_registry
from progen_tpu_torch.telemetry.spans import get_telemetry

MAGIC = b"PG"
VERSION = 1
_HEADER = struct.Struct("!2sBBI")
HEADER_BYTES = _HEADER.size  # 8
# request/event lines are small; resume payloads carry at most a few
# thousand token ids. 1 MiB is ~100x headroom, and small enough that a
# hostile length prefix can't balloon the receive buffer.
DEFAULT_MAX_FRAME = 1 << 20
_MAX_AUTH = 255

# frame_drop reasons (free-form field, but kept to this set in-tree so
# the drop records stay greppable)
DROP_BAD_MAGIC = "bad_magic"
DROP_BAD_VERSION = "bad_version"
DROP_BAD_AUTH = "bad_auth"
DROP_OVERSIZED = "oversized"
DROP_CHAOS = "chaos"
DROP_IDLE = "idle_timeout"


class FrameError(Exception):
    """Framing violation: the byte stream can no longer be trusted and
    the connection must be dropped (length-prefixed protocols cannot
    resync past a corrupt prefix)."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(f"{reason}{': ' + detail if detail else ''}")


def fleet_token() -> bytes:
    """The shared fleet auth token (``PROGEN_FLEET_TOKEN``), as frame
    envelope bytes. Empty (the default) means an open fleet — both
    sides must agree, exactly like an empty password would."""
    tok = os.environ.get("PROGEN_FLEET_TOKEN", "")
    return tok.encode("utf-8")[:_MAX_AUTH]


def _record_drop(reason: str, **attrs) -> None:
    """One drop record + counter per rejected frame. A broad except, as
    chaos.py's: the transport must keep condemning bad peers even with
    telemetry torn down."""
    try:
        get_registry().inc("frame_drops")
        rec = {"ev": "frame_drop", "ts": time.time(), "reason": reason}
        rec.update({k: v for k, v in attrs.items() if v is not None})
        get_telemetry().emit(rec)
    except Exception:
        pass


def encode_frame(payload, auth: Optional[bytes] = None) -> bytes:
    """One JSONL line (str or bytes) -> wire frame. ``auth=None`` reads
    the process-wide fleet token."""
    if isinstance(payload, str):
        payload = payload.encode("utf-8")
    if auth is None:
        auth = fleet_token()
    if len(auth) > _MAX_AUTH:
        raise ValueError(f"auth token too long ({len(auth)} > {_MAX_AUTH})")
    header = _HEADER.pack(MAGIC, VERSION, len(auth), len(payload))
    return header + auth + payload


class FrameDecoder:
    """Stateful byte-stream -> payload-line decoder. ``feed()`` returns
    every COMPLETE payload in arrival order and buffers any torn tail;
    a framing violation records the drop and raises ``FrameError`` (the
    caller owns the socket and must close it)."""

    def __init__(self, auth: Optional[bytes] = None,
                 max_frame: int = DEFAULT_MAX_FRAME,
                 peer: Optional[str] = None):
        self._auth = fleet_token() if auth is None else auth
        self.max_frame = int(max_frame)
        self.peer = peer
        self._buf = b""
        self.frames_in = 0

    @property
    def buffered(self) -> int:
        """Bytes of torn frame waiting for the rest of their read."""
        return len(self._buf)

    def _condemn(self, reason: str, detail: str = "") -> None:
        _record_drop(reason, peer=self.peer)
        self._buf = b""
        raise FrameError(reason, detail)

    def feed(self, data: bytes) -> List[str]:
        self._buf += data
        out: List[str] = []
        while len(self._buf) >= HEADER_BYTES:
            magic, version, auth_len, payload_len = _HEADER.unpack(
                self._buf[:HEADER_BYTES]
            )
            if magic != MAGIC:
                self._condemn(DROP_BAD_MAGIC, repr(magic))
            if version != VERSION:
                self._condemn(DROP_BAD_VERSION, str(version))
            if payload_len > self.max_frame:
                # reject on the prefix alone: the payload is never
                # buffered, so a hostile length can't balloon memory
                self._condemn(
                    DROP_OVERSIZED,
                    f"{payload_len} > max_frame {self.max_frame}",
                )
            total = HEADER_BYTES + auth_len + payload_len
            if len(self._buf) < total:
                break  # torn frame: wait for the next read
            auth = self._buf[HEADER_BYTES:HEADER_BYTES + auth_len]
            payload = self._buf[HEADER_BYTES + auth_len:total]
            if auth != self._auth:
                self._condemn(DROP_BAD_AUTH)
            try:
                maybe_inject("transport/frame")
            except ChaosError:
                self._condemn(DROP_CHAOS)
            self._buf = self._buf[total:]
            self.frames_in += 1
            out.append(payload.decode("utf-8", errors="replace"))
        return out


def parse_hostport(text: str) -> Tuple[str, int]:
    """``HOST:PORT`` -> (host, port); bare ``:PORT``/``PORT`` bind all
    interfaces loopback-first (``127.0.0.1``)."""
    text = text.strip()
    host, sep, port = text.rpartition(":")
    if not sep:
        host, port = "", text
    try:
        p = int(port)
        if not 0 <= p <= 65535:
            raise ValueError
    except ValueError:
        raise ValueError(f"bad HOST:PORT {text!r}") from None
    return host or "127.0.0.1", p


def connect_tcp(host: str, port: int, timeout: float = 2.0) -> socket.socket:
    """Dial one fleet peer; returns a NON-blocking connected socket
    (the same contract ReplicaLink.connect leaves a unix socket in)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.settimeout(timeout)
    try:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.connect((host, port))
    except BaseException:
        s.close()
        raise
    s.setblocking(False)
    return s


class FramedConnection:
    """One framed peer: socket + decoder + idle accounting. The owner
    loop selects on ``fileno()``, calls ``recv_lines()`` when readable,
    ``send_line()`` to answer, and ``idle_expired()`` on its tick."""

    def __init__(self, sock: socket.socket, auth: Optional[bytes] = None,
                 max_frame: int = DEFAULT_MAX_FRAME,
                 idle_timeout: float = 0.0,
                 clock: Callable[[], float] = time.monotonic,
                 peer: Optional[str] = None):
        sock.setblocking(False)
        self.sock: Optional[socket.socket] = sock
        self._auth = fleet_token() if auth is None else auth
        self._decoder = FrameDecoder(self._auth, max_frame, peer=peer)
        self.idle_timeout = float(idle_timeout)
        self._clock = clock
        self.last_rx = clock()
        self.peer = peer

    def fileno(self) -> int:
        assert self.sock is not None
        return self.sock.fileno()

    def send_line(self, line: str) -> None:
        """Frame + send one JSONL line. Bounded blocking send, the
        ReplicaLink.send discipline: a peer that can't drain a few KB
        in 5s is down, and a partial frame would corrupt the stream
        anyway — the raised OSError tells the owner to drop us."""
        assert self.sock is not None
        data = encode_frame(line, self._auth)
        self.sock.settimeout(5.0)
        try:
            self.sock.sendall(data)
        finally:
            if self.sock is not None:
                self.sock.setblocking(False)

    def recv_lines(self) -> Tuple[List[str], bool]:
        """Drain the socket: (complete payload lines, eof). A framing
        violation reads as EOF — the record is already written by the
        decoder, and a condemned connection and a closed one get the
        same treatment from every owner."""
        if self.sock is None:
            return [], True
        chunks: List[bytes] = []
        eof = False
        while True:
            try:
                data = self.sock.recv(65536)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                data = b""
            if not data:
                eof = True
                break
            chunks.append(data)
        lines: List[str] = []
        if chunks:
            self.last_rx = self._clock()
            try:
                lines = self._decoder.feed(b"".join(chunks))
            except FrameError:
                return lines, True
        return lines, eof

    def idle_expired(self, now: Optional[float] = None) -> bool:
        """True once this peer has been silent past ``idle_timeout``
        (0 = never). Records the drop exactly once; the owner closes."""
        if self.idle_timeout <= 0 or self.sock is None:
            return False
        now = self._clock() if now is None else now
        if now - self.last_rx <= self.idle_timeout:
            return False
        _record_drop(DROP_IDLE, peer=self.peer)
        return True

    def close(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
        self.sock = None


class FramedListener:
    """TCP listener producing ``FramedConnection`` peers. ``port=0``
    binds an ephemeral port; the bound port is ``self.port`` (printed
    by the CLIs so tests and operators can dial it)."""

    def __init__(self, host: str, port: int,
                 auth: Optional[bytes] = None,
                 max_frame: int = DEFAULT_MAX_FRAME,
                 idle_timeout: float = 0.0, backlog: int = 16):
        self._auth = fleet_token() if auth is None else auth
        self.max_frame = int(max_frame)
        self.idle_timeout = float(idle_timeout)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(backlog)
        srv.setblocking(False)
        self.sock = srv
        self.host, self.port = srv.getsockname()[:2]

    def fileno(self) -> int:
        return self.sock.fileno()

    def accept(self) -> Optional[FramedConnection]:
        """One accept; None when nothing is waiting or chaos dropped
        the dial (``transport/accept`` — the connection is accepted
        then immediately closed, a flaky fronting LB)."""
        try:
            conn, addr = self.sock.accept()
        except (BlockingIOError, InterruptedError):
            return None
        except OSError:
            return None
        try:
            maybe_inject("transport/accept")
        except ChaosError:
            get_registry().inc("accept_drops")
            conn.close()
            return None
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        peer = f"{addr[0]}:{addr[1]}" if isinstance(addr, tuple) else None
        return FramedConnection(
            conn, self._auth, self.max_frame, self.idle_timeout, peer=peer
        )

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class LineConnection:
    """A unix-socket peer behind ``FramedConnection``'s interface:
    newline-ended JSONL lines instead of frames (a unix socket needs no
    envelope: the kernel delivers whole writes to one host), never
    idle."""

    def __init__(self, sock: socket.socket):
        sock.setblocking(False)
        self.sock = sock
        self._buf = b""

    def fileno(self) -> int:
        return self.sock.fileno()

    def send_line(self, line: str) -> None:
        # a bounded blocking send, as FramedConnection's: a peer that
        # cannot take a few KB in 5 s is gone
        self.sock.settimeout(5.0)
        try:
            self.sock.sendall(line.encode() + b"\n")
        finally:
            if self.sock is not None:
                self.sock.setblocking(False)

    def recv_lines(self) -> Tuple[List[str], bool]:
        """(complete lines, eof) from what the socket holds now."""
        chunks, eof = [], False
        while True:
            try:
                data = self.sock.recv(65536)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                data = b""
            if not data:
                eof = True
                break
            chunks.append(data)
        *lines, self._buf = (self._buf + b"".join(chunks)).split(b"\n")
        return [ln.decode("utf-8", "replace") for ln in lines], eof

    def idle_expired(self) -> bool:
        return False

    def close(self) -> None:
        if self.sock is not None:
            self.sock.close()
        self.sock = None


class UnixListener:
    """A unix-socket server behind ``FramedListener``'s interface: the
    owner loop selects on it and ``accept()``s ``LineConnection`` peers.
    ``close()`` also removes the socket file."""

    def __init__(self, path: str):
        if os.path.exists(path):
            os.unlink(path)
        self.path = path
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.bind(path)
        self.sock.listen(16)
        self.sock.setblocking(False)

    def fileno(self) -> int:
        return self.sock.fileno()

    def accept(self) -> Optional[LineConnection]:
        try:
            conn, _ = self.sock.accept()
        except OSError:
            return None
        return LineConnection(conn)

    def close(self) -> None:
        self.sock.close()
        if os.path.exists(self.path):
            os.unlink(self.path)

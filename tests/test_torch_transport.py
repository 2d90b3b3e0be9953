"""The port's framed transport (``progen_tpu_torch/fleet/transport.py``):
the cases of ``tests/test_fleet_transport.py`` against the port's copy
(the frame codec, torn reads, the oversized, magic, version, auth and
chaos condemnations with their ``frame_drop`` records, the listener,
the idle timeout), and the wire held against the JAX package's codec:
frames the JAX encoder writes decode with the port's decoder and frames
the port writes decode with the JAX one, byte for byte, with and without
auth. The unix-socket peer of the same interface (``LineConnection``,
``UnixListener``) closes the file.
"""

import json
import os
import select
import socket
import struct
import time

import pytest

from progen_tpu.fleet import transport as jax_transport
from progen_tpu_torch import telemetry
from progen_tpu_torch.fleet.transport import (
    DEFAULT_MAX_FRAME,
    HEADER_BYTES,
    MAGIC,
    VERSION,
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
from progen_tpu_torch.resilience import chaos


@pytest.fixture
def drop_records():
    """Capture telemetry records emitted during a test (frame drops
    land here); restores the default sink afterwards."""
    records = []
    telemetry.configure(sink=records.append)
    try:
        yield records
    finally:
        telemetry.configure(sink=None)


def _drops(records, reason):
    return [
        r for r in records
        if r.get("ev") == "frame_drop" and r.get("reason") == reason
    ]


class TestFrameCodec:
    def test_roundtrip_single_frame(self):
        dec = FrameDecoder(auth=b"")
        line = json.dumps({"id": "r1", "length": 16})
        out = dec.feed(encode_frame(line, auth=b""))
        assert out == [line]
        assert dec.frames_in == 1
        assert dec.buffered == 0

    def test_payload_is_exactly_the_jsonl_line(self):
        # the frame boundary REPLACES the newline: payload bytes are
        # the unix-socket line verbatim — the bit-parity property
        line = '{"event": "token", "id": "r1", "index": 3, "token": 7}'
        frame = encode_frame(line, auth=b"t")
        assert frame[HEADER_BYTES + 1:] == line.encode()
        assert b"\n" not in frame[HEADER_BYTES + 1:]

    def test_split_reads_byte_at_a_time(self):
        dec = FrameDecoder(auth=b"tok")
        line = json.dumps({"id": "torn", "prime": "MKV" * 20})
        frame = encode_frame(line, auth=b"tok")
        got = []
        for i in range(len(frame)):
            got.extend(dec.feed(frame[i:i + 1]))
            if i < len(frame) - 1:
                assert got == []  # never yields a torn frame early
        assert got == [line]
        assert dec.buffered == 0

    def test_multiple_frames_and_torn_tail(self):
        dec = FrameDecoder(auth=b"")
        lines = [json.dumps({"i": i}) for i in range(3)]
        wire = b"".join(encode_frame(ln, auth=b"") for ln in lines)
        cut = len(wire) - 5  # tear the last frame
        assert dec.feed(wire[:cut]) == lines[:2]
        assert dec.buffered > 0
        assert dec.feed(wire[cut:]) == [lines[2]]
        assert dec.frames_in == 3

    def test_oversized_rejected_on_prefix_alone(self, drop_records):
        # the payload NEVER arrives: the length prefix alone condemns,
        # so a hostile 1GB length cannot balloon the receive buffer
        dec = FrameDecoder(auth=b"", max_frame=64)
        header = struct.pack("!2sBBI", MAGIC, VERSION, 0, 1 << 30)
        with pytest.raises(FrameError) as exc:
            dec.feed(header)
        assert exc.value.reason == "oversized"
        assert dec.buffered == 0  # condemned: buffer cleared
        assert len(_drops(drop_records, "oversized")) == 1

    def test_exact_max_frame_is_accepted(self):
        dec = FrameDecoder(auth=b"", max_frame=32)
        line = "x" * 32
        assert dec.feed(encode_frame(line, auth=b"")) == [line]

    def test_bad_magic_condemns(self, drop_records):
        dec = FrameDecoder(auth=b"")
        frame = bytearray(encode_frame("{}", auth=b""))
        frame[0:2] = b"GE"  # a stray HTTP client
        with pytest.raises(FrameError) as exc:
            dec.feed(bytes(frame))
        assert exc.value.reason == "bad_magic"
        assert _drops(drop_records, "bad_magic")

    def test_bad_version_condemns(self, drop_records):
        dec = FrameDecoder(auth=b"")
        frame = bytearray(encode_frame("{}", auth=b""))
        frame[2] = VERSION + 1
        with pytest.raises(FrameError) as exc:
            dec.feed(bytes(frame))
        assert exc.value.reason == "bad_version"
        assert _drops(drop_records, "bad_version")

    def test_bad_auth_condemns(self, drop_records):
        dec = FrameDecoder(auth=b"fleet-a")
        with pytest.raises(FrameError) as exc:
            dec.feed(encode_frame("{}", auth=b"fleet-b"))
        assert exc.value.reason == "bad_auth"
        assert _drops(drop_records, "bad_auth")

    def test_matching_auth_roundtrip(self):
        dec = FrameDecoder(auth=b"secret")
        assert dec.feed(encode_frame("ok", auth=b"secret")) == ["ok"]

    def test_auth_too_long_raises(self):
        with pytest.raises(ValueError):
            encode_frame("{}", auth=b"x" * 256)

    def test_fleet_token_reads_env(self, monkeypatch):
        monkeypatch.setenv("PROGEN_FLEET_TOKEN", "tok-123")
        assert fleet_token() == b"tok-123"
        monkeypatch.delenv("PROGEN_FLEET_TOKEN")
        assert fleet_token() == b""

    def test_chaos_frame_condemns(self, drop_records):
        chaos.install("transport/frame:fail@1")
        try:
            dec = FrameDecoder(auth=b"")
            with pytest.raises(FrameError) as exc:
                dec.feed(encode_frame("{}", auth=b""))
            assert exc.value.reason == "chaos"
        finally:
            chaos.uninstall()
        assert _drops(drop_records, "chaos")


class TestParseHostport:
    @pytest.mark.parametrize("text,expect", [
        ("127.0.0.1:9000", ("127.0.0.1", 9000)),
        ("0.0.0.0:0", ("0.0.0.0", 0)),
        (":7070", ("127.0.0.1", 7070)),
        ("8080", ("127.0.0.1", 8080)),
        (" 10.0.0.5:31337 ", ("10.0.0.5", 31337)),
    ])
    def test_accepts(self, text, expect):
        assert parse_hostport(text) == expect

    @pytest.mark.parametrize("text", ["", "host:", "host:beef", "70000",
                                      "1.2.3.4:-1"])
    def test_rejects(self, text):
        with pytest.raises(ValueError):
            parse_hostport(text)


def _accept_blocking(listener, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        r, _, _ = select.select([listener], [], [], 0.2)
        if r:
            conn = listener.accept()
            if conn is not None:
                return conn
    raise AssertionError("no connection accepted")


def _recv_blocking(conn, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        r, _, _ = select.select([conn], [], [], 0.2)
        if r:
            lines, eof = conn.recv_lines()
            if lines or eof:
                return lines, eof
    raise AssertionError("no lines received")


class TestFramedLoopback:
    def test_listener_roundtrip(self):
        listener = FramedListener("127.0.0.1", 0, auth=b"tok")
        try:
            assert listener.port != 0  # ephemeral port resolved
            csock = connect_tcp("127.0.0.1", listener.port)
            client = FramedConnection(csock, auth=b"tok")
            server = _accept_blocking(listener)
            try:
                client.send_line('{"id": "r1"}')
                lines, eof = _recv_blocking(server)
                assert lines == ['{"id": "r1"}'] and not eof
                server.send_line('{"event": "done", "id": "r1"}')
                lines, _ = _recv_blocking(client)
                assert lines == ['{"event": "done", "id": "r1"}']
            finally:
                client.close()
                server.close()
        finally:
            listener.close()

    def test_peer_close_reads_as_eof(self):
        listener = FramedListener("127.0.0.1", 0, auth=b"")
        try:
            csock = connect_tcp("127.0.0.1", listener.port)
            client = FramedConnection(csock, auth=b"")
            server = _accept_blocking(listener)
            client.close()
            _, eof = _recv_blocking(server)
            assert eof
            server.close()
        finally:
            listener.close()

    def test_condemned_stream_reads_as_eof(self, drop_records):
        # a raw peer writing garbage: the server's recv_lines must
        # surface eof (the handoff treatment), never raise
        listener = FramedListener("127.0.0.1", 0, auth=b"tok")
        try:
            raw = socket.create_connection(
                ("127.0.0.1", listener.port), timeout=5
            )
            server = _accept_blocking(listener)
            raw.sendall(b"GET / HTTP/1.1\r\n\r\n")
            lines, eof = _recv_blocking(server)
            assert lines == [] and eof
            assert _drops(drop_records, "bad_magic")
            raw.close()
            server.close()
        finally:
            listener.close()

    def test_chaos_accept_drop(self):
        listener = FramedListener("127.0.0.1", 0, auth=b"")
        chaos.install("transport/accept:fail@1")
        try:
            csock = connect_tcp("127.0.0.1", listener.port)
            deadline = time.time() + 5
            accepted = "pending"
            while time.time() < deadline:
                r, _, _ = select.select([listener], [], [], 0.2)
                if r:
                    accepted = listener.accept()
                    break
            # the dial was accepted then dropped (flaky LB): None, and
            # the client sees the close as EOF on its next read
            assert accepted is None
            csock.close()
        finally:
            chaos.uninstall()
            listener.close()

    def test_idle_timeout_expiry(self):
        listener = FramedListener("127.0.0.1", 0, auth=b"")
        try:
            csock = connect_tcp("127.0.0.1", listener.port)
            clock = {"now": 100.0}
            server_sock = _accept_blocking(listener)
            conn = FramedConnection(
                server_sock.sock, auth=b"", idle_timeout=2.0,
                clock=lambda: clock["now"],
            )
            assert not conn.idle_expired()
            clock["now"] += 2.0
            assert not conn.idle_expired()  # exactly at the bound: alive
            clock["now"] += 0.5
            assert conn.idle_expired()
            conn.close()
            csock.close()
        finally:
            listener.close()

    def test_idle_timeout_zero_never_expires(self):
        listener = FramedListener("127.0.0.1", 0, auth=b"")
        try:
            csock = connect_tcp("127.0.0.1", listener.port)
            clock = {"now": 0.0}
            server_sock = _accept_blocking(listener)
            conn = FramedConnection(
                server_sock.sock, auth=b"", idle_timeout=0.0,
                clock=lambda: clock["now"],
            )
            clock["now"] += 1e9
            assert not conn.idle_expired()
            conn.close()
            csock.close()
        finally:
            listener.close()

    def test_recv_resets_idle_clock(self):
        listener = FramedListener("127.0.0.1", 0, auth=b"")
        try:
            csock = connect_tcp("127.0.0.1", listener.port)
            client = FramedConnection(csock, auth=b"")
            clock = {"now": 10.0}
            server_sock = _accept_blocking(listener)
            conn = FramedConnection(
                server_sock.sock, auth=b"", idle_timeout=5.0,
                clock=lambda: clock["now"],
            )
            clock["now"] += 4.0
            client.send_line("ping")
            _recv_blocking(conn)  # rx stamps last_rx at now=14
            clock["now"] += 4.0  # 8s since connect, 4s since traffic
            assert not conn.idle_expired()
            client.close()
            conn.close()
        finally:
            listener.close()


class TestChaosTargets:
    def test_fleet_targets_are_known(self):
        for target in ("transport/accept", "transport/frame",
                       "autoscaler/decide"):
            assert target in chaos.KNOWN_TARGETS


LINES = [
    "{}",
    json.dumps({"id": "r1", "prime": "MKV", "length": 16}),
    json.dumps({"event": "token", "id": "q3-r1", "token": 77,
                "text": "\u00e9", "index": 18}),
    json.dumps({"id": "res", "prime_tokens": list(range(300)),
                "seed": 7, "draw_offset": 12}),
]


class TestAgainstTheJaxCodec:
    """The wire is the JAX package's, byte for byte."""

    @pytest.mark.parametrize("auth", [b"", b"fleet-token"])
    @pytest.mark.parametrize("line", LINES)
    def test_frames_are_byte_identical(self, line, auth):
        assert encode_frame(line, auth=auth) == \
            jax_transport.encode_frame(line, auth=auth)

    @pytest.mark.parametrize("auth", [b"", b"fleet-token"])
    def test_jax_frames_decode_with_the_port(self, auth):
        wire = b"".join(jax_transport.encode_frame(ln, auth=auth)
                        for ln in LINES)
        dec = FrameDecoder(auth=auth)
        got = []
        for i in range(0, len(wire), 7):  # torn on odd boundaries
            got += dec.feed(wire[i:i + 7])
        assert got == LINES and dec.buffered == 0

    @pytest.mark.parametrize("auth", [b"", b"fleet-token"])
    def test_port_frames_decode_with_jax(self, auth):
        wire = b"".join(encode_frame(ln, auth=auth) for ln in LINES)
        dec = jax_transport.FrameDecoder(auth=auth)
        got = []
        for i in range(0, len(wire), 5):
            got += dec.feed(wire[i:i + 5])
        assert got == LINES and dec.buffered == 0

    def test_wrong_token_condemned_both_ways(self):
        with pytest.raises(FrameError):
            FrameDecoder(auth=b"a").feed(
                jax_transport.encode_frame("{}", auth=b"b"))
        with pytest.raises(jax_transport.FrameError):
            jax_transport.FrameDecoder(auth=b"a").feed(
                encode_frame("{}", auth=b"b"))

    @pytest.mark.parametrize("text", ["127.0.0.1:9000", ":7070", "8080",
                                      "host:beef", ""])
    def test_parse_hostport_agrees(self, text):
        def parse(fn):
            try:
                return fn(text)
            except ValueError:
                return "ValueError"

        assert parse(parse_hostport) == parse(jax_transport.parse_hostport)


class TestUnixLines:
    def test_roundtrip_and_eof(self, tmp_path):
        path = str(tmp_path / "s.sock")
        listener = UnixListener(path)
        try:
            raw = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            raw.connect(path)
            client = LineConnection(raw)
            server = _accept_blocking(listener)
            client.send_line('{"id": "r1"}')
            client.send_line('{"id": "r2"}')
            got = []
            while len(got) < 2:
                lines, eof = _recv_blocking(server)
                got += lines
                assert not eof
            assert got == ['{"id": "r1"}', '{"id": "r2"}']
            assert not server.idle_expired()
            client.close()
            _, eof = _recv_blocking(server)
            assert eof
            server.close()
        finally:
            listener.close()
        assert not os.path.exists(path)  # close removes the socket file


def test_default_max_frame_sane():
    assert DEFAULT_MAX_FRAME == 1 << 20

"""TFRecord I/O without TensorFlow: the port's copy of the JAX package's
``data/tfrecord.py``, byte for byte in what it writes and reads.

  * Record framing: ``uint64le length | uint32le masked_crc32c(length) |
    payload | uint32le masked_crc32c(payload)``, with the TFRecord mask
    ``((crc >> 15 | crc << 17) + 0xa282ead8) & 0xffffffff`` over CRC-32C
    (Castagnoli).
  * Payload: a ``tf.train.Example`` protobuf holding one bytes feature
    ``'seq'``, hand-encoded (nested length-delimited fields), no protobuf
    runtime needed.
  * Whole-file gzip, matching ``TFRecordOptions(compression_type='GZIP')``.

Record encoding and whole-file parsing run in the native engine
(``_native``, ``native/tfrecord_io.cc``) when it builds; the pure-Python
codec below is the fallback and its golden.
"""

from __future__ import annotations

import gzip
import io
import struct
from contextlib import contextmanager
from typing import Iterator

from progen_tpu_torch.data import _native


def _crc_table() -> list:
    poly = 0x82F63B78  # reversed Castagnoli
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC_TABLE = _crc_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire codec for tf.train.Example{features{feature{'seq'}}}
# ---------------------------------------------------------------------------

_LEN = 2  # wire type: length-delimited


def _tag(field: int, wire: int = _LEN) -> bytes:
    return _varint((field << 3) | wire)


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _ld(field: int, payload: bytes) -> bytes:
    """One length-delimited field."""
    return _tag(field) + _varint(len(payload)) + payload


def encode_example(seq: bytes, key: str = "seq") -> bytes:
    """Serialize tf.train.Example{features: {key: bytes_list([seq])}}:
    Example.features(1) -> Features.feature(1) map entry {key(1),
    value(2)} -> Feature.bytes_list(1) -> BytesList.value(1)."""
    bytes_list = _ld(1, seq)
    feature = _ld(1, bytes_list)
    entry = _ld(1, key.encode()) + _ld(2, feature)
    features = _ld(1, entry)
    return _ld(1, features)


def decode_example(payload: bytes, key: str = "seq") -> bytes:
    """Extract the ``key`` bytes feature from a serialized Example.
    Unknown fields are skipped by wire type, so files with extra features
    still parse."""

    def fields(buf: bytes) -> Iterator[tuple[int, int, bytes | int]]:
        pos = 0
        while pos < len(buf):
            tag, pos = _read_varint(buf, pos)
            field, wire = tag >> 3, tag & 0x7
            if wire == _LEN:
                ln, pos = _read_varint(buf, pos)
                yield field, wire, buf[pos : pos + ln]
                pos += ln
            elif wire == 0:  # varint
                val, pos = _read_varint(buf, pos)
                yield field, wire, val
            elif wire == 5:  # 32-bit
                yield field, wire, buf[pos : pos + 4]
                pos += 4
            elif wire == 1:  # 64-bit
                yield field, wire, buf[pos : pos + 8]
                pos += 8
            else:
                raise ValueError(f"unsupported wire type {wire}")

    for f, _, features in fields(payload):
        if f != 1:
            continue
        for f2, _, entry in fields(features):
            if f2 != 1:
                continue
            entry_key = None
            value = None
            for f3, _, v in fields(entry):
                if f3 == 1:
                    entry_key = v
                elif f3 == 2:
                    value = v
            if entry_key != key.encode():
                continue
            for f4, _, blist in fields(value):
                if f4 == 1:  # bytes_list
                    for f5, _, item in fields(blist):
                        if f5 == 1:
                            return bytes(item)
    raise KeyError(f"feature {key!r} not found in example")


# ---------------------------------------------------------------------------
# Record framing
# ---------------------------------------------------------------------------


def write_record(fp, payload: bytes) -> None:
    header = struct.pack("<Q", len(payload))
    fp.write(header)
    fp.write(struct.pack("<I", _masked_crc(header)))
    fp.write(payload)
    fp.write(struct.pack("<I", _masked_crc(payload)))


def read_records(fp) -> Iterator[bytes]:
    while True:
        header = fp.read(8)
        if not header:
            return
        if len(header) < 8:
            raise EOFError("truncated record header")
        (length,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", fp.read(4))
        if crc != _masked_crc(header):
            raise ValueError("corrupt record: length crc mismatch")
        payload = fp.read(length)
        if len(payload) < length:
            raise EOFError("truncated record payload")
        (crc,) = struct.unpack("<I", fp.read(4))
        if crc != _masked_crc(payload):
            raise ValueError("corrupt record: payload crc mismatch")
        yield payload


@contextmanager
def tfrecord_writer(path: str, key: str = "seq"):
    """Context manager yielding ``write(seq_bytes)``: a gzip TFRecord
    file of single-bytes-feature Examples."""
    with gzip.open(path, "wb") as fp:

        def write(seq: bytes) -> None:
            rec = _native.encode_record(seq, key.encode())
            if rec is not None:
                fp.write(rec)
            else:
                write_record(fp, encode_example(seq, key))

        yield write


def _read_file_bytes(path: str) -> bytes:
    with gzip.open(path, "rb") as fp:
        return fp.read()


def read_tfrecords(path: str, key: str = "seq") -> Iterator[bytes]:
    """Yield the ``key`` feature of every Example in a gzip TFRecord file.
    The file is decompressed whole under the retry policy (label
    ``data/read``: a transient file-system fault is retried with backoff,
    and a retry starts again from byte 0, so no record is yielded twice),
    then parsed in one native call when the engine is available, else by
    the Python codec."""
    from progen_tpu_torch.resilience.retry import retry_call

    data = retry_call(_read_file_bytes, path, label="data/read")
    if _native.load() is not None:
        yield from _native.parse_file(data, key.encode())
        return
    for payload in read_records(io.BytesIO(data)):
        yield decode_example(payload, key)

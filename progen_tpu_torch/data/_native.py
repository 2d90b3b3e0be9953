"""Build and load (through ctypes) the native TFRecord engine.

Compiles the repository's ``native/tfrecord_io.cc`` with g++ on first use
(plain C ABI, bound with ctypes) into ``build/native/``, named by a hash
of the source, so an edited source rebuilds. ``load()`` returns None when
the source or the compiler is missing, and the callers then use the
pure-Python codec; ``PROGEN_TPU_NATIVE=0`` asks for that codec.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

_REPO = Path(__file__).resolve().parents[2]
_SRC = _REPO / "native" / "tfrecord_io.cc"
_OUT_DIR = _REPO / "build" / "native"
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _build(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = _OUT_DIR / f"libtfrecord_io_{digest}.so"
    if not out.exists():
        _OUT_DIR.mkdir(parents=True, exist_ok=True)
        # one file per process: concurrent builds each write their own
        # and the atomic rename publishes one of them (same content)
        tmp = out.with_suffix(f".so.tmp.{os.getpid()}")
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(src)],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, out)
        for stale in _OUT_DIR.glob("libtfrecord_io_*.so"):
            if stale != out:
                stale.unlink(missing_ok=True)
    return out


def load() -> Optional[ctypes.CDLL]:
    """The native library, or None (no source or compiler, or opted out)."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed or os.environ.get("PROGEN_TPU_NATIVE") == "0":
        return None
    try:
        lib = ctypes.CDLL(str(_build(_SRC)))
    except (OSError, subprocess.CalledProcessError):
        _load_failed = True
        return None

    lib.tfio_crc32c.restype = ctypes.c_uint32
    lib.tfio_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.tfio_masked_crc.restype = ctypes.c_uint32
    lib.tfio_masked_crc.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.tfio_parse_records.restype = ctypes.c_long
    lib.tfio_parse_records.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long),
        ctypes.c_long,
        ctypes.c_int,
    ]
    lib.tfio_example_seq.restype = ctypes.c_long
    lib.tfio_example_seq.argtypes = [
        ctypes.c_void_p,  # payload pointer (base + offset, zero-copy)
        ctypes.c_long,
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.tfio_encoded_size.restype = ctypes.c_long
    lib.tfio_encoded_size.argtypes = [ctypes.c_long, ctypes.c_long]
    lib.tfio_encode_record.restype = ctypes.c_long
    lib.tfio_encode_record.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_char_p,
        ctypes.c_long,
    ]
    lib.tfio_collate.restype = None
    lib.tfio_collate.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),  # per-record base pointers
        ctypes.POINTER(ctypes.c_long),
        ctypes.c_long,
        ctypes.c_long,
        ctypes.c_long,
        ctypes.c_void_p,  # int32 (n, seq_len+1) output buffer
    ]
    _lib = lib
    return _lib


def parse_file(data: bytes, key: bytes = b"seq", verify_crc: bool = True):
    """Decompressed TFRecord buffer -> list of ``key`` feature bytes, the
    framing and proto work in C++. None if the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    max_records = max(1, len(data) // 16)  # min framed record = 16 bytes
    offsets = (ctypes.c_long * max_records)()
    lengths = (ctypes.c_long * max_records)()
    n = lib.tfio_parse_records(
        data, len(data), offsets, lengths, max_records, int(verify_crc)
    )
    if n < 0:
        raise ValueError(f"corrupt tfrecord buffer at byte {-(n + 1)}")
    # the payloads are read in place (base address + offset into the
    # same buffer); only each extracted sequence is copied out
    base = ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value
    out = []
    seq_off = ctypes.c_long()
    for i in range(n):
        slen = lib.tfio_example_seq(
            ctypes.c_void_p(base + offsets[i]),
            lengths[i],
            key,
            len(key),
            ctypes.byref(seq_off),
        )
        if slen < 0:
            raise KeyError(f"feature {key!r} not found in record {i}")
        start = offsets[i] + seq_off.value
        out.append(data[start : start + slen])
    return out


def encode_record(seq: bytes, key: bytes = b"seq") -> Optional[bytes]:
    """One framed TFRecord (header + crc + Example + crc) built in C++,
    or None."""
    lib = load()
    if lib is None:
        return None
    size = lib.tfio_encoded_size(len(seq), len(key))
    buf = ctypes.create_string_buffer(size)
    written = lib.tfio_encode_record(seq, len(seq), key, len(key), buf, size)
    if written < 0:
        raise RuntimeError("native encode buffer undersized")
    return buf.raw[:written]


def collate(records, seq_len: int, offset: int = 1):
    """Batch collation in C++: raw sequence bytes -> (n, seq_len + 1)
    int32 (truncate, + offset, right-pad 0, BOS column, the semantics of
    ``dataset.collate``). None if the library is unavailable."""
    import numpy as np

    lib = load()
    if lib is None:
        return None
    n = len(records)
    out = np.empty((n, seq_len + 1), dtype=np.int32)
    if n:
        ptrs = (ctypes.c_char_p * n)(*records)
        lens = (ctypes.c_long * n)(*(len(r) for r in records))
        lib.tfio_collate(
            ptrs, lens, n, seq_len, offset,
            out.ctypes.data_as(ctypes.c_void_p),
        )
    return out

"""Hashed prefix cache for chunked prefill: batch-1 cache snapshots.

The port's copy of the JAX package's ``serving/prefix_cache.py``. Many
requests share one scaffold (a template prefix, a prompt, an infill
frame) and differ only in the tail and the sampling knobs. The batch-1
decode cache after feeding ``tokens[0:d]`` is a function of those d
tokens and the weights alone (the knobs, the seed and the request play
no part before the first draw), so a snapshot taken at depth d can seed
any later request whose first d tokens match, bit for bit.

An LRU over such snapshots, keyed on ``(depth, sha1 of the tokens)``.
``ServeEngine.advance_prefill`` inserts at every chunk boundary;
``begin_prefill`` looks up the deepest stored prefix of a request's feed
region and resumes there. A byte budget bounds device memory: a snapshot
costs the sum of its tensors' ``nbytes``, and an insert past the budget
evicts the least recently used entries first. A snapshot is a clone, and
``lookup`` hands out a clone too: the decoder updates a cache in place,
so neither the pool nor a request in flight may share a snapshot's
storage.

Weights are the one invalidation hazard: ``ServeEngine.commit_params``
calls ``clear()``. Counters survive a clear.

Telemetry: one ``{"ev": "prefix_cache", "op": "hit"|"miss"|"evict"}``
record per event.
"""

from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from typing import Any, Optional, Tuple

import numpy as np

from progen_tpu_torch.telemetry.spans import get_telemetry


def _digest(row: np.ndarray, depth: int) -> bytes:
    return hashlib.sha1(
        np.ascontiguousarray(row[:depth], np.int32).tobytes()
    ).digest()


class PrefixCache:
    """LRU of (token prefix -> batch-1 ``DecodeCache`` snapshot) under a
    byte budget. Single-threaded, like the scheduler that feeds it."""

    def __init__(self, max_bytes: int):
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.max_bytes = int(max_bytes)
        # (depth, digest) -> (snapshot, nbytes), oldest first
        self._entries: "OrderedDict[Tuple[int, bytes], Tuple[Any, int]]" \
            = OrderedDict()
        # the depths present, so a lookup probes only real candidates
        self._depth_counts: dict = {}
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.inserts = 0

    def __len__(self) -> int:
        return len(self._entries)

    def _emit(self, op: str, depth: int) -> None:
        get_telemetry().emit({
            "ev": "prefix_cache", "op": op, "ts": time.time(),
            "depth": int(depth), "bytes": int(self.bytes),
            "entries": len(self._entries),
        })

    def lookup(self, row: np.ndarray, feed_len: int
               ) -> Tuple[int, Optional[Any]]:
        """(depth, a clone of the snapshot) for the deepest stored prefix
        of ``row[:feed_len]``, or ``(0, None)``. A hit refreshes the
        entry's LRU position. A snapshot deeper than ``feed_len`` would
        hold positions this request primes differently, so it is not
        used."""
        row = np.asarray(row, np.int32).reshape(-1)
        for depth in sorted(self._depth_counts, reverse=True):
            if depth > feed_len:
                continue
            key = (depth, _digest(row, depth))
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                self._emit("hit", depth)
                return depth, entry[0].clone()
        self.misses += 1
        self._emit("miss", 0)
        return 0, None

    def insert(self, row: np.ndarray, depth: int, cache) -> bool:
        """Store a clone of ``cache``, the state after feeding
        ``row[:depth]``. A prefix already present is refreshed, not
        stored again; a snapshot larger than the whole budget is
        skipped; LRU entries are evicted until the new one fits. Returns
        True when stored."""
        if depth < 1:
            return False
        row = np.asarray(row, np.int32).reshape(-1)
        key = (depth, _digest(row, depth))
        if key in self._entries:
            self._entries.move_to_end(key)
            return False
        nbytes = cache.nbytes
        if nbytes > self.max_bytes:
            return False
        while self._entries and self.bytes + nbytes > self.max_bytes:
            self._evict_lru()
        self._entries[key] = (cache.clone(), nbytes)
        self._depth_counts[depth] = self._depth_counts.get(depth, 0) + 1
        self.bytes += nbytes
        self.inserts += 1
        return True

    def _evict_lru(self) -> None:
        (depth, _), (_, nbytes) = self._entries.popitem(last=False)
        self.bytes -= nbytes
        self._depth_counts[depth] -= 1
        if self._depth_counts[depth] == 0:
            del self._depth_counts[depth]
        self.evictions += 1
        self._emit("evict", depth)

    def clear(self) -> None:
        """Drop every snapshot (new weights). Counters are kept."""
        self._entries.clear()
        self._depth_counts.clear()
        self.bytes = 0

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "inserts": self.inserts,
            "bytes": self.bytes,
            "entries": len(self._entries),
        }

"""TFRecord dataset iterator: resumable, sharded by process, prefetched.

The port's copy of the JAX package's ``data/dataset.py``, with its
semantics:
  * glob ``{folder}/**/*.{train|valid}.tfrecord.gz``;
  * the total sequence count from the ``{i}.{count}.{split}.tfrecord.gz``
    filename contract, and files in numeric order of ``i``;
  * ``iter_fn(seq_len, batch_size, skip, loop, ...)`` yielding int32
    batches of shape (batch, seq_len + 1): truncate to seq_len, + 1
    tokenizer offset, right-pad with 0, a 0-valued BOS column first;
  * ``skip`` counts global records, so a resume replays the same stream;
  * records dealt round-robin by global index over processes;
  * a background thread prefetches batches.

A ``gs://`` folder raises: Cloud Storage is not ported yet.
"""

from __future__ import annotations

import queue
import re
import threading
from pathlib import Path
from typing import Callable, Iterator, List, Tuple

import numpy as np

from progen_tpu_torch.data import _native
from progen_tpu_torch.data.tfrecord import read_tfrecords

_FILENAME_RE = re.compile(r"(\d+)\.(\d+)\.(train|valid)\.tfrecord\.gz$")


def reject_gcs(path: str) -> None:
    """Raise for a ``gs://`` path: the port reads and writes local files
    only."""
    if str(path).startswith("gs://"):
        raise ValueError(
            f"{path}: Google Cloud Storage paths are not ported to "
            "progen_tpu_torch yet; copy the data to a local directory"
        )


def count_from_filename(path: str) -> int:
    """Sequence count from the {i}.{count}.{split} contract."""
    m = _FILENAME_RE.search(path)
    if not m:
        raise ValueError(f"filename breaks the count contract: {path}")
    return int(m.group(2))


def _sort_key(path: str) -> Tuple[int, str]:
    m = _FILENAME_RE.search(path)
    return (int(m.group(1)) if m else 0, path)


def collate(
    records: List[bytes], seq_len: int, offset: int = 1
) -> np.ndarray:
    """Raw sequence bytes -> (batch, seq_len + 1) int32: truncate,
    + offset, right-pad 0, prepend a BOS 0 column. The native engine does
    it in one pass when available; the numpy loop is its fallback."""
    native_out = _native.collate(records, seq_len, offset)
    if native_out is not None:
        return native_out
    out = np.zeros((len(records), seq_len + 1), dtype=np.int32)
    for i, rec in enumerate(records):
        arr = np.frombuffer(rec, dtype=np.uint8)[:seq_len].astype(np.int32)
        out[i, 1 : 1 + len(arr)] = arr + offset
    return out


def _prefetch(
    gen: Iterator, depth: int, stop: "threading.Event | None" = None
) -> Iterator:
    """Run ``gen`` in a daemon thread, buffering up to ``depth`` items.

    Closing (or collecting) the returned iterator sets ``stop``, which the
    worker checks before advancing the source and after a full queue
    unblocks (the consumer drains one slot after setting it), so an
    abandoned ``loop=True`` stream does not leave a thread reading shards.
    Pass the same ``stop`` into the source to interrupt long per-item
    work."""
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    _END = object()
    if stop is None:
        stop = threading.Event()

    def worker():
        try:
            while not stop.is_set():
                try:
                    item = next(gen)
                except StopIteration:
                    q.put(_END)
                    return
                q.put(item)
        except BaseException as e:  # handed to the consumer, who raises
            if not stop.is_set():
                q.put(e)
        finally:
            gen.close()

    thread = threading.Thread(
        target=worker, daemon=True, name="progen-prefetch"
    )
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        try:  # unblock a worker waiting on a full queue
            q.get_nowait()
        except queue.Empty:
            pass
        thread.join(timeout=1.0)


def iterator_from_tfrecords_folder(
    folder: str, data_type: str = "train"
) -> Tuple[int, Callable]:
    """Returns (total_num_seqs, iter_fn)."""
    reject_gcs(folder)
    filenames = [
        str(p) for p in Path(folder).glob(f"**/*.{data_type}.tfrecord.gz")
    ]
    filenames = sorted(filenames, key=_sort_key)
    file_counts = [count_from_filename(f) for f in filenames]
    num_seqs = sum(file_counts)

    def iter_fn(
        seq_len: int,
        batch_size: int,
        skip: int = 0,
        loop: bool = False,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = 2,
        shuffle_seed: int | None = None,
    ) -> Iterator[np.ndarray]:
        """Yield (batch_size / process_count, seq_len + 1) int32 batches
        of this process's shard. ``skip`` and ``batch_size`` are GLOBAL
        record counts; each process keeps the records with
        global_index % process_count == process_index.

        ``shuffle_seed``: pass e of the data is permuted by
        ``default_rng((seed, e))``, the same on every process and run, so
        index k of the shuffled stream is one record and ``skip`` stays
        exact. It decodes the whole split into host memory first."""
        if batch_size % process_count:
            raise ValueError(
                f"global batch {batch_size} not divisible by "
                f"{process_count} processes"
            )
        if shuffle_seed is not None and shuffle_seed < 0:
            raise ValueError(
                f"shuffle_seed must be a non-negative int, got {shuffle_seed}"
            )
        local_bs = batch_size // process_count
        stop = threading.Event()  # set when the returned iterator closes

        def batches() -> Iterator[np.ndarray]:
            # The record index is global across passes, so ``skip``
            # resumes into the right pass and later passes replay the
            # whole stream. loop=True is one continuous stream: the buffer
            # carries across the rewind, so every batch is full and batch
            # k holds records [k * batch, (k + 1) * batch) of the looped
            # stream; loop=False yields the ragged tail. Completed passes
            # and whole files below ``skip`` are passed over unread.
            gidx = (skip // num_seqs) * num_seqs if (loop and num_seqs) else 0
            buf: List[bytes] = []
            shuffled: List[bytes] | None = None
            if shuffle_seed is not None:
                shuffled = []
                for path in filenames:
                    if stop.is_set():  # interrupt the full-split decode
                        return
                    shuffled.extend(read_tfrecords(path))

            def pass_records(pass_index: int) -> Iterator[bytes]:
                if shuffled is None:
                    for path, cnt in zip(filenames, file_counts):
                        if stop.is_set():
                            return
                        if gidx_box[0] + cnt <= skip:
                            # whole file before the skip: no read
                            gidx_box[0] += cnt
                            continue
                        yield from read_tfrecords(path)
                    return
                order = np.random.default_rng(
                    (shuffle_seed, pass_index)
                ).permutation(len(shuffled))
                for i in order:
                    yield shuffled[i]

            gidx_box = [gidx]
            while not stop.is_set():
                for rec in pass_records(gidx_box[0] // max(num_seqs, 1)):
                    idx = gidx_box[0]
                    gidx_box[0] = idx + 1
                    if idx < skip:
                        continue
                    if idx % process_count != process_index:
                        continue
                    buf.append(rec)
                    if len(buf) == local_bs:
                        yield collate(buf, seq_len)
                        buf = []
                if not loop:
                    if buf:  # the ragged tail
                        yield collate(buf, seq_len)
                    return

        return _prefetch(batches(), prefetch, stop=stop)

    return num_seqs, iter_fn

"""Bounded ring-buffer time-series store for fleet samples.

The collector scrapes every few seconds forever; an unbounded JSONL
would eat the disk in a day. This store keeps hours of fleet history
in a fixed byte budget by trading *resolution* for *retention*, never
the reverse:

  * records append to fixed-size JSONL **block** files
    (``block-<seq>-l<level>.jsonl``); when the active block passes
    ``block_bytes`` it is sealed and a new one opened — the journal's
    write discipline (one ``write``+``flush`` per line) so a SIGKILL
    tears at most the final line;
  * when total bytes pass ``budget_bytes``, the sealed block with the
    LOWEST compaction level (ties → oldest) is **downsampled 2:1**:
    consecutive samples from the same source merge pairwise, keeping
    the later sample (cumulative counters and timing reservoirs lose
    nothing), summing the merged-sample tally ``n``, and keeping the
    *worst* ``up`` of the pair so availability degradation is never
    compacted away. The rewrite is tmp + ``os.replace`` (atomic) and
    bumps the filename's level;
  * a block that reaches ``max_level`` and is still over budget is
    deleted oldest-first — the ring wraps;
  * torn tails never poison reads: reopening an active block truncates
    a partial final line (counted), and block reads go through
    ``iter_jsonl`` so garbage lines are skipped and tallied into
    ``dropped_lines`` for the console to surface.

**Retention tiering** (optional): with a :class:`BlockShipper`
attached, every sealed block is uploaded VERBATIM to an archive
directory *before* the ring degrades it — so downsampling trades
resolution only in the hot store, never in history. The archive
carries a ``manifest.json`` of ``{block: [size, sha256]}`` entries
(the checkpoint digest-manifest pattern: a copy is only as good as its
worst byte, and verification happens at ship time, not at the restore
emergency). Each ship decision is one ``ev:"ship"`` record
(``op`` ∈ ``shipped``/``skipped``/``verify_failed``, built only in
this module — PGL006). The ring writes an ``archive.json`` pointer
beside its blocks so :class:`TsdbReader` (hence ``slo-report --tsdb``
and ``progen-tpu-torch-top``) transparently reads archive+ring as ONE
continuous store: for a block seq present in both, the lowest
compaction level wins (the archive's verbatim copy beats the ring's
downsampled survivor), and seqs the ring already dropped replay from
the archive alone.

Single-writer by design (one collector process owns a store directory);
readers (``progen-tpu-torch-top``, ``slo-report --tsdb``) only ever see whole
lines thanks to the flush-per-line contract.

The port's copy of the JAX package's ``telemetry/tsdb.py``.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

from progen_tpu_torch.telemetry.spans import EventLog
from progen_tpu_torch.telemetry.trace import LineDrops, iter_jsonl

_BLOCK_RE = re.compile(r"^block-(\d{8})-l(\d+)\.jsonl$")


def _block_name(seq: int, level: int) -> str:
    return f"block-{seq:08d}-l{level}.jsonl"


ARCHIVE_POINTER = "archive.json"
MANIFEST_NAME = "manifest.json"


def _sha256_file(path: Path) -> Tuple[int, str]:
    h = hashlib.sha256()
    size = 0
    with path.open("rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
            size += len(chunk)
    return size, h.hexdigest()


def verify_archive(dest) -> Dict[str, bool]:
    """``{block_name: digest_ok}`` for every manifest entry — what the
    CI egress smoke and restore tooling call before trusting an
    archive. Missing files and size/digest mismatches are ``False``."""
    dest = Path(dest)
    try:
        manifest = json.loads((dest / MANIFEST_NAME).read_text())
    except (OSError, ValueError):
        return {}
    out: Dict[str, bool] = {}
    for name, entry in manifest.items():
        try:
            size, digest = _sha256_file(dest / name)
            out[name] = (
                size == int(entry[0]) and digest == str(entry[1])
            )
        except (OSError, ValueError, IndexError):
            out[name] = False
    return out


class BlockShipper:
    """Verbatim block archival with a digest manifest; see module doc.
    One shipper owns one archive directory (same single-writer contract
    as the ring itself)."""

    def __init__(self, dest, log: bool = True):
        self.dest = Path(dest)
        self.dest.mkdir(parents=True, exist_ok=True)
        self.manifest_path = self.dest / MANIFEST_NAME
        try:
            self._manifest = json.loads(self.manifest_path.read_text())
        except (OSError, ValueError):
            self._manifest = {}
        self._log = EventLog(self.dest / "ship.jsonl") if log else None
        self.shipped = 0
        self.skipped = 0
        self.verify_failed = 0

    def close(self) -> None:
        if self._log is not None:
            self._log.close()

    def _best_level(self, seq: int) -> Optional[int]:
        """Lowest (best) archived compaction level for ``seq``."""
        best = None
        for name in self._manifest:
            m = _BLOCK_RE.match(name)
            if m and int(m.group(1)) == seq:
                lvl = int(m.group(2))
                best = lvl if best is None else min(best, lvl)
        return best

    def _save_manifest(self) -> None:
        tmp = self.manifest_path.with_suffix(".tmp")
        with tmp.open("w") as f:
            f.write(json.dumps(self._manifest, sort_keys=True))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.manifest_path)

    def _record(self, op: str, seq: int, level: int, name: str,
                size: int, digest: str, error: str = "") -> str:
        rec = {
            "ev": "ship",
            "ts": round(time.time(), 3),
            "op": op,
            "block": name,
            "seq": int(seq),
            "level": int(level),
            "bytes": int(size),
            "sha256": digest,
        }
        if error:
            rec["error"] = error
        if self._log is not None:
            self._log.emit(rec)
        self.shipped += op == "shipped"
        self.skipped += op == "skipped"
        self.verify_failed += op == "verify_failed"
        return op

    def ship(self, seq: int, level: int, path: Path) -> str:
        """Archive one sealed block about to be degraded; returns the
        op recorded. Never raises — a broken archive costs history
        tiering, not the collector's scrape loop."""
        name = path.name
        best = self._best_level(seq)
        if best is not None and best <= level:
            # an as-good-or-better copy is already archived (the l0
            # original shipped at first downsample; its l1 survivor
            # coming around again adds nothing)
            return self._record("skipped", seq, level, name, 0, "")
        try:
            src_size, src_digest = _sha256_file(path)
            dst = self.dest / name
            tmp = dst.with_suffix(".tmp")
            with path.open("rb") as fsrc, tmp.open("wb") as fdst:
                for chunk in iter(lambda: fsrc.read(1 << 20), b""):
                    fdst.write(chunk)
                fdst.flush()
                os.fsync(fdst.fileno())
            os.replace(tmp, dst)
            dst_size, dst_digest = _sha256_file(dst)
        except OSError as exc:
            return self._record(
                "verify_failed", seq, level, name, 0, "", error=str(exc)
            )
        if (dst_size, dst_digest) != (src_size, src_digest):
            return self._record(
                "verify_failed", seq, level, name, dst_size, dst_digest,
                error="digest mismatch after copy",
            )
        self._manifest[name] = [src_size, src_digest]
        self._save_manifest()
        return self._record(
            "shipped", seq, level, name, src_size, src_digest
        )


def merge_pair(a: dict, b: dict) -> dict:
    """Downsample two consecutive same-source records into one. ``b``
    (the later sample) wins wholesale — counters/timings are cumulative
    so dropping ``a`` loses no totals — except the fields where "keep
    the later" would hide a degradation: ``up`` keeps the pair's worst
    and ``n`` keeps the tally of raw samples this record stands for."""
    out = dict(b)
    na = int(a.get("n", 1))
    nb = int(b.get("n", 1))
    out["n"] = na + nb
    if "up" in a or "up" in b:
        out["up"] = min(int(a.get("up", 1)), int(b.get("up", 1)))
    return out


class TsdbReader:
    """Read-only view of a store directory — what ``progen-tpu-torch-top``
    and ``slo-report --tsdb`` open, so inspecting a live collector's
    store never races its writer (no truncation, no file handles kept).
    A torn final line shows up in ``drops``, exactly as a crashed
    writer's journal would.

    With an archive (explicit ``archive=`` or the ring's
    ``archive.json`` pointer) the view is the archive+ring UNION: per
    block seq the lowest compaction level wins, so replay sees the
    verbatim history for everything that was shipped before the ring
    degraded it — one continuous store across the retention seam."""

    def __init__(self, root, archive=None):
        self.root = Path(root)
        self.archive = Path(archive) if archive else self._pointer()
        self.dropped_lines = 0

    def _pointer(self) -> Optional[Path]:
        try:
            raw = json.loads((self.root / ARCHIVE_POINTER).read_text())
            return Path(raw["path"])
        except (OSError, ValueError, KeyError, TypeError):
            return None

    @staticmethod
    def _scan_dir(root: Optional[Path]) -> List[Tuple[int, int, Path]]:
        out = []
        if root is None:
            return out
        try:
            entries = list(root.iterdir())
        except OSError:
            return []
        for p in entries:
            m = _BLOCK_RE.match(p.name)
            if m:
                out.append((int(m.group(1)), int(m.group(2)), p))
        out.sort(key=lambda b: b[0])
        return out

    def _scan(self) -> List[Tuple[int, int, Path]]:
        # archive first, ring second: on equal (seq, level) the ring's
        # live copy wins the dict insert below
        by_seq: Dict[int, Tuple[int, int, Path]] = {}
        for seq, level, p in (
            self._scan_dir(self.archive) + self._scan_dir(self.root)
        ):
            cur = by_seq.get(seq)
            if cur is None or level <= cur[1]:
                by_seq[seq] = (seq, level, p)
        return sorted(by_seq.values())

    def total_bytes(self) -> int:
        return sum(p.stat().st_size for _, _, p in self._scan())

    def blocks(self) -> List[Dict[str, int]]:
        ring = {p for _, _, p in self._scan_dir(self.root)}
        return [
            {
                "seq": seq,
                "level": level,
                "bytes": p.stat().st_size,
                "archived": int(p not in ring),
            }
            for seq, level, p in self._scan()
        ]

    def read(self, drops: Optional[LineDrops] = None) -> Iterator[dict]:
        own = LineDrops()
        for _, _, path in self._scan():
            for rec in iter_jsonl(path, own):
                yield rec
        if drops is not None:
            drops.count += own.count


class RingTSDB:
    """Append-only facade over the block directory; see module doc."""

    def __init__(
        self,
        root,
        budget_bytes: int = 8 << 20,
        block_bytes: int = 256 << 10,
        max_level: int = 4,
        shipper: Optional[BlockShipper] = None,
    ):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.budget_bytes = int(budget_bytes)
        self.block_bytes = int(block_bytes)
        self.max_level = int(max_level)
        self.shipper = shipper
        self.dropped_lines = 0
        self._fh = None
        self._active_seq = 0
        self._active_bytes = 0
        self._open_active()
        if shipper is not None:
            # pointer beside the blocks: readers follow it to the
            # archive without needing a flag threaded through every CLI
            pointer = self.root / ARCHIVE_POINTER
            tmp = pointer.with_suffix(".tmp")
            tmp.write_text(
                json.dumps({"path": str(shipper.dest.resolve())})
            )
            os.replace(tmp, pointer)

    # -- block bookkeeping ------------------------------------------------

    def _scan(self) -> List[Tuple[int, int, Path]]:
        """Sorted (seq, level, path) for every block file on disk."""
        out = []
        for p in self.root.iterdir():
            m = _BLOCK_RE.match(p.name)
            if m:
                out.append((int(m.group(1)), int(m.group(2)), p))
        out.sort(key=lambda b: b[0])
        return out

    def _open_active(self) -> None:
        blocks = self._scan()
        if blocks:
            seq, level, path = blocks[-1]
            size = path.stat().st_size
            if level == 0 and size < self.block_bytes:
                self._truncate_torn_tail(path)
                self._active_seq = seq
                self._fh = path.open("a")
                self._active_bytes = path.stat().st_size
                return
            self._active_seq = seq + 1
        else:
            self._active_seq = 1
        path = self.root / _block_name(self._active_seq, 0)
        self._fh = path.open("a")
        self._active_bytes = path.stat().st_size

    def _truncate_torn_tail(self, path: Path) -> None:
        """Drop a partial final line left by a killed writer so the
        reopened block appends on a clean line boundary."""
        try:
            data = path.read_bytes()
        except OSError:
            return
        if not data or data.endswith(b"\n"):
            return
        keep = data.rfind(b"\n") + 1
        with path.open("r+b") as f:
            f.truncate(keep)
        self.dropped_lines += 1

    def _seal_active(self) -> None:
        self._fh.close()
        self._active_seq += 1
        path = self.root / _block_name(self._active_seq, 0)
        self._fh = path.open("a")
        self._active_bytes = 0

    # -- public API -------------------------------------------------------

    def append(self, rec: dict) -> None:
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        self._fh.write(line)
        self._fh.flush()
        self._active_bytes += len(line.encode("utf-8"))
        if self._active_bytes >= self.block_bytes:
            self._seal_active()
            self._enforce_budget()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self.shipper is not None:
            self.shipper.close()

    def total_bytes(self) -> int:
        return sum(p.stat().st_size for _, _, p in self._scan())

    def blocks(self) -> List[Dict[str, int]]:
        return [
            {"seq": seq, "level": level, "bytes": p.stat().st_size}
            for seq, level, p in self._scan()
        ]

    def read(self, drops: Optional[LineDrops] = None) -> Iterator[dict]:
        """Every record, oldest block first. Skipped lines are counted
        into ``drops`` (and mirrored on ``dropped_lines``)."""
        own = LineDrops()
        for _, _, path in self._scan():
            for rec in iter_jsonl(path, own):
                yield rec
        if drops is not None:
            drops.count += own.count

    # -- compaction -------------------------------------------------------

    def _enforce_budget(self) -> None:
        """Downsample (then, at max level, drop) sealed blocks until the
        directory fits the budget again. Every pass either shrinks a
        block, bumps its level, or deletes it — so this terminates."""
        while self.total_bytes() > self.budget_bytes:
            sealed = [
                b for b in self._scan() if b[0] != self._active_seq
            ]
            if not sealed:
                return
            seq, level, path = min(sealed, key=lambda b: (b[1], b[0]))
            if self.shipper is not None:
                # tier out the verbatim bytes BEFORE resolution is lost
                self.shipper.ship(seq, level, path)
            if level >= self.max_level:
                path.unlink()
                continue
            self._downsample(seq, level, path)

    def _downsample(self, seq: int, level: int, path: Path) -> None:
        drops = LineDrops()
        recs = list(iter_jsonl(path, drops))
        self.dropped_lines += drops.count
        merged: List[dict] = []
        pending: Dict[object, int] = {}
        for rec in recs:
            key = (rec.get("ev"), rec.get("source"))
            slot = pending.pop(key, None)
            if slot is None:
                pending[key] = len(merged)
                merged.append(rec)
            else:
                merged[slot] = merge_pair(merged[slot], rec)
        tmp = path.with_suffix(".tmp")
        with tmp.open("w") as f:
            for rec in merged:
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        dst = self.root / _block_name(seq, level + 1)
        os.replace(tmp, dst)
        path.unlink()

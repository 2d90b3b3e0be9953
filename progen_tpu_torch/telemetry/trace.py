"""Reading JSONL records that a crash may have torn: the part of the
JAX package's ``telemetry/trace.py`` that the serving journal uses."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, Optional


class LineDrops:
    """Tally of torn or garbage lines ``iter_jsonl`` skipped, so a reader
    can report how many records it lost."""

    __slots__ = ("count",)

    def __init__(self):
        self.count = 0


def iter_jsonl(path, drops: Optional[LineDrops] = None) -> Iterator[dict]:
    """Parsed records, one per line. A torn final line (a SIGKILL
    mid-write leaves at most one) or stray garbage is skipped and counted
    into ``drops``, not raised."""
    with Path(path).open() as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                if drops is not None:
                    drops.count += 1
                continue
            if isinstance(rec, dict):
                yield rec
            elif drops is not None:
                drops.count += 1

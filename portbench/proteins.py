"""Synthetic proteins from a seed, and the encoding of the program's
``collate`` (bytes + 1, a BOS 0 column first, right-padded with 0, whose
first pad is the EOS the loss keeps).

Lengths follow a log-normal distribution, the shape that protein sizes
take across proteomes (Tiessen et al., BMC Research Notes 5:85, 2012),
cropped to what a row holds; residues are drawn with the amino-acid
composition a mix names. A mix gives the median and the spread, and
states where they come from.

Every group of ``group`` proteins takes the ``group`` lengths at the
midpoints of equal shares of the distribution, in an order drawn from
the seed: each batch holds the same sizes whatever the seed, so seeds
change the residues and the order, not the work.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def group_lengths(p: dict, group: int) -> list:
    """The ``group`` lengths of one group, shortest first, from a mix's
    ``length_median``, ``length_sigma``, ``min_residues`` and
    ``max_residues``."""
    lo, hi = int(p["min_residues"]), int(p["max_residues"])
    if not 1 <= lo <= hi:
        raise ValueError(f"lengths {lo}..{hi}")
    z = NormalDist()
    out = []
    for i in range(group):
        n = p["length_median"] * math.exp(
            p["length_sigma"] * z.inv_cdf((i + 0.5) / group))
        out.append(min(hi, max(lo, round(n))))
    return out


class Proteins:
    """An endless stream of (id, residues) drawn from ``seed``: groups of
    ``group`` proteins of the mix's lengths, residues drawn with its
    ``residues`` and ``residue_percent``."""

    def __init__(self, seed, p: dict, group: int, prefix: str = "P"):
        self.rng = np.random.default_rng(seed)
        self.lengths = np.array(group_lengths(p, group))
        letters = np.frombuffer(p["residues"].encode("ascii"), np.uint8)
        weights = np.asarray(p["residue_percent"], dtype=np.float64)
        if len(letters) != len(weights):
            raise ValueError("one percentage for each residue")
        self.letters, self.weights = letters, weights / weights.sum()
        self.prefix, self.count = prefix, 0
        self.pending = []

    def next(self) -> tuple[str, bytes]:
        if not self.pending:
            self.pending = list(self.rng.permutation(self.lengths))
        n = int(self.pending.pop())
        seq = self.rng.choice(self.letters, n, p=self.weights).tobytes()
        rid = f"{self.prefix}{self.count:07d}"
        self.count += 1
        return rid, seq


def row_tokens(seqs: list) -> int:
    """The tokens of rows of these sequences, pad left out: each
    sequence's bytes with its BOS and its EOS."""
    return sum(len(s) + 2 for s in seqs)


def encode_rows(seqs: list, width: int) -> np.ndarray:
    """Residue strings -> (len(seqs), width) int64 rows: BOS 0, each
    byte + 1, then zeros (the first is the EOS)."""
    out = np.zeros((len(seqs), width), dtype=np.int64)
    for i, s in enumerate(seqs):
        arr = np.frombuffer(s, dtype=np.uint8)
        if len(arr) + 2 > width:
            raise ValueError(f"{len(arr)} residues do not fit {width} "
                             "positions with BOS and EOS")
        out[i, 1:1 + len(arr)] = arr.astype(np.int64) + 1
    return out

"""Byte-level protein tokenizer: token = ``ord(char) + 1``; id 0 is
BOS, padding and EOS at once. A copy of the JAX package's tokenizer, so
the port depends on nothing there."""

from __future__ import annotations

import numpy as np

PAD_ID = 0  # also BOS and EOS
OFFSET = 1


def encode_tokens(text: str) -> np.ndarray:
    """str -> int32 token ids (no BOS prepended)."""
    raw = np.frombuffer(text.encode("utf-8"), dtype=np.uint8)
    return raw.astype(np.int32) + OFFSET


def decode_tokens(tokens, offset: int = OFFSET) -> str:
    """Token ids -> str. Ids below ``offset`` (pad/BOS/EOS) decode to ''."""
    toks = np.asarray(tokens, dtype=np.int64).reshape(-1) - offset
    return "".join(chr(t) for t in toks if t >= 0)

"""The failure class of the JAX package's ``resilience/retry.py`` that
fault injection raises. The retry loop itself (classified exponential
backoff around checkpoint and data IO) is not ported yet."""

from __future__ import annotations


class TransientError(Exception):
    """Raise (or subclass) to mark a failure as retry-worthy."""

    transient = True

"""Exponential-backoff retry with transient-vs-fatal classification.

The port's copy of the JAX package's ``resilience/retry.py``, whole.
The IO this framework stands on — checkpoint writes and reads, TFRecord
shard reads — fails *transiently* at production scale (MegaScale
attributes most lost goodput to exactly this: a flaky storage call
killing a run that one retry would have saved). The policy is uniform:

  * classification first: a ``FileNotFoundError`` or a ``ValueError``
    retried 4 times is still wrong — only plausibly-transient failures
    (connection resets, timeouts, HTTP 429/500/503-shaped API errors,
    EINTR/EAGAIN-class OS errors) are retried;
  * exponential backoff with SEEDED jitter: delays are reproducible for
    a given (seed, label);
  * every retry is observable: an ``{"ev": "retry", ...}`` record goes
    to the process telemetry sink (events.jsonl when configured), the
    registry's ``retries`` counter grows, and the module's
    ``retry_counts`` makes retries assertable in tests;
  * every attempt passes through the chaos hook (``resilience/chaos.py``)
    under the call's ``label``, so injected transient faults exercise
    THIS code path, not a parallel test-only one.

Knobs ride env vars, as in the JAX package: ``PROGEN_RETRY_ATTEMPTS``,
``PROGEN_RETRY_BASE_S``, ``PROGEN_RETRY_MAX_S`` override the default
policy everywhere.
"""

from __future__ import annotations

import dataclasses
import errno
import os
import random
import re
import time
from typing import Callable, Optional

from progen_tpu_torch import telemetry
from progen_tpu_torch.telemetry.registry import get_registry


class TransientError(Exception):
    """Raise (or subclass) to mark a failure as retry-worthy."""

    transient = True


# OSError subclasses that mean "the input is wrong", not "the world
# hiccupped" — never retried. Checked before the OSError catch-all.
_FATAL_OS = (
    FileNotFoundError,
    PermissionError,
    IsADirectoryError,
    NotADirectoryError,
    FileExistsError,
)
_FATAL = (ValueError, TypeError, KeyError, AttributeError, AssertionError)

_TRANSIENT_ERRNOS = frozenset(
    getattr(errno, n)
    for n in (
        "EAGAIN", "EINTR", "EIO", "EBUSY", "ETIMEDOUT", "ECONNRESET",
        "ECONNREFUSED", "ECONNABORTED", "ENETDOWN", "ENETUNREACH",
        "EHOSTUNREACH", "EPIPE",
    )
    if hasattr(errno, n)
)

# duck-typed cloud-API failures: google.api_core / requests / urllib3
# exceptions are matched by CLASS NAME so none of those packages become
# imports of this module
_TRANSIENT_NAMES = re.compile(
    r"Unavailable|DeadlineExceeded|TooManyRequests|InternalServerError"
    r"|ServiceUnavailable|GatewayTimeout|RetryError|Aborted"
    r"|RemoteDisconnected|IncompleteRead|ChunkedEncodingError"
    r"|TemporaryFailure"
)


def is_transient(exc: BaseException) -> bool:
    """Default classifier: True only for failures a retry can plausibly
    fix. An explicit ``exc.transient`` attribute (bool) always wins."""
    marked = getattr(exc, "transient", None)
    if isinstance(marked, bool):
        return marked
    if isinstance(exc, _FATAL_OS) or isinstance(exc, _FATAL):
        return False
    if isinstance(exc, (ConnectionError, TimeoutError, InterruptedError)):
        return True
    if isinstance(exc, OSError):
        # remaining OSErrors: retry the known-flaky errnos; an unknown
        # errno (or none) on a storage path is more often weather than
        # program error, but bounded attempts keep the cost of being
        # wrong at a few hundred ms
        return exc.errno is None or exc.errno in _TRANSIENT_ERRNOS
    return bool(_TRANSIENT_NAMES.search(type(exc).__name__))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule + classifier. ``delay(attempt, rng)`` for the
    sleep before re-running attempt ``attempt+1`` (0-based)."""

    max_attempts: int = 4
    base_delay_s: float = 0.1
    max_delay_s: float = 5.0
    multiplier: float = 2.0
    jitter: float = 0.5  # +/- fraction of the nominal delay
    seed: int = 0
    classify: Callable[[BaseException], bool] = is_transient

    def delay(self, attempt: int, rng: random.Random) -> float:
        nominal = min(
            self.base_delay_s * self.multiplier**attempt, self.max_delay_s
        )
        if not self.jitter:
            return nominal
        return nominal * (1.0 + self.jitter * (2.0 * rng.random() - 1.0))


def policy_from_env(base: Optional[RetryPolicy] = None) -> RetryPolicy:
    """Default policy with env overrides applied (bad values fall back
    silently — a typo in an env var must not take down a run that never
    needed to retry anything)."""
    base = base or RetryPolicy()
    kw = {}
    for env, field, cast in (
        ("PROGEN_RETRY_ATTEMPTS", "max_attempts", int),
        ("PROGEN_RETRY_BASE_S", "base_delay_s", float),
        ("PROGEN_RETRY_MAX_S", "max_delay_s", float),
    ):
        raw = os.environ.get(env)
        if raw is None:
            continue
        try:
            kw[field] = cast(raw)
        except ValueError:
            pass
    return dataclasses.replace(base, **kw) if kw else base


# retries observed process-wide, keyed by label — cheap to assert on in
# tests and to splat into a metrics snapshot
retry_counts: dict[str, int] = {}


def retry_call(
    fn: Callable,
    *args,
    label: str = "io",
    policy: Optional[RetryPolicy] = None,
    sleep: Callable[[float], None] = time.sleep,
    **kwargs,
):
    """Run ``fn(*args, **kwargs)``; on a transient failure, back off and
    re-run, up to ``policy.max_attempts`` total attempts. Fatal failures
    and exhausted budgets re-raise the original exception. Each attempt
    first passes through the chaos hook under ``label`` so injected
    faults land inside the retry loop."""
    from progen_tpu_torch.resilience import chaos

    policy = policy if policy is not None else policy_from_env()
    rng = random.Random(f"{policy.seed}:{label}")
    for attempt in range(policy.max_attempts):
        try:
            chaos.maybe_inject(label)
            return fn(*args, **kwargs)
        except BaseException as e:
            last = attempt == policy.max_attempts - 1
            if last or not policy.classify(e):
                raise
            delay = policy.delay(attempt, rng)
            retry_counts[label] = retry_counts.get(label, 0) + 1
            get_registry().inc("retries")
            telemetry.get_telemetry().emit({
                "ev": "retry",
                "label": label,
                "attempt": attempt + 1,
                "delay_s": round(delay, 4),
                "error": f"{type(e).__name__}: {e}",
                "ts": time.time(),
            })
            sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover


def retryable(label: str = "io", policy: Optional[RetryPolicy] = None):
    """Decorator form of ``retry_call``."""

    def wrap(fn):
        def inner(*args, **kwargs):
            return retry_call(
                fn, *args, label=label, policy=policy, **kwargs
            )

        inner.__name__ = getattr(fn, "__name__", "retryable")
        inner.__doc__ = fn.__doc__
        return inner

    return wrap

"""Environment-driven fault injection keyed on span names and call sites,
the port's copy of the JAX package's ``resilience/chaos.py``.

    PROGEN_CHAOS="score/batch:kill@2,serve/decode:0.1"

Comma-separated ``target:spec`` rules. ``target`` is a span name (the
injector runs at every span's entry, through
``telemetry.spans.SPAN_ENTRY_HOOKS``) or a direct ``maybe_inject`` call
site. Specs:

  * ``0.3``      — raise a transient ``ChaosError`` with probability 0.3
                   at each hit (seeded by ``PROGEN_CHAOS_SEED``);
  * ``fail@N``   — raise on the Nth hit (1-based);
  * ``kill``     — SIGKILL the process at the first hit;
  * ``kill@N``   — SIGKILL at the Nth hit;
  * ``spike@N``  — the first N calls of ``perturb(target, x)`` return
                   1e9 instead of x;
  * ``nan@N``    — the same, returning NaN.

The port's sites (``KNOWN_TARGETS``), named as the JAX package's:

  * ``ckpt/save``, ``ckpt/restore``, ``ckpt/finalize`` — span entries of
                              a checkpoint save, a restore, and the
                              finalize of an asynchronous save;
  * ``ckpt/io/{save,meta_write,meta_read,restore}`` — each attempt of
                              the checkpoint's file work inside
                              ``retry_call`` (``resilience/retry.py``);
  * ``data/read``           — each attempt of a TFRecord file's read;
  * ``train/{ckpt,eval,sample,rollback}`` — span entries of the train
                              loop's cadence work and its anomaly
                              rollback;
  * ``train/loss``          — the perturb site (``spike@N``/``nan@N``):
                              the loss the sentinel sees;
  * ``score/batch``         — after each durable batch of the batch
                              scorer (``workloads/scoring.py``): its
                              shard lines are flushed and fsynced first,
                              so a resume re-scores nothing and drops
                              nothing;
  * ``serve/prefill``       — span entry of an admission (the engine's
                              ``prefill`` and ``begin_prefill``);
  * ``serve/prefill_chunk`` — span entry of each fed chunk of an
                              admission;
  * ``serve/decode``        — the scheduler, once a decode step, before
                              the engine advances (``kill@N`` = die after
                              N-1 full steps);
  * ``serve/embed``         — span entry of an embedding request;
  * ``serve/reload``        — span entry of a hot reload's background
                              load (``serving/reload.py``);
  * ``serve/reload_commit`` — span entry of its commit between decode
                              steps;
  * ``router/handoff``      — span entry of the router's journal fold
                              after a replica died (a transient fault
                              there is retried: the fold is idempotent);
  * ``router/connect``      — each dial of a replica (a fault opens the
                              replica's circuit breaker);
  * ``router/dispatch``     — each send of a request to a replica (a
                              fault re-queues it on the backoff
                              schedule);
  * ``transport/accept``    — each accepted TCP connection
                              (``fleet/transport.py``: dropped at once);
  * ``transport/frame``     — each decoded frame (dropped, and its
                              connection condemned).

The JAX package's ``data/glob`` guards a ``gs://`` glob, which the port
refuses (``data/dataset.py``), and its ``train/compile`` a compile the
port does not make: neither has a site here. With ``PROGEN_CHAOS``
unset every hook is a no-op. A rule whose target is no site warns once
at install instead of never firing silently. Every injection counts
into the registry's ``chaos_injections``.
"""

from __future__ import annotations

import os
import random
import signal
import sys
import time
import warnings
from dataclasses import dataclass
from typing import Dict, Optional

from progen_tpu_torch.resilience.retry import TransientError
from progen_tpu_torch.telemetry import spans
from progen_tpu_torch.telemetry.registry import get_registry

# the JAX package's data/glob (a gs:// glob, refused here) and
# train/compile (no compile per shape here) have no counterpart
KNOWN_TARGETS = frozenset({
    # spans
    "ckpt/finalize", "ckpt/restore", "ckpt/save",
    "flight/dump", "profile/window",
    "router/handoff",
    "serve/embed", "serve/prefill", "serve/prefill_chunk", "serve/reload",
    "serve/reload_commit",
    "train/ckpt", "train/eval", "train/rollback", "train/sample",
    # retry-site labels (resilience/retry.py)
    "ckpt/io/meta_read", "ckpt/io/meta_write", "ckpt/io/restore",
    "ckpt/io/save", "data/read",
    # perturb sites
    "train/loss",
    # direct maybe_inject sites
    "autoscaler/decide", "router/connect", "router/dispatch",
    "score/batch", "serve/decode", "transport/accept", "transport/frame",
})

_WARNED_UNKNOWN: set = set()


class ChaosError(TransientError):
    """Injected transient fault (classified retryable by design)."""


@dataclass
class _Rule:
    kind: str  # "prob" | "fail" | "kill" | "spike" | "nan"
    arg: float  # probability, or hit index / count
    hits: int = 0


def _parse(spec: str) -> Dict[str, _Rule]:
    rules: Dict[str, _Rule] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        target, _, s = part.rpartition(":")
        if not target:
            raise ValueError(f"chaos rule needs 'target:spec': {part!r}")
        if s == "kill":
            rules[target] = _Rule("kill", 1)
        elif s.startswith("kill@"):
            rules[target] = _Rule("kill", int(s[len("kill@"):]))
        elif s.startswith("fail@"):
            rules[target] = _Rule("fail", int(s[len("fail@"):]))
        elif s.startswith("spike@"):
            rules[target] = _Rule("spike", int(s[len("spike@"):]))
        elif s.startswith("nan@"):
            rules[target] = _Rule("nan", int(s[len("nan@"):]))
        else:
            p = float(s)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"chaos probability out of [0,1]: {part!r}")
            rules[target] = _Rule("prob", p)
    return rules


def _record_injection(name: str, rule: _Rule) -> None:
    """Every injection leaves a ``chaos`` event on the telemetry sink and
    a count in the registry, so a trace tells 'survived the fault' from
    'the fault never fired'. Broad except: the injector must work (and
    kill) even with telemetry torn down."""
    try:
        get_registry().inc("chaos_injections")
        spans.get_telemetry().emit({"ev": "chaos", "ts": time.time(),
                                    "site": name, "kind": rule.kind,
                                    "hit": rule.hits})
    except Exception:
        pass


class ChaosInjector:
    def __init__(self, spec: str, seed: int = 0):
        self.rules = _parse(spec)
        self._rng = random.Random(seed)

    def on_site(self, name: str) -> None:
        """Called at a span entry or a call site named ``name``."""
        rule = self.rules.get(name)
        if rule is None or rule.kind in ("spike", "nan"):
            return
        rule.hits += 1
        if rule.kind == "prob":
            if self._rng.random() < rule.arg:
                _record_injection(name, rule)
                raise ChaosError(f"chaos: injected fault at {name!r}")
        elif rule.kind == "fail":
            if rule.hits == rule.arg:
                _record_injection(name, rule)
                raise ChaosError(
                    f"chaos: injected fault at {name!r} (hit {rule.hits})")
        elif rule.kind == "kill" and rule.hits == rule.arg:
            # the event is written (flushed per line) before the kill, so
            # the post-mortem trace shows where the run died
            _record_injection(name, rule)
            for f in (sys.stdout, sys.stderr):
                try:
                    f.flush()
                except (OSError, ValueError):
                    pass
            os.kill(os.getpid(), signal.SIGKILL)

    def perturb(self, name: str, value: float) -> float:
        """Value-level injection (``spike@N`` / ``nan@N`` rules)."""
        rule = self.rules.get(name)
        if rule is None or rule.kind not in ("spike", "nan"):
            return value
        if rule.hits >= rule.arg:
            return value
        rule.hits += 1
        _record_injection(name, rule)
        return float("nan") if rule.kind == "nan" else 1e9


_INJECTOR: Optional[ChaosInjector] = None


def _warn_unknown_targets(rules: Dict[str, _Rule]) -> None:
    """Once per unknown target per process: a rule aimed at no site
    never fires."""
    for target in rules:
        if target in KNOWN_TARGETS or target in _WARNED_UNKNOWN:
            continue
        _WARNED_UNKNOWN.add(target)
        warnings.warn(
            f"PROGEN_CHAOS target {target!r} matches no injection site of "
            "progen_tpu_torch: this rule will never fire", stacklevel=3)


def install(spec: str, seed: int = 0) -> ChaosInjector:
    """Install an injector and hook it into every span's entry."""
    global _INJECTOR
    _INJECTOR = ChaosInjector(spec, seed)
    _warn_unknown_targets(_INJECTOR.rules)
    if maybe_inject not in spans.SPAN_ENTRY_HOOKS:
        spans.SPAN_ENTRY_HOOKS.append(maybe_inject)
    return _INJECTOR


def uninstall() -> None:
    global _INJECTOR
    _INJECTOR = None
    if maybe_inject in spans.SPAN_ENTRY_HOOKS:
        spans.SPAN_ENTRY_HOOKS.remove(maybe_inject)


def install_from_env() -> Optional[ChaosInjector]:
    """Install from ``PROGEN_CHAOS`` (uninstall when unset or empty):
    CLI entry points call it, so a child process under test takes its
    fault plan from the environment alone."""
    spec = os.environ.get("PROGEN_CHAOS", "").strip()
    if not spec:
        uninstall()
        return None
    return install(spec, seed=int(os.environ.get("PROGEN_CHAOS_SEED", "0")))


def maybe_inject(name: str) -> None:
    """The hook: a no-op unless an injector is installed."""
    if _INJECTOR is not None:
        _INJECTOR.on_site(name)


def perturb(name: str, value: float) -> float:
    if _INJECTOR is None:
        return value
    return _INJECTOR.perturb(name, value)

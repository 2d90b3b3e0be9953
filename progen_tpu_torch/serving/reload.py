"""Hot weight reload: swap checkpoints under live traffic.

The port of the JAX package's ``serving/reload.py``. The serve loop
sits at a clean barrier between any two ``decode_step`` calls, so new
weights of the same names, shapes and dtypes can be copied into the
served model there with no request dropped. The JAX engine rebinds its
parameter operands; the port copies the new values into the live
parameters in place (``ServeEngine.commit_params``), so every
parameter keeps its storage and address, which is what a later
captured decode graph needs. The expensive part is staged off the loop:

  * ``request_reload()`` — spawn a background load: restore the newest
    checkpoint through the digest-manifest walk
    (``get_checkpoint_fns(...)[1].restore_params``; a corrupt target is
    quarantined as ``ckpt_N.corrupt`` and the fallback that lands back
    on the checkpoint now served is REJECTED, not applied again), then
    ``engine.prepare_params`` (the name/shape/dtype check, the copy to
    the card on a side stream, int8 re-quantisation and calibration);
    ``request_reload(path="ckpt_N")`` pins the load to that one
    verified checkpoint instead of the newest: a pin that cannot be
    verified (digest mismatch, missing directory) or prepared (another
    model's parameters) is rejected and the current weights keep
    serving;
  * ``maybe_commit()`` — called by the serve loop between decode
    steps: applies a staged result (waiting on its staging event), or
    does nothing;
  * ``poll_watch()`` — the optional checkpoint-directory watcher behind
    ``--reload_watch``: starts a reload when a new complete checkpoint
    appears. With a ``pin_path`` (``--reload_pin``), a non-empty
    ``reload.pin`` control file overrides the newest-wins scan: the poll
    reloads exactly the pinned name and answers through an adjacent
    ``reload.pin.ack`` JSON file (``{"pin", "status", "reason"}``), the
    deploy controller's per-replica seam. Removing the pin file returns
    the replica to newest-wins watching.

Every outcome is observable: ``serve/reload`` / ``serve/reload_commit``
spans bracket the work (chaos-injectable kill points for the serve kill
matrix), ``{"ev": "reload", "status": ...}`` instants record
staged/committed/rejected in events.jsonl, and the serving metrics grow
``reloads`` / ``reload_rejected`` counters and a ``reload_duration_s``
summary.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Optional

from progen_tpu_torch.checkpoint import (
    _CKPT_NAME_RE,
    META_FILE,
    get_checkpoint_fns,
)
from progen_tpu_torch.serving.engine import ServeEngine
from progen_tpu_torch.telemetry.spans import get_telemetry, span


class WeightReloader:
    """One per serve process. ``current`` is the name of the checkpoint
    directory now serving (``ckpt_<stamp>``); reloads that resolve back
    to it — including the digest walk falling back after quarantining a
    corrupt newer one — are rejected as no-ops. ``last_duration_s`` is
    the last commit's load + commit seconds."""

    def __init__(self, engine: ServeEngine, checkpoint_path, *,
                 metrics=None, current: Optional[str] = None,
                 pin_path=None):
        self.engine = engine
        self.checkpoint_path = str(checkpoint_path)
        self._get_last = get_checkpoint_fns(self.checkpoint_path)[1]
        self.metrics = metrics
        self.current = current
        self.pin_path = Path(pin_path) if pin_path else None
        self.last_error: Optional[str] = None
        self.last_duration_s: Optional[float] = None
        self._lock = threading.Lock()
        self._staged: Optional[tuple] = None  # (name, prepared, load_s)
        self._thread: Optional[threading.Thread] = None
        self._watch_mark = 0.0
        # the pin content whose load was rejected — retried only when
        # the controller writes a DIFFERENT pin (no hot retry loop on a
        # checkpoint that will keep failing its digest walk)
        self._failed_pin: Optional[str] = None
        self._acked: Optional[tuple] = None  # (pin, status) last written
        if metrics is not None:
            # families exist (at zero) from construction so the
            # Prometheus exposition is stable before the first reload
            metrics.inc("reloads", 0)
            metrics.inc("reload_rejected", 0)
            metrics.declare_timing("reload_duration_s")

    # ----- background load ------------------------------------------------

    def request_reload(self, path: Optional[str] = None) -> bool:
        """Kick a background load — of the newest verified checkpoint,
        or (``path=``) of one SPECIFIC checkpoint name/path through the
        same digest-verify chain, with no fallback to anything else.
        False when one is already in flight (SIGHUP storms coalesce)."""
        with self._lock:
            if self.loading:
                return False
            self._thread = threading.Thread(
                target=self._load, name="weight-reload", daemon=True,
                args=(path,),
            )
            self._thread.start()
            return True

    @property
    def loading(self) -> bool:
        """A background load is running."""
        t = self._thread
        return t is not None and t.is_alive()

    def join(self, timeout: Optional[float] = None) -> None:
        """Test/shutdown seam: wait for an in-flight load to stage."""
        t = self._thread
        if t is not None:
            t.join(timeout)

    def _reject(self, reason: str, pin: Optional[str] = None) -> None:
        self.last_error = reason
        if self.metrics is not None:
            self.metrics.inc("reload_rejected")
        get_telemetry().emit({
            "ev": "reload", "ts": time.time(), "status": "rejected",
            "reason": reason,
        })
        if pin is not None:
            self._failed_pin = pin
            self._write_ack(pin, "rejected", reason)

    def _load(self, path: Optional[str] = None) -> None:
        """Runs on the background thread. Current weights keep serving
        no matter what happens here: nothing touches the served model
        until ``maybe_commit`` on the loop thread."""
        pin = Path(path).name if path is not None else None
        t0 = time.perf_counter()
        try:
            with span("serve/reload"):
                # host tensors: the copy to the card is prepare_params'
                pkg = self._get_last.restore_params(at=path, device="cpu")
                if pkg is None:
                    self._reject(
                        "pin_unavailable" if pin else "no_checkpoint",
                        pin=pin,
                    )
                    return
                name = Path(pkg.path).name if pkg.path else None
                if pin is None and name is not None \
                        and name == self.current:
                    # the verify walk landed on what we already serve
                    # (nothing newer, or the newer one was quarantined)
                    self._reject("no_new_checkpoint")
                    return
                prepared = self.engine.prepare_params(pkg.state)
        except Exception as e:  # incompat, I/O, injected chaos — reject
            self._reject(f"{type(e).__name__}: {e}", pin=pin)
            return
        with self._lock:
            self._staged = (name, prepared, time.perf_counter() - t0)
        get_telemetry().emit({
            "ev": "reload", "ts": time.time(), "status": "staged",
            "ckpt": name,
        })

    # ----- loop-thread commit ----------------------------------------------

    def maybe_commit(self) -> Optional[str]:
        """Apply a staged reload, if any. The serve loop calls this
        between decode steps, the only place a swap is atomic with
        respect to in-flight tokens. Returns the committed checkpoint
        name, or None."""
        with self._lock:
            staged, self._staged = self._staged, None
        if staged is None:
            return None
        name, prepared, load_s = staged
        t0 = time.perf_counter()
        with span("serve/reload_commit",
                  ckpt="" if name is None else str(name)):
            self.engine.commit_params(prepared)
            self.current = name
        total = load_s + (time.perf_counter() - t0)
        self.last_error = None
        self.last_duration_s = total
        if self.metrics is not None:
            self.metrics.inc("reloads")
            self.metrics.observe("reload_duration_s", total)
        get_telemetry().emit({
            "ev": "reload", "ts": time.time(), "status": "committed",
            "ckpt": name, "duration_s": round(total, 6),
        })
        if name is not None and name == self.read_pin():
            self._failed_pin = None
            self._write_ack(name, "committed")
        return name

    # ----- pin control file --------------------------------------------------

    def read_pin(self) -> Optional[str]:
        """The pinned checkpoint name, or None (no pin file / empty)."""
        if self.pin_path is None:
            return None
        try:
            content = self.pin_path.read_text().strip()
        except OSError:
            return None
        return content or None

    def _write_ack(self, pin: str, status: str, reason: str = "") -> None:
        """Atomic ``reload.pin.ack`` rewrite — the controller's read of
        a pin's outcome (its own prom scrape can lag the commit)."""
        if self.pin_path is None or self._acked == (pin, status):
            return
        rec = {"pin": pin, "status": status, "ts": time.time()}
        if reason:
            rec["reason"] = reason
        ack = self.pin_path.with_name(self.pin_path.name + ".ack")
        tmp = ack.with_name(ack.name + ".tmp")
        try:
            with tmp.open("w") as f:
                f.write(json.dumps(rec))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, ack)
        except OSError:
            return
        self._acked = (pin, status)

    def ack_current(self) -> None:
        """Confirm an already-satisfied pin (startup restored it, or the
        controller re-wrote the name we serve): ack without reloading."""
        pin = self.read_pin()
        if pin is not None and pin == self.current:
            self._failed_pin = None
            self._write_ack(pin, "committed")

    def note_startup_pin(self) -> None:
        """Answer a pin file that predates this process: committed when
        startup restored exactly the pinned checkpoint, rejected when
        ``_build`` had to fall back to another one (so the controller
        is not left waiting on an ack that will never arrive)."""
        pin = self.read_pin()
        if pin is None:
            return
        if pin == self.current:
            self._failed_pin = None
            self._write_ack(pin, "committed")
        else:
            self._failed_pin = pin
            self._write_ack(pin, "rejected", "pin_unavailable_at_startup")

    # ----- checkpoint-dir watcher -------------------------------------------

    def poll_watch(self, interval_s: float = 2.0) -> bool:
        """Throttled directory scan. A non-empty pin file overrides the
        newest-wins walk: reload exactly the pinned name (once per pin
        content — a rejected pin is not retried until it changes). With
        no pin: when a complete checkpoint newer than ``current`` exists
        and nothing is in flight or staged, kick a reload. Returns True
        when one was kicked."""
        now = time.monotonic()
        if now - self._watch_mark < interval_s:
            return False
        self._watch_mark = now
        pin = self.read_pin()
        if pin is not None:
            if pin == self.current:
                self.ack_current()
                return False
            if pin == self._failed_pin:
                return False
        else:
            newest = self._newest_complete()
            if newest is None or newest == self.current:
                return False
        with self._lock:
            busy = self._staged is not None or self.loading
        if busy:
            return False
        return self.request_reload(path=pin)

    def _newest_complete(self) -> Optional[str]:
        root = Path(self.checkpoint_path)
        try:
            names = sorted(
                p.name for p in root.iterdir()
                if _CKPT_NAME_RE.fullmatch(p.name)
                and (p / META_FILE).exists()
            )
        except OSError:
            return None
        return names[-1] if names else None

"""Loss/grad-norm spike sentinel with skip-then-rollback escalation.

The port's copy of the JAX package's ``resilience/anomaly.py``. The
staged response a production run wants (MegaScale §5):

  1. an ISOLATED anomaly (loss spike, non-finite loss/grad-norm) is
     *skipped*: the train step's finite gate already refused a poisoned
     update (training/step.py), so the loop just logs the event and
     keeps going;
  2. N CONSECUTIVE anomalies mean the stream or the state is bad in a
     way skipping won't fix: the sentinel escalates to ``rollback`` —
     the loop restores the last good checkpoint and skips ahead in the
     data stream past the offending window;
  3. the skipped window is then BISECTED (``PoisonBisector``) instead
     of discarded whole: each time the same window re-spikes after a
     resume, the skip offset grows toward the full window, converging
     on the smallest prefix-skip that clears the poison.

Statistics: an EMA of loss with an EMA of absolute deviation (a spiky
sample never enters the baseline). A sample is anomalous when
non-finite or above ``ema + factor * deviation`` after ``warmup`` clean
observations.

On a grid, decisions must be collective (one rank rolling back alone
deadlocks the next all-reduce): ``consistent_flag`` is an all-reduce
MAX over the default process group, so ANY rank's verdict binds all.
"""

from __future__ import annotations

import math
from typing import Optional

OK = "ok"
SPIKE = "spike"
ROLLBACK = "rollback"


class LossSentinel:
    def __init__(
        self,
        factor: float = 6.0,
        patience: int = 3,
        warmup: int = 10,
        beta: float = 0.95,
        min_dev: float = 0.05,
    ):
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        self.factor = float(factor)
        self.patience = int(patience)
        self.warmup = int(warmup)
        self.beta = float(beta)
        self.min_dev = float(min_dev)
        self.reset()

    def reset(self) -> None:
        """Forget everything — called after a rollback (the restored
        state's loss scale may differ from the poisoned tail's)."""
        self.mean: Optional[float] = None
        self.dev = 0.0
        self.n_clean = 0
        self.consecutive = 0
        self.n_anomalies = 0

    # ----- classification -------------------------------------------------

    def _is_anomalous(self, loss: float, grad_norm: Optional[float]) -> bool:
        if not math.isfinite(loss):
            return True
        if grad_norm is not None and not math.isfinite(grad_norm):
            return True
        if self.factor <= 0 or self.n_clean < self.warmup:
            return False
        assert self.mean is not None
        return loss > self.mean + self.factor * max(self.dev, self.min_dev)

    def observe(
        self, loss: float, grad_norm: Optional[float] = None
    ) -> str:
        """Feed one step's (loss, grad_norm); returns OK, SPIKE (skip
        and continue), or ROLLBACK (``consecutive >= patience``).
        Anomalous samples never update the baseline."""
        if self._is_anomalous(loss, grad_norm):
            self.consecutive += 1
            self.n_anomalies += 1
            return ROLLBACK if self.consecutive >= self.patience else SPIKE
        self.consecutive = 0
        if self.mean is None:
            self.mean = loss
        else:
            self.dev = (
                self.beta * self.dev + (1 - self.beta) * abs(loss - self.mean)
            )
            self.mean = self.beta * self.mean + (1 - self.beta) * loss
        self.n_clean += 1
        return OK


class PoisonBisector:
    """Find the smallest prefix of a poisoned data window to skip.

    A rollback used to discard one whole effective batch of sequences
    (``[start, start + window)``). Most of that window is usually clean
    — the poison is a few records. The bisector proposes skip offsets
    into the window: the first probe resumes halfway in; if the window
    re-spikes, the skip that proved insufficient becomes the new lower
    bound and the next probe lands halfway through what remains. Each
    probe costs one checkpoint restore, so convergence is logarithmic
    in ``window / min_step`` (``min_step`` = the data iterator's skip
    granularity, typically one per-device batch). When the interval
    collapses, ``exhausted`` is set and the final proposal is the full
    window — exactly the legacy discard-it-whole behavior, so bisection
    can only ever salvage data, never lose more.

    Protocol (cli/train.py's rollback handler):

        b = PoisonBisector(window=effective_batch, min_step=batch_size)
        skip = b.propose()            # resume at start + skip
        ... training re-spikes in the same window ...
        b.observe_respike()           # that skip was insufficient
        skip = b.propose()            # larger skip, same window
        ... training runs clean -> the tail [skip, window) was salvaged
    """

    def __init__(self, window: int, min_step: int = 1):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self.min_step = max(1, int(min_step))
        self.lo = 0  # largest skip that re-spiked (known insufficient)
        self._last: Optional[int] = None
        # a window no wider than one step can't be split
        self.exhausted = self.window <= self.min_step

    def propose(self) -> int:
        """Next skip offset to try, in ``(0, window]``; aligned to
        ``min_step`` except for the terminal full-window proposal."""
        if self.exhausted or self.window - self.lo <= self.min_step:
            self.exhausted = True
            self._last = self.window
            return self.window
        span = self.window - self.lo
        half = max(
            self.min_step, (span // 2 // self.min_step) * self.min_step
        )
        self._last = min(self.lo + half, self.window)
        return self._last

    def observe_respike(self) -> None:
        """The window spiked again after resuming at the last proposed
        skip: the poison extends past it."""
        if self._last is None:
            return
        self.lo = self._last
        if self.window - self.lo <= self.min_step:
            self.exhausted = True

    @property
    def salvaged(self) -> int:
        """Sequences of the window NOT discarded by the last proposal."""
        return self.window - (self._last or self.window)


def consistent_flag(flag: bool) -> bool:
    """Grid-consistent boolean: an all-reduce MAX of a one-element int
    tensor over the default process group (on the CPU for gloo, on the
    card for nccl), so any rank's True binds every rank. One process, or
    no process group: the identity."""
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() <= 1:
        return bool(flag)
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())

"""Experiment tracking: the port's copy of the JAX package's
``tracking.py``, a wandb-compatible interface with local backends.

  * ``WandbTracker`` when the ``wandb`` package is installed (it is
    imported only then);
  * ``JsonlTracker`` otherwise: metrics appended as JSON lines to
    ``{dir}/{project}/{run_id}/metrics.jsonl``, HTML samples as files;
  * ``NoopTracker``: ``--wandb_off``, and every process but the
    coordinator.

The coordinator is rank 0 of ``torch.distributed`` when a process group
is initialised, and the one process otherwise. Samples render as HTML
without a template engine.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from pathlib import Path
from typing import Optional

from progen_tpu_torch.parallel.groups import is_coordinator

__all__ = ["is_coordinator", "make_tracker", "render_sample_html"]


def render_sample_html(prime_str: str, sampled_str: str) -> str:
    return (
        f"<i>{prime_str}</i><br/><br/>"
        f'<div style="overflow-wrap: break-word;">{sampled_str}</div>'
    )


class NoopTracker:
    run_id: Optional[str] = None

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        pass

    def log_html(self, name: str, html: str, step: Optional[int] = None) -> None:
        pass

    def set_config(self, config: dict) -> None:
        pass

    def finish(self) -> None:
        pass


class JsonlTracker(NoopTracker):
    def __init__(self, project: str, run_id: Optional[str], dir: str):
        self.run_id = run_id or uuid.uuid4().hex[:8]
        self.path = Path(dir) / project / self.run_id
        self.path.mkdir(parents=True, exist_ok=True)
        self._metrics = (self.path / "metrics.jsonl").open("a")
        # one write + flush per line under the lock, so lines from two
        # threads never interleave
        self._lock = threading.Lock()

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        rec = {"_time": time.time(), **metrics}
        if step is not None:
            rec["_step"] = step
        with self._lock:
            if self._metrics.closed:
                raise ValueError("tracker is finished")
            self._metrics.write(json.dumps(rec) + "\n")
            self._metrics.flush()

    def log_html(self, name: str, html: str, step: Optional[int] = None) -> None:
        suffix = f"_{step}" if step is not None else ""
        (self.path / f"{name}{suffix}.html").write_text(html)

    def set_config(self, config: dict) -> None:
        (self.path / "config.json").write_text(json.dumps(config, default=str))

    def finish(self) -> None:
        with self._lock:
            self._metrics.close()


class WandbTracker(NoopTracker):
    def __init__(self, project: str, run_id: Optional[str]):
        import wandb

        self._wandb = wandb
        self._run = wandb.init(
            project=project,
            id=run_id,
            resume="allow" if run_id else None,
        )
        self.run_id = self._run.id

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        self._wandb.log(metrics, step=step)

    def log_html(self, name: str, html: str, step: Optional[int] = None) -> None:
        self._wandb.log({name: self._wandb.Html(html)}, step=step)

    def set_config(self, config: dict) -> None:
        self._run.config.update(config, allow_val_change=True)

    def finish(self) -> None:
        self._run.finish()


def make_tracker(
    project: str,
    run_id: Optional[str] = None,
    *,
    disabled: bool = False,
    dir: str = "./runs",
) -> NoopTracker:
    """Disabled, or on any process but the coordinator: a NoopTracker.
    Otherwise wandb when installed, else the JSON-lines tracker."""
    if disabled or not is_coordinator():
        return NoopTracker()
    try:
        import wandb  # noqa: F401
    except ImportError:
        return JsonlTracker(project, run_id, dir)
    return WandbTracker(project, run_id)

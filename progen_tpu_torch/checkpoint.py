"""Checkpoints of the training state, with the JAX package's factory
interface and its resume semantics, in PyTorch's own file format.

``get_checkpoint_fns(path, keep_last_n) -> (reset, get_last, save)``, as
``progen_tpu/checkpoint.py``: ``ckpt_{unix_time}`` directories, where the
lexicographic order is the save order; ``keep_last_n`` retention; the
model and run settings stored beside the arrays, so a resume rebuilds the
model from the checkpoint; a manifest of each file's size and sha256; and
a restore that walks back past a checkpoint whose bytes do not match it,
renaming that one ``ckpt_N.corrupt`` (kept as evidence, never deleted).

One checkpoint directory holds:
  * ``params.pt``: the model's state_dict (``torch.save``), so evaluation
    and sampling read the parameters alone;
  * ``opt.pt``: the optimizer's moments ``mu`` and ``nu``, its ``count``
    and the state's ``step``;
  * ``meta.json``, written last: ``next_seq_index``, ``model_config``,
    ``train_config``, ``run_id`` and the manifest ``integrity``
    (``{file: [size, sha256]}``).

A save writes all three into ``ckpt_N.tmp`` and then renames it, so a
directory named ``ckpt_N`` is complete; one without ``meta.json`` (a torn
write by other means) is skipped. Loading is ``torch.load(...,
weights_only=True, map_location=device)``, and every tensor keeps its
dtype. A ``progen_tpu`` (orbax) checkpoint is refused: the test-side
importer ``tests/torch_jax_ckpt.py`` converts one.

On a grid (``get_checkpoint_fns(..., grid=grid)``), every rank calls
``save``: the state is gathered (the ZeRO-1 moment slices over the data
group, the tensor-parallel shards or pipeline stages over the model
group, tensor by tensor into the coordinator's host memory), and the
coordinator alone writes today's unsharded format, so a checkpoint from
any grid resumes in any grid or in one process. The coordinator alone
walks, verifies and quarantines, and tells the other ranks its choice;
every rank then reads the whole checkpoint into host memory and keeps
its part. The ranks share the checkpoint's file system.

The seams of the JAX module: spans ``ckpt/save``, ``ckpt/restore`` and
``ckpt/finalize`` (a chaos rule on a span fires at its entry); the file
work under ``retry_call`` with the labels ``ckpt/io/save`` (the array
files), ``ckpt/io/meta_write``, ``ckpt/io/meta_read`` and
``ckpt/io/restore``, on the writing or reading process only, never
around a collective; and the registry's ``ckpt_quarantines`` and
``ckpt_commit_failures`` counters with their events.

Every save writes host tensors: the arrays are copied off the card
first, so a checkpoint's bytes do not depend on the device it came from.
``async_save=True`` overlaps the write with training. The optimizer
updates the state's tensors in place, so ``save`` first copies them into
host buffers (reused from one save to the next; pinned on a card), and
that copy is complete when ``save`` returns; a background thread then
runs ``torch.save``, the digests and the manifest, and the ``meta.json``
write and the rename last. ``save.check_error()``, polled every step,
raises a failed background write at the next step (never swallowed);
the in-flight save is finalized (``save.flush()``) before the next save,
before any restore and at exit (``save.close()``). On a grid the gather
stays collective and synchronous; only the coordinator's write goes to
the thread.

Not ported: ``gs://`` paths (the card's machine has no TensorStore).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from progen_tpu_torch import telemetry
from progen_tpu_torch.data.dataset import reject_gcs
from progen_tpu_torch.parallel.groups import is_coordinator
from progen_tpu_torch.resilience.retry import retry_call
from progen_tpu_torch.telemetry.registry import get_registry

CKPT_PREFIX = "ckpt_"
CORRUPT_SUFFIX = ".corrupt"
TMP_SUFFIX = ".tmp"
PARAMS_FILE, OPT_FILE, META_FILE = "params.pt", "opt.pt", "meta.json"
DEFAULT_KEEP_LAST_N = 500
_CKPT_NAME_RE = re.compile(re.escape(CKPT_PREFIX) + r"\d+")


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with path.open("rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def digest_manifest(ckpt_dir: Path, names) -> dict:
    """{name: [size, sha256hex]} for the files ``names`` in ``ckpt_dir``."""
    return {n: [(ckpt_dir / n).stat().st_size, _sha256(ckpt_dir / n)]
            for n in names}


def verify_manifest(ckpt_dir: Path, manifest: Optional[dict]) -> bool:
    """True when every file of the manifest exists with its size and
    digest. A checkpoint without a manifest fails."""
    if not manifest:
        return False
    for name, (size, digest) in manifest.items():
        p = ckpt_dir / name
        try:
            if p.stat().st_size != int(size) or _sha256(p) != digest:
                return False
        except OSError:
            return False
    return True


def checkpoint_digest(ckpt_dir) -> Optional[str]:
    """Content identity of ONE checkpoint directory: sha256 over its
    ``meta.json`` integrity manifest (the per-file digests, already paid
    at save time: no re-hashing of tensor bytes). Two saves of identical
    weights agree; any differing byte in ``params.pt`` or ``opt.pt``
    disagrees. Falls back to hashing the whole ``meta.json`` when it has
    no manifest; None when ``meta.json`` is absent or unreadable (the
    save never completed). The JAX package's ``checkpoint_digest``."""
    meta_path = Path(ckpt_dir) / META_FILE
    try:
        meta = json.loads(meta_path.read_text())
    except (OSError, ValueError):
        return None
    payload = meta.get("integrity") or meta
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode("utf-8")
    ).hexdigest()


def digest_gauge(digest: Optional[str]) -> float:
    """The first 48 bits of a hex digest as a float gauge (exact in the
    float64 mantissa): how a replica publishes its live checkpoint
    identity through its exposition, so the deploy controller and the
    router see fleet skew. -1.0 = unknown."""
    if not digest:
        return -1.0
    return float(int(digest[:12], 16))


class Package(NamedTuple):
    """What one checkpoint holds. ``state``: on save, the ``TrainState``;
    on restore, the state it was loaded into, or, without one, the dict
    ``{"params": state_dict, "optimizer": {"count", "mu", "nu"}, "step":
    int}`` (``restore_params``: the state_dict alone). ``train_config``:
    the settings that shape the optimizer and the data order (lr
    schedule, warmup, total steps, shuffle seed), which a resume takes
    from here. ``path``: the directory the restore walk selected."""

    next_seq_index: int
    state: Any
    model_config: dict
    run_id: Optional[str]
    train_config: Optional[dict] = None
    path: Optional[str] = None


def train_state_payload(state) -> Tuple[dict, dict]:
    """(params, opt) as ``save`` writes them: the model's state_dict, and
    the optimizer's count and moments with the state's step."""
    params = {k: v.detach() for k, v in state.model.state_dict().items()}
    opt = state.optimizer.state_dict()
    return params, {**opt, "step": int(state.step)}


def host_payload(payload: Tuple[dict, dict],
                 buffers: Optional[dict] = None) -> Tuple[dict, dict]:
    """(params, opt) with every tensor on the host. Without ``buffers``, a
    tensor already on the host is kept as it is (a blocking save writes
    it at once); with ``buffers`` (a dict this function fills and reuses,
    keyed by the tensor's place in the payload), every tensor is copied
    into its own host buffer, pinned for a card's tensors, and the
    copies are complete on return: a snapshot the caller may go on
    mutating the state after."""
    copies = []

    def host(key: str, t: torch.Tensor) -> torch.Tensor:
        if buffers is None:
            return t.cpu()
        buf = buffers.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype \
                or buf.stride() != t.stride():
            pin = t.device.type == "cuda"
            buf = buffers[key] = torch.empty_like(t, device="cpu",
                                                  pin_memory=pin)
        buf.copy_(t, non_blocking=t.device.type == "cuda")
        copies.append(t.device)
        return buf

    params, opt = payload
    params = {k: host(f"params/{k}", v) for k, v in params.items()}
    opt = {k: ({n: host(f"{k}/{n}", t) for n, t in v.items()}
               if isinstance(v, dict) else v) for k, v in opt.items()}
    for dev in {d for d in copies if d.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return params, opt


class _Writer:
    """The background write of one asynchronous save: ``fn()`` on a
    daemon thread; ``error`` holds what it raised."""

    def __init__(self, fn: Callable[[], Any]):
        self.error: Optional[BaseException] = None
        self._fn = fn
        self._thread = threading.Thread(target=self._run,
                                        name="ckpt-writer", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            self._fn()
        except BaseException as e:  # surfaced by check_error / join
            self.error = e

    def join(self) -> None:
        self._thread.join()


def load_train_state(state, payload: dict) -> None:
    """Copy a restored (whole) payload into ``state`` (parameters,
    moments, count, step), in place; a model on a grid keeps its part
    (``shard_tree``) and a ZeRO-1 optimizer its slices."""
    model, opt = state.model, payload["optimizer"]
    model.load_state_dict(model.shard_tree(payload["params"]))
    state.optimizer.load_state_dict({
        "count": opt["count"], "mu": model.shard_tree(opt["mu"]),
        "nu": model.shard_tree(opt["nu"])})
    state.step = int(payload["step"])


def gather_train_state(state) -> Optional[Tuple[dict, dict]]:
    """(params, opt) of a state on a grid, whole, in the coordinator's
    host memory; None on the other ranks. Every rank calls it together:
    the ZeRO-1 moments are gathered over the data group, then each tree
    over the model group, one tensor at a time."""
    keep = is_coordinator()
    params, opt = train_state_payload(state)
    model = state.model

    def whole(tree):
        return model.gather_tree(tree, device="cpu", keep=keep)

    params = whole(params)
    opt = {**opt, "mu": whole(opt["mu"]), "nu": whole(opt["nu"])}
    return (params, opt) if keep else None


def get_checkpoint_fns(
    path: str, keep_last_n: int = DEFAULT_KEEP_LAST_N, grid=None,
    async_save: bool = False,
) -> Tuple[Callable, Callable, Callable]:
    """(reset, get_last, save) over the local directory ``path``.

    save(package) -> str: the new checkpoint's directory (with
        ``async_save``, published once its background write finishes).
    save.flush(): finalize the in-flight asynchronous save (wait for its
        write; raise what it raised). save.close(): the same, at exit.
    save.check_error(): non-blocking; raise a failed background write.
    get_last(state=None, *, device="cpu") -> Optional[Package]: the newest
        checkpoint that verifies, loaded into ``state`` (a TrainState) or
        returned as a dict on ``device``.
    get_last.peek(at=None): the metadata alone (state None).
    get_last.restore_params(at=None, *, device="cpu"): the parameters
        alone. ``at`` names one checkpoint (a ``ckpt_N`` or a path ending
        in one); it never falls back to another.
    reset(): delete the directory.
    With a ``grid`` (``parallel.Grid``), every rank calls each of them
    together (see the module docstring).
    """
    reject_gcs(path)
    root = Path(path).resolve()
    ranks = grid is not None and dist.is_initialized()

    def _shared(fn):
        """``fn()`` on the coordinator, its result on every rank."""
        if not ranks:
            return fn()
        box = [None]
        if is_coordinator():
            try:
                box = [(True, fn())]
            except Exception as e:  # every rank raises it, not one alone
                box = [(False, e)]
        dist.broadcast_object_list(box, src=0)
        ok, value = box[0]
        if not ok:
            raise value
        return value

    def _list() -> list:
        # fullmatch leaves out quarantined ckpt_N.corrupt and unfinished
        # ckpt_N.tmp directories
        if not root.is_dir():
            return []
        return sorted((p for p in root.iterdir()
                       if _CKPT_NAME_RE.fullmatch(p.name)),
                      key=lambda p: p.name)

    def _complete(candidates) -> list:
        return [p for p in candidates if (p / META_FILE).exists()]

    def reset() -> None:
        def rm():
            if root.exists():
                shutil.rmtree(root)
        _finalize_pending()
        _shared(rm)

    # the asynchronous machinery: "writer" (the in-flight _Writer) and
    # "buffers" (the host snapshot's buffers, reused from save to save)
    _async: dict = {"buffers": {}}

    def _finalize_pending() -> None:
        """Wait for the in-flight background write; raise what it raised
        (its checkpoint stays unpublished: no meta.json, no rename)."""
        writer = _async.get("writer")
        if writer is None:
            return  # nothing in flight: span-free no-op
        with telemetry.span("ckpt/finalize"):
            writer.join()
            _async.pop("writer", None)
            if writer.error is not None:
                _commit_failed(writer.error)
                raise writer.error

    def _commit_failed(e: BaseException) -> None:
        get_registry().inc("ckpt_commit_failures")
        telemetry.get_telemetry().emit({
            "ev": "ckpt_commit_failed", "ts": time.time(),
            "error": f"{type(e).__name__}: {e}"})

    def _check_error() -> None:
        """Non-blocking poll of the background write, once a step: a
        failed write raises at the next step, with a
        ``ckpt_commit_failed`` event, rather than at the next save."""
        writer = _async.get("writer")
        if writer is None or writer.error is None:
            return
        _async.pop("writer", None)
        _commit_failed(writer.error)
        raise writer.error

    def save(package: Package) -> str:
        # a B with no E in events.jsonl: the process died mid-save
        with telemetry.span("ckpt/save", async_mode=async_save):
            return _save(package)

    def _save(package: Package) -> str:
        _finalize_pending()
        if ranks:
            payload = gather_train_state(package.state)  # on the host
        else:
            payload = train_state_payload(package.state)
            payload = host_payload(
                payload, _async["buffers"] if async_save else None)
        if async_save:
            return _shared(lambda: _start(package, payload))
        return _shared(lambda: _write(package, payload)) if ranks \
            else _write(package, payload)

    def _target() -> Path:
        # unix-time names made collision-proof: two saves in one second
        # get increasing names, so lexicographic order is save order
        stamp = int(time.time())
        existing = _list()
        if existing:
            stamp = max(stamp, int(existing[-1].name[len(CKPT_PREFIX):]) + 1)
        return root / f"{CKPT_PREFIX}{stamp}"

    def _start(package: Package, payload) -> str:
        """The coordinator's asynchronous write: the name is taken now, so
        names stay in save order; the files are written by the thread."""
        target = _target()
        _async["writer"] = _Writer(lambda: _write(package, payload, target))
        return str(target)

    def _write(package: Package, payload: Tuple[dict, dict],
               target: Optional[Path] = None) -> str:
        target = target or _target()
        root.mkdir(parents=True, exist_ok=True)
        for stale in root.glob(f"{CKPT_PREFIX}*{TMP_SUFFIX}"):
            shutil.rmtree(stale)  # a save that died before its rename
        tmp = target.with_name(target.name + TMP_SUFFIX)
        params, opt = payload

        def commit():
            # a failed attempt may leave a partial directory: start over
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir()
            torch.save(params, tmp / PARAMS_FILE)
            torch.save(opt, tmp / OPT_FILE)

        retry_call(commit, label="ckpt/io/save")
        meta = {
            "next_seq_index": int(package.next_seq_index),
            "model_config": package.model_config,
            "run_id": package.run_id,
            "train_config": package.train_config,
            "integrity": digest_manifest(tmp, (PARAMS_FILE, OPT_FILE)),
        }
        retry_call((tmp / META_FILE).write_text, json.dumps(meta),
                   label="ckpt/io/meta_write")
        tmp.rename(target)
        if keep_last_n:
            for p in _complete(_list())[:-keep_last_n]:
                shutil.rmtree(p)
        return str(target)

    save.flush = _finalize_pending
    save.close = _finalize_pending  # at exit; safe to call again
    save.check_error = _check_error
    save._async = _async  # test seam: a writer may be injected

    def _quarantine(p: Path, reason: str) -> None:
        """Rename a bad checkpoint ``<name>.corrupt``: out of the rotation,
        kept on disk. A failed rename means the next walk reaches the same
        verdict."""
        print(f"[checkpoint] quarantining {p.name}: {reason}", flush=True)
        get_registry().inc("ckpt_quarantines")
        telemetry.get_telemetry().emit({"ev": "ckpt_quarantine",
                                        "ts": time.time(), "ckpt": p.name,
                                        "reason": reason})
        try:
            p.rename(p.with_name(p.name + CORRUPT_SUFFIX))
        except OSError:
            pass

    # checkpoints verified by this instance: peek and a following restore
    # hash the same bytes once
    verified: set = set()

    def _verify_candidate(cand: Path) -> Optional[tuple]:
        """(dir, meta) when ``cand`` verifies; None after quarantining it.
        Raises for an orbax checkpoint of the JAX package."""
        if (cand / "state").is_dir() and not (cand / PARAMS_FILE).exists():
            raise ValueError(
                f"{cand} is a progen_tpu (orbax) checkpoint; convert it with "
                "the importer in tests/torch_jax_ckpt.py "
                "(import_jax_checkpoint) before progen_tpu_torch reads it"
            )
        try:
            meta = json.loads(retry_call((cand / META_FILE).read_text,
                                         label="ckpt/io/meta_read"))
        except (OSError, ValueError):
            _quarantine(cand, f"unreadable {META_FILE}")
            return None
        if cand.name not in verified:
            if not verify_manifest(cand, meta.get("integrity")):
                _quarantine(cand, "integrity manifest mismatch")
                return None
            verified.add(cand.name)
        return cand, meta

    def _select(at=None) -> Optional[tuple]:
        _finalize_pending()  # the walk must see the newest checkpoint
        return _shared(lambda: _select_here(at))

    def _select_here(at=None) -> Optional[tuple]:
        if at is None:  # the newest that verifies, walking back
            for cand in reversed(_complete(_list())):
                sel = _verify_candidate(cand)
                if sel is not None:
                    return sel
            return None
        name = os.path.basename(str(at).rstrip("/"))
        for cand in _complete(_list()):
            if cand.name == name:
                return _verify_candidate(cand)
        return None

    def _package(sel, state) -> Package:
        ckpt, meta = sel
        return Package(next_seq_index=meta["next_seq_index"], state=state,
                       model_config=meta["model_config"],
                       run_id=meta["run_id"],
                       train_config=meta.get("train_config"), path=str(ckpt))

    def _load(p: Path, device):
        return retry_call(torch.load, p, weights_only=True,
                          map_location=device, label="ckpt/io/restore")

    def get_last(state=None, *, device="cpu") -> Optional[Package]:
        with telemetry.span("ckpt/restore"):
            return _get_last(state, device)

    def _get_last(state, device) -> Optional[Package]:
        sel = _select()
        if sel is None:
            return None
        ckpt = sel[0]
        if state is not None and not ranks:
            device = state.model.device
        opt = _load(ckpt / OPT_FILE, device)
        payload = {"params": _load(ckpt / PARAMS_FILE, device),
                   "optimizer": {k: opt[k] for k in ("count", "mu", "nu")},
                   "step": opt["step"]}
        if state is not None:
            load_train_state(state, payload)
            payload = state
        return _package(sel, payload)

    def peek(at=None) -> Optional[Package]:
        """The metadata only: decide the model config and the resume point
        before building the model. Runs the same verifying walk."""
        sel = _select(at)
        return None if sel is None else _package(sel, None)

    def restore_params(at=None, *, device="cpu") -> Optional[Package]:
        """The parameters alone (no moments), for evaluation and sampling."""
        sel = _select(at)
        if sel is None:
            return None
        return _package(sel, _load(sel[0] / PARAMS_FILE, device))

    get_last.peek = peek
    get_last.restore_params = restore_params
    return reset, get_last, save

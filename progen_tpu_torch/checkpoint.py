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

Not ported: asynchronous saves, ``gs://`` paths, and the telemetry, retry
and fault-injection seams of the JAX module. One process writes.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
from pathlib import Path
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from progen_tpu_torch.data.dataset import reject_gcs
from progen_tpu_torch.parallel.groups import is_coordinator

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
    path: str, keep_last_n: int = DEFAULT_KEEP_LAST_N, grid=None
) -> Tuple[Callable, Callable, Callable]:
    """(reset, get_last, save) over the local directory ``path``.

    save(package) -> str: the new checkpoint's directory.
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
        _shared(rm)

    def save(package: Package) -> str:
        if ranks:
            payload = gather_train_state(package.state)
            return _shared(lambda: _write(package, payload))
        return _write(package, train_state_payload(package.state))

    def _write(package: Package, payload: Tuple[dict, dict]) -> str:
        # unix-time names made collision-proof: two saves in one second
        # get increasing names, so lexicographic order is save order
        stamp = int(time.time())
        existing = _list()
        if existing:
            stamp = max(stamp, int(existing[-1].name[len(CKPT_PREFIX):]) + 1)
        target = root / f"{CKPT_PREFIX}{stamp}"
        root.mkdir(parents=True, exist_ok=True)
        for stale in root.glob(f"{CKPT_PREFIX}*{TMP_SUFFIX}"):
            shutil.rmtree(stale)  # a save that died before its rename
        tmp = target.with_name(target.name + TMP_SUFFIX)
        tmp.mkdir()
        params, opt = payload
        torch.save(params, tmp / PARAMS_FILE)
        torch.save(opt, tmp / OPT_FILE)
        meta = {
            "next_seq_index": int(package.next_seq_index),
            "model_config": package.model_config,
            "run_id": package.run_id,
            "train_config": package.train_config,
            "integrity": digest_manifest(tmp, (PARAMS_FILE, OPT_FILE)),
        }
        (tmp / META_FILE).write_text(json.dumps(meta))
        tmp.rename(target)
        if keep_last_n:
            for p in _complete(_list())[:-keep_last_n]:
                shutil.rmtree(p)
        return str(target)

    def _quarantine(p: Path, reason: str) -> None:
        """Rename a bad checkpoint ``<name>.corrupt``: out of the rotation,
        kept on disk. A failed rename means the next walk reaches the same
        verdict."""
        print(f"[checkpoint] quarantining {p.name}: {reason}", flush=True)
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
            meta = json.loads((cand / META_FILE).read_text())
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
        return torch.load(p, weights_only=True, map_location=device)

    def get_last(state=None, *, device="cpu") -> Optional[Package]:
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

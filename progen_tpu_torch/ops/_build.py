"""Build and bind the port's CUDA kernels.

Each ``progen_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into its
own shared library with a plain C interface and loaded with ``ctypes``:
no PyTorch headers, so a build takes seconds. The libraries go into
``build/kernels/`` beside the package (listed in ``.gitignore``), named
by a hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads. ``build_all()`` starts one ``nvcc`` per source, all
at once. A missing ``nvcc``, a failed build or a failed launch raises.

Every C entry point takes its pointers and the stream as ``void*`` and
returns ``cudaGetLastError()``; ``launch`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-lineinfo",
)

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of each kernel's entry point, which ``csrc/<name>.cu``
# exports under the kernel's name
SIGNATURES = {
    # q, k, v, halo_k, halo_v (NULL: none), out, bh, n, window, dim_head,
    # scale, dtype, stream
    "local_attention_fwd": (P, P, P, P, P, P, I, I, I, I, F, I, P),
    # q, k, v, halo_k, halo_v, dout, dq, dk, dv, stats, bh, n, window,
    # dim_head, scale, dtype, stream
    "local_attention_bwd_kv": (P, P, P, P, P, P, P, P, P, P, I, I, I, I, F,
                               I, P),
    # q, k, v, halo_k, halo_v, dout, dq, dk2, dv2, stats, bh, n, window,
    # dim_head, scale, dtype, stream
    "local_attention_bwd_halo": (P, P, P, P, P, P, P, P, P, P, I, I, I, I, F,
                                 I, P),
    # x, prev (NULL: none), scale, out, rows, n, d, eps, dtype, stream
    "norm_shift": (P, P, P, P, I, I, I, F, I, P),
    # x, gate, weights, biases, scale, out, scratch, batch, n, ldw (the
    # weights' row stride), row0, rows, d, eps, dtype, stream
    "sgu_mix_gate": (P, P, P, P, P, P, P, I, I, I, I, I, I, F, I, P),
}
KERNELS = tuple(sorted(SIGNATURES))
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from "
            f"{CSRC} with the CUDA toolkit"
        )
    return path


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one kernel; None when its library is already built."""
    out = _library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    tmp.replace(out)


def build_all() -> dict[str, Path]:
    """Build every kernel library that is not built yet, one nvcc per
    source, all started together. Returns name -> library path."""
    started = {name: _start_build(name) for name in KERNELS}
    errors = []
    for name, job in started.items():
        if job is None:
            continue
        try:
            _finish_build(name, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: _library_path(name) for name in KERNELS}


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers, shared memory, spills) for the
    library of ``name`` that matches the current sources, or '' when that
    library has not been built."""
    path = _library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        job = _start_build(name)
        if job is not None:
            _finish_build(name, job)
        lib = ctypes.CDLL(str(_library_path(name)))
        fn = getattr(lib, name)
        fn.argtypes = list(SIGNATURES[name])
        fn.restype = ctypes.c_int
        _libs[name] = lib
        return lib


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"kernel takes float32, bfloat16 or float16, "
                        f"got {t.dtype}") from None


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address: the kernels copy 16
    bytes at a time (a view at an odd offset is copied)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel ``name``'s C entry point on ``device``'s current stream;
    raise on a launch error."""
    lib = load(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")

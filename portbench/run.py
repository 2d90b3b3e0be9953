#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell
asks for. With ``--trace 0`` the result's metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics and a
breakdown of the traced window. Every number compared for ``correct`` is
printed beside its limit as the last lines on standard error and under
``checks``, the last key of the result line, which is the last line of
standard output. Without the cards, without the program in the
checkout, or with JAX loaded once the window has closed, it prints no
result and exits with a code other than 0.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
# the kernels' build and compile caches of the program, inside the
# checkout at fixed paths, so that only a checkout's first run builds
CACHES = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TRITON_CACHE_DIR": "build/triton"}


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(message: str, code: int) -> int:
    print(f"portbench: {message}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    args = _args(argv)
    for key, rel in CACHES.items():
        os.environ[key] = str(CHECKOUT / rel)
    os.environ["USE_FLAX"] = "0"
    # import from the checkout's root, never from this folder, whose
    # module names are the harness's own
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(CHECKOUT)] + [
        p for p in sys.path if str(Path(p or ".").resolve()) != here]
    from portbench import harness

    started = harness.process_start()
    try:
        bench = harness.Bench(CHECKOUT)
        cell = bench.cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        return fail(f"cannot read the cell {args.workload!r}: {e}", 2)
    import importlib.util

    found = importlib.util.find_spec(harness.PROGRAM)
    if found is None or not found.origin or \
            CHECKOUT not in Path(found.origin).resolve().parents:
        return fail(f"the program {harness.PROGRAM} is not in this "
                    "checkout", 4)
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark runs on the card only", 3)
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{cell.name} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} found", 3)
    return harness.run_and_report(bench, cell, args.seed, args.seconds,
                                  bool(args.trace),
                                  torch.device("cuda", 0), started)


if __name__ == "__main__":
    sys.exit(main())

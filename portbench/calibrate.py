#!/usr/bin/env python3
"""Read the numbers that ``correct`` compares, for setting a cell's
limits: the program's on a dozen seeds or more, the control's (the
reference in 8-bit products in the program's place) and each planted
fault's on three or more, all at the cell's own size, in one process.

    python3 portbench/calibrate.py --workload <cell> [--out FILE]

Prints one JSON line per reading and, last, the largest program reading
and the smallest control and fault readings of each number. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
SEED_BASE = 3_000_000_019  # above 2**31, as the benchmark's seeds may be
PROGRAM_SEEDS, CONTROL_SEEDS, FAULT_SEEDS = 12, 3, 3
SECONDS = 2.0  # each program reading's window: the numbers are set-up's


def seeds(cell: str, kind: str, count: int) -> list:
    """Seeds no run of the benchmark's own proof uses: drawn from the
    cell's name and the reading's kind."""
    import zlib

    start = SEED_BASE + zlib.crc32(f"{cell}/{kind}".encode()) % 10**6
    return [start + 7919 * i for i in range(count)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(CHECKOUT)] + [
        q for q in sys.path if str(Path(q or ".").resolve()) != here]
    import torch

    from portbench import faults, harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    bench = harness.Bench(CHECKOUT)
    cell = bench.cell(args.workload)
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    readings = {"program": [], "control": {}, "fault": {}}

    def emit(kind, seed, numbers, extra=None):
        rec = {"cell": cell.name, "kind": kind, "seed": seed,
               "numbers": numbers, **(extra or {})}
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    plan = [("program", None, s) for s in seeds(cell.name, "program",
                                                 PROGRAM_SEEDS)]
    plan += [("control", None, s) for s in seeds(cell.name, "control",
                                                 CONTROL_SEEDS)]
    for name in faults.BY_KIND[cell.kind]:
        plan += [("fault", name, s) for s in seeds(cell.name, name,
                                                    FAULT_SEEDS)]
    for kind, fault, seed in plan:
        t = time.perf_counter()
        variant = "control" if kind == "control" else "program"
        guard = (faults.BY_KIND[cell.kind][fault]() if fault
                 else contextlib.nullcontext())
        with guard:
            _, outcome, _, _ = harness.execute(bench, cell, seed,
                                               SECONDS, False, device,
                                               variant=variant)
        numbers = {k: v for k, v in outcome.numbers.items()}
        emit(fault or kind, seed, numbers,
             {"s": round(time.perf_counter() - t, 2),
              "info": outcome.info})
        if kind == "program":
            readings["program"].append(numbers)
        else:
            readings[kind].setdefault(fault or "control", []).append(numbers)
        del outcome
        harness.release()
    summary = {"cell": cell.name, "lower": {}, "upper": {}}
    for name in (readings["program"][0] if readings["program"] else []):
        summary["lower"][name] = max(r[name] for r in readings["program"])
    for group in (readings["control"], readings["fault"]):
        for label, rows in group.items():
            summary["upper"][label] = {n: min(r[n] for r in rows)
                                       for n in rows[0]}
    print(json.dumps({"summary": summary}), flush=True)
    if out:
        out.write(json.dumps({"summary": summary}) + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

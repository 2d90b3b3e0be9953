#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s fleet phases alone on one card, after
building the kernels (phase 1), at configs/model/base.toml:

    python3 tools/chip_phase.py deploy [observability] [fleet]

``fleet`` is phase 13 (at FLEET_DEPTH), ``observability`` phase 14 and
``deploy`` phase 15, each with the same checks and printed line as in the
whole script. It prints the card's name and power limit first, and exits
non-zero when a phase fails or there is no CUDA device. A quicker way to
measure one of these phases than the whole script; the whole script stays
the proof that every path still runs.
"""

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
PHASES = ("fleet", "observability", "deploy")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("phases", nargs="+", choices=PHASES)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from progen_tpu_torch import ProGenConfig, load_toml_config

    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cs.phase_build()
    cfg = ProGenConfig.from_dict(load_toml_config(
        str(REPO / "configs" / "model" / "base.toml")))
    run = {"fleet": lambda: cs.phase_fleet(
               dataclasses.replace(cfg, depth=cs.FLEET_DEPTH), card),
           "observability": lambda: cs.phase_observability(cfg, card),
           "deploy": lambda: cs.phase_deploy(cfg, card)}
    for name in args.phases:
        run[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())

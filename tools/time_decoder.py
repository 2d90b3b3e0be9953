"""Time the port's KV-cache decoder on one card, at chip_smoke.py's
generate-base-b4 path: base.toml in bfloat16 with random weights from
seed 0, four primes of 4 residues, length 256, top_k 25, BOS, through
``sampling.sample_fast_batched``. The decoder runs no custom kernel, so
nothing is built.

The ``progen_tpu_torch`` it times is the first one on the import path,
so two trees can be compared in one machine session, each in its own
process, alternating:

    PYTHONPATH=build/parent python3 tools/time_decoder.py
    PYTHONPATH=. python3 tools/time_decoder.py

Prints one JSON line: the package's path, the card (``nvidia-smi``'s
name and power limit), each timed run's decode steps/s (host clock
around the call, ending in a synchronize; one untimed run first) and a
digest of the tokens, so the two trees' streams can be compared.
"""

import argparse
import hashlib
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

PRIMES = ["MKTA", "MSKG", "MALW", "MVLS"]
LENGTH, TOP_K = 256, 25


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_decoder: no CUDA device")
        return 2
    import progen_tpu_torch
    from progen_tpu_torch import ProGen, ProGenConfig, load_toml_config
    from progen_tpu_torch.data.tokenizer import encode_tokens
    from progen_tpu_torch.sampling import sample_fast_batched

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    root = Path(__file__).resolve().parent.parent
    cfg = ProGenConfig.from_dict(load_toml_config(
        str(root / "configs" / "model" / "base.toml")))
    model = ProGen(cfg, device="cuda", seed=0).eval()
    primes = np.stack([encode_tokens(s) for s in PRIMES])

    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        seqs = sample_fast_batched(0, model, primes, LENGTH, top_k=TOP_K,
                                   add_bos=True, device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t, seqs

    run()
    steps = LENGTH - 1  # decode steps per request, the prime's included
    rates, digest = [], None
    for _ in range(args.runs):
        s, seqs = run()
        rates.append(steps / s)
        digest = hashlib.sha256(seqs.cpu().numpy().tobytes()).hexdigest()
    print(json.dumps(dict(package=str(Path(progen_tpu_torch.__file__).parent),
                          card=card, steps_per_s=rates,
                          tokens_digest=digest[:16])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Checkpoint migration CLI: a reference ``ckpt_*.pkl`` -> a checkpoint of
the port's format, the JAX package's ``cli/convert.py``.

The written checkpoint resumes in ``cli.train`` (the model config and
the progress carry over; the Adam moments start at zero, see
``convert.py``) and loads in ``cli.sample``, ``cli.batch_score``,
``cli.scan`` and ``cli.serve``.

Run: python -m progen_tpu_torch.cli.convert --src ./old/ckpt_1690000000.pkl \\
         --dest ./ckpts
"""

from __future__ import annotations

import argparse

from progen_tpu_torch._device import resolve_device
from progen_tpu_torch.convert import convert_checkpoint


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="progen_tpu_torch.cli.convert", allow_abbrev=False,
        description="Convert a reference checkpoint into the port's format.")
    p.add_argument("--src", required=True,
                   help="reference ckpt_*.pkl (a pickled package)")
    p.add_argument("--dest", default="./ckpts",
                   help="checkpoint directory to write into")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def run(argv=None) -> str:
    """Convert; returns the written checkpoint's directory."""
    args = parse_args(argv)
    written = convert_checkpoint(args.src, args.dest,
                                 device=resolve_device(args.device))
    print(f"converted {args.src} -> {written}")
    return written


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

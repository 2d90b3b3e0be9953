"""Data-generation CLI: FASTA -> TFRecord shards.

The JAX package's ``cli/generate_data.py`` with its flags and TOML schema
(``configs/data/default.toml``); the ETL is ``data/fasta.py``.

Run: python -m progen_tpu_torch.cli.generate_data --data_dir ./configs/data
"""

from __future__ import annotations

import argparse
from pathlib import Path

from progen_tpu_torch.config import load_toml_config
from progen_tpu_torch.data.fasta import generate_data


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="progen_tpu_torch.cli.generate_data",
        description="Write train/valid TFRecord shards from a FASTA.")
    p.add_argument("--data_dir", default="./configs/data")
    p.add_argument("--name", default="default")
    p.add_argument("--seed", default=None, type=int,
                   help="seed of the ETL's choices (default: unseeded)")
    return p.parse_args(argv)


def run(argv=None) -> list:
    """Run the ETL; returns the written shard paths."""
    args = parse_args(argv)
    config_path = Path(args.data_dir) / f"{args.name}.toml"
    if not config_path.exists():
        raise SystemExit(f"config does not exist at {config_path}")
    written = generate_data(load_toml_config(str(config_path)),
                            seed=args.seed)
    print(f"wrote {len(written)} tfrecord shard(s):")
    for path in written:
        print(f"  {path}")
    return written


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

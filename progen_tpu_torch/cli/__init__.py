"""The port's command-line entry points: ``python -m
progen_tpu_torch.cli.<name>`` for generate_data, train, eval, sample,
serve, router, batch_score, scan, convert, telemetry, collector and top.
Each module's ``run(argv)`` (or ``main(argv)``) does the work and returns
what it did; ``main(argv)`` is the console entry point around it. The
helpers below are the argparse counterparts of the click path types and
``click.echo`` the JAX package's CLIs use."""

import argparse
import sys
from pathlib import Path


def echo(msg: str = "", err: bool = False) -> None:
    print(msg, file=sys.stderr if err else sys.stdout, flush=True)


def existing_file(path: str) -> str:
    """An argparse type: a file that exists (click's ``exists=True,
    dir_okay=False``)."""
    if not Path(path).is_file():
        raise argparse.ArgumentTypeError(f"file {path!r} does not exist")
    return path


def existing_dir(path: str) -> str:
    """An argparse type: a directory that exists (click's
    ``exists=True, file_okay=False``)."""
    if not Path(path).is_dir():
        raise argparse.ArgumentTypeError(
            f"directory {path!r} does not exist")
    return path

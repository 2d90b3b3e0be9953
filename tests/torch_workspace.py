"""A tiny training workspace for the port's CLI tests: the model TOML of
``tests/test_cli.py`` (dim 32, depth 2, window 8, seq_len 32), a
40-record FASTA with Uniref50-style headers made from a seed, and its
TFRecord shards written by the port's ETL (48 train and 12 valid
records). Imports torch's side only."""

from __future__ import annotations

import random
from pathlib import Path

TOML = """num_tokens = 256
dim = 32
depth = 2
heads = 2
dim_head = 16
window_size = 8
seq_len = 32
global_mlp_depth = 1
ff_mult = 2
dtype = "float32"
"""

DATA_TOML = """read_from = "{fasta}"
write_to = "{out}"
num_samples = 30
max_seq_len = 28
prob_invert_seq_annotation = 0.5
fraction_valid_data = 0.2
num_sequences_per_file = 50
sort_annotations = true
"""


def make_workspace(root: Path, toml: str = TOML) -> Path:
    """Write the configs and the FASTA under ``root`` and run the port's
    generate_data CLI; returns ``root``."""
    from progen_tpu_torch.cli import generate_data

    (root / "configs" / "model").mkdir(parents=True)
    (root / "configs" / "data").mkdir(parents=True)
    (root / "configs" / "model" / "default.toml").write_text(toml)
    rng = random.Random(0)
    aas = "ACDEFGHIKLMNPQRSTVWY"
    fasta = root / "toy.fasta"
    with fasta.open("w") as f:
        for i in range(40):
            tax = rng.choice(["Homo sapiens", "Acinetobacter"])
            seq = "".join(rng.choice(aas) for _ in range(rng.randint(8, 24)))
            f.write(f">U{i:03d} toy n=1 Tax={tax} TaxID=1 RepID=T\n{seq}\n")
    (root / "configs" / "data" / "default.toml").write_text(
        DATA_TOML.format(fasta=fasta, out=root / "train_data"))
    generate_data.run(["--data_dir", str(root / "configs" / "data"),
                       "--seed", "0"])
    return root


def train_args(root: Path, ckpt: str = "ckpts", *extra: str) -> list:
    """Port train CLI arguments for the workspace, on the CPU, no
    tracker, cadences off after step 0."""
    return ["--device", "cpu", "--wandb_off", "--seq_len", "32",
            "--batch_size", "4", "--grad_accum_every", "2",
            "--validate_every", "100", "--sample_every", "100",
            "--checkpoint_every", "100",
            "--config_path", str(root / "configs" / "model"),
            "--data_path", str(root / "train_data"),
            "--checkpoint_path", str(root / ckpt), *extra]

"""FASTA -> TFRecord ETL, the port's copy of the JAX package's
``data/fasta.py``: the same strings, permutation and shards from the same
FASTA and seed.

Read a (Uniref50-style) FASTA, drop sequences longer than
``max_seq_len``, cap the count at ``num_samples``, turn each record into
training strings with the taxonomy annotation grammar, then permute and
split them into train/valid TFRecord shards named
``{i}.{count}.{split}.tfrecord.gz``:
  * taxonomy from the description with ``Tax=([a-zA-Z\\s]*)\\s[a-zA-Z\\=]``
    (the match stops one token before the next ``Key=`` field);
  * the annotated string ``"[tax=X] # SEQ"``, annotation and sequence
    swapped with probability ``prob_invert_seq_annotation``;
  * an unannotated ``"# SEQ"`` is always emitted too.

Local paths only: ``gs://`` raises.
"""

from __future__ import annotations

import gzip
import random as _random
import re
from math import ceil
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from progen_tpu_torch.data.dataset import reject_gcs
from progen_tpu_torch.data.tfrecord import tfrecord_writer

_TAX_RE = re.compile(r"Tax=([a-zA-Z\s]*)\s[a-zA-Z\=]")


def parse_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """Stream (description, sequence) pairs, sequences uppercased."""
    opener = gzip.open if str(path).endswith(".gz") else open
    desc: Optional[str] = None
    chunks: List[str] = []
    with opener(path, "rt") as fp:
        for line in fp:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if desc is not None:
                    yield desc, "".join(chunks).upper()
                desc = line[1:]
                chunks = []
            else:
                chunks.append(line)
        if desc is not None:
            yield desc, "".join(chunks).upper()


def annotations_from_description(description: str) -> Dict[str, str]:
    """{'tax': <taxonomy>} when present."""
    m = _TAX_RE.findall(description)
    return {"tax": m[0]} if m else {}


def sequence_strings(
    description: str,
    seq: str,
    *,
    prob_invert_seq_annotation: float,
    sort_annotations: bool,
    rng: _random.Random,
) -> List[bytes]:
    """The training strings for one FASTA record."""
    out: List[bytes] = []
    annotations = annotations_from_description(description)
    if annotations:
        keys = list(annotations.keys())
        if sort_annotations:
            keys = sorted(keys)
        else:
            rng.shuffle(keys)
        annot_str = " ".join(f"[{k}={annotations[k]}]" for k in keys)
        pair = (annot_str, seq)
        if rng.random() <= prob_invert_seq_annotation:
            pair = tuple(reversed(pair))
        out.append(" # ".join(pair).encode("utf-8"))
    out.append(f"# {seq}".encode("utf-8"))
    return out


def write_tfrecord_shards(
    sequences: List[bytes],
    write_to: str,
    *,
    fraction_valid_data: float,
    num_sequences_per_file: int,
    seed: Optional[int] = None,
) -> List[str]:
    """Permute, split train/valid, shard into
    ``{file_index}.{count}.{split}.tfrecord.gz``. Returns the written
    paths."""
    reject_gcs(write_to)
    n = len(sequences)
    num_valid = ceil(fraction_valid_data * n)
    perm = np.random.RandomState(seed).permutation(n)
    valid_idx, train_idx = np.split(perm, [num_valid])
    local_dir = Path(write_to)
    local_dir.mkdir(parents=True, exist_ok=True)

    written: List[str] = []
    for split, idx in (("train", train_idx), ("valid", valid_idx)):
        if len(idx) == 0:
            continue
        num_files = ceil(len(idx) / num_sequences_per_file)
        for file_index, shard in enumerate(np.array_split(idx, num_files)):
            path = local_dir / f"{file_index}.{len(shard)}.{split}.tfrecord.gz"
            with tfrecord_writer(str(path)) as write:
                for i in shard:
                    write(sequences[int(i)])
            written.append(str(path))
    return written


def generate_data(config: dict, *, seed: Optional[int] = None) -> List[str]:
    """The whole ETL, with the reference's TOML schema: read_from,
    write_to, num_samples, max_seq_len, prob_invert_seq_annotation,
    fraction_valid_data, num_sequences_per_file, sort_annotations."""
    rng = _random.Random(seed)
    sequences: List[bytes] = []
    kept = 0
    for desc, seq in parse_fasta(config["read_from"]):
        if len(seq) > config["max_seq_len"]:
            continue
        sequences.extend(
            sequence_strings(
                desc,
                seq,
                prob_invert_seq_annotation=config["prob_invert_seq_annotation"],
                sort_annotations=config["sort_annotations"],
                rng=rng,
            )
        )
        kept += 1
        if kept >= config["num_samples"]:
            break
    return write_tfrecord_shards(
        sequences,
        config["write_to"],
        fraction_valid_data=config["fraction_valid_data"],
        num_sequences_per_file=config["num_sequences_per_file"],
        seed=seed,
    )

"""Protein-design workloads, the port of the JAX package's ``workloads/``:

  * ``scoring`` — bulk perplexity scoring (``cli.batch_score``):
    FASTA/TFRecord candidates -> sharded JSONL of per-sequence NLL and
    perplexity with per-token logprobs, length-bucketed and resumable
    (SIGKILL-safe);
  * ``mutagenesis`` — deep mutational scans (``cli.scan``): every point
    mutant of a sequence, scored in batches built on the device;
  * ``infill`` — fixed-position infilling templates -> the sampler's
    (template, frozen) constraint pair, used by ``sample_fast``,
    ``cli.sample --template`` and the serve protocol;
  * ``embeddings`` — final-norm mean-pooled representations, also a
    serving-engine request type.

Nothing here imports ``progen_tpu_torch.serving``: the engine imports
``embeddings``, so the dependency runs one way.
"""

from progen_tpu_torch.workloads.embeddings import bucket_length, embed_step
from progen_tpu_torch.workloads.infill import (
    infill_request_arrays,
    parse_template,
)
from progen_tpu_torch.workloads.mutagenesis import (
    AA_ALPHABET,
    mutagenesis_scan,
    reference_point_mutant_nll,
)
from progen_tpu_torch.workloads.scoring import (
    SCORE_OPS,
    ScoreJournal,
    fasta_records,
    run_batch_score,
    score_step,
    scored_ids,
    tfrecord_records,
)

__all__ = [
    "AA_ALPHABET",
    "SCORE_OPS",
    "ScoreJournal",
    "bucket_length",
    "embed_step",
    "fasta_records",
    "infill_request_arrays",
    "mutagenesis_scan",
    "parse_template",
    "reference_point_mutant_nll",
    "run_batch_score",
    "score_step",
    "scored_ids",
    "tfrecord_records",
]

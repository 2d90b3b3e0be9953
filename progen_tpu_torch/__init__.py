"""PyTorch/CUDA port of progen_tpu: the ProGen protein language model's
inference path (full forward with hand-written CUDA kernels, per-sequence
scoring, KV-cache sampling), its training step (backward through the
kernels, clip + masked AdamW), its data pipeline and CLIs, its
slot-pool serving engine (with int8 weights), the protein-design
workloads (batch scoring, mutagenesis scans, infilling) and the
reference-checkpoint converter. Imports torch and numpy only."""

from progen_tpu_torch.config import ProGenConfig, load_toml_config
from progen_tpu_torch.models.progen import DecodeCache, ProGen

__all__ = ["DecodeCache", "ProGen", "ProGenConfig", "load_toml_config"]

"""Mutagenesis scans: every point mutant of a sequence, scored in batches
built on the device.

The port of the JAX package's ``workloads/mutagenesis.py``: deep
mutational scanning in silico (the ProGen paper's zero-shot fitness
protocol). For each scanned position p and each substitution a, score
the whole sequence with residue p replaced by a. The host ships one
(L,) wild-type row and two index vectors; the (padded, L) mutant rows
are built on the device with one indexed write, as the JAX program's
vmapped ``.at[].set()`` builds them inside one XLA program. The rows are
then scored ``chunk`` at a time (a Python loop under inference mode,
where the JAX program runs ``lax.map``), the NLLs stay on the device,
and the host reads them once at the end. On the card every chunk is one
full forward through the kernels A1, L1 and L2.

Scores are the shared sequence NLL (``training/loss.py``), so
``delta_nll = wt_nll - mutant_nll`` is a log-likelihood ratio: positive
means the mutant is MORE likely than the wild type under the model.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from progen_tpu_torch.data.tokenizer import encode_tokens
from progen_tpu_torch.training.loss import sequence_scores

# the 20 canonical amino acids, alphabetical one-letter codes
AA_ALPHABET = "ACDEFGHIKLMNPQRSTVWY"


def mutant_rows(row: torch.Tensor, pos_idx: torch.Tensor,
                aa_tokens: torch.Tensor, chunk: int) -> torch.Tensor:
    """row (L,) wild-type buffer (BOS at 0); pos_idx (P,) row indices to
    mutate; aa_tokens (A,) substitution ids; all on one device. Returns
    the (padded, L) rows: row i < P·A is mutant (i // A, i % A); the rows
    from P·A up to the chunk multiple are the wild type (their write puts
    the BOS column's own value back), so its NLL comes from row P·A of
    the same batch."""
    P, A = pos_idx.shape[0], aa_tokens.shape[0]
    padded = -(-(P * A + 1) // chunk) * chunk
    i = torch.arange(padded, device=row.device)
    mutant = i < P * A
    safe = i.clamp(max=P * A - 1)
    idx = torch.where(mutant, pos_idx[safe // A], 0)
    tok = torch.where(mutant, aa_tokens[safe % A], row[0])
    rows = row.expand(padded, -1).clone()
    rows[i, idx] = tok.to(rows.dtype)
    return rows


@torch.inference_mode()
def _scan_nll(model, row, pos_idx, aa_tokens, chunk: int):
    """((P, A) mutant NLLs, wild-type NLL) on the model's device, from
    the rows of ``mutant_rows`` scored ``chunk`` at a time."""
    P, A = pos_idx.shape[0], aa_tokens.shape[0]
    rows = mutant_rows(row, pos_idx, aa_tokens, chunk)
    nll = torch.cat([
        sequence_scores(model(part[:, :-1]), part[:, 1:])[0]
        for part in rows.split(chunk)])
    return nll[:P * A].reshape(P, A), nll[P * A]


def mutagenesis_scan(
    model,
    sequence: str,
    *,
    context: str = "",
    positions: Optional[Sequence[int]] = None,
    alphabet: str = AA_ALPHABET,
    chunk: int = 32,
    top: int = 20,
) -> dict:
    """Score every (position, substitution) point mutant of ``sequence``
    with ``model`` (on its own device).

    ``context`` is an optional conditioning tag (the ``[tax=...]``
    annotation grammar); the scored string is ``context + " # " + seq``
    with mutations applied only inside the sequence region.
    ``positions`` are 0-based residue indices into ``sequence`` (default:
    all). Returns a report dict: ``nll`` is the (P, A) float array,
    ``top`` the K best substitutions by ``delta_nll = wt_nll - nll``
    (self-substitutions excluded: they are the wild type itself).
    """
    seq_len = model.config.seq_len
    if not sequence:
        raise ValueError("empty sequence")
    prefix = f"{context} # " if context else "# "
    toks = encode_tokens(prefix + sequence)
    # full-width training layout (BOS, tokens, EOS-then-pad out to
    # seq_len+1): the forward needs exactly seq_len columns (window
    # divisibility, and the SGU matrix of gMLP models); the loss mask
    # keeps the tokens and the first pad, so the padding costs nothing
    if len(toks) + 2 > seq_len + 1:
        raise ValueError(
            f"sequence needs {len(toks) + 2} tokens > model seq_len+1 "
            f"{seq_len + 1}")
    row = np.zeros((seq_len + 1,), np.int64)
    row[1:1 + len(toks)] = toks

    if positions is None:
        positions = range(len(sequence))
    positions = sorted(set(int(p) for p in positions))
    if not positions:
        raise ValueError("no positions to scan")
    for p in positions:
        if not 0 <= p < len(sequence):
            raise ValueError(
                f"position {p} outside sequence of length {len(sequence)}")
    # residue p lives at row index len(prefix) + p + 1 (the BOS shift)
    pos_idx = np.asarray([len(prefix) + p + 1 for p in positions], np.int64)
    aa_tokens = encode_tokens(alphabet).astype(np.int64)

    dev = model.device
    nll, wt_nll = _scan_nll(
        model, torch.from_numpy(row).to(dev),
        torch.from_numpy(pos_idx).to(dev),
        torch.from_numpy(aa_tokens).to(dev), chunk)
    out = torch.cat([nll.reshape(-1), wt_nll[None]]).cpu().numpy()
    nll, wt_nll = out[:-1].reshape(nll.shape), float(out[-1])

    entries = []
    for i, p in enumerate(positions):
        wt_aa = sequence[p]
        for j, aa in enumerate(alphabet):
            if aa == wt_aa:
                continue  # the self-substitution IS the wild type
            entries.append({"pos": p, "wt": wt_aa, "aa": aa,
                            "nll": float(nll[i, j]),
                            "delta_nll": wt_nll - float(nll[i, j])})
    entries.sort(key=lambda e: -e["delta_nll"])
    return {
        "sequence": sequence,
        "context": context,
        "wt_nll": wt_nll,
        "positions": positions,
        "alphabet": alphabet,
        "nll": nll,
        "top": entries[:max(top, 0)],
    }


@torch.inference_mode()
def reference_point_mutant_nll(model, sequence: str, *, context: str = "",
                               position: int = 0, aa: str = "A") -> float:
    """Loop-reference scorer for ONE mutant: the independent oracle the
    batched scan is held against (one forward at batch 1 a call)."""
    mutated = sequence[:position] + aa + sequence[position + 1:]
    prefix = f"{context} # " if context else "# "
    toks = encode_tokens(prefix + mutated)
    row = torch.zeros((1, model.config.seq_len + 1), dtype=torch.long)
    row[0, 1:1 + len(toks)] = torch.from_numpy(toks).long()
    row = row.to(model.device)
    return float(sequence_scores(model(row[:, :-1]), row[:, 1:])[0][0])

"""Evaluation CLI: the mean EOS-masked loss and the perplexity of the
newest checkpoint over a data split, the JAX package's ``cli/eval.py``.

The split is walked once; the last, ragged batch is padded to the batch
size and the padding's scores dropped. The loss of a sequence is the
training loss's (``training/loss.py``, per-sequence masked mean).

Run: python -m progen_tpu_torch.cli.eval --checkpoint_path ./ckpts \
         --data_path ./train_data --split valid
"""

from __future__ import annotations

import argparse

import numpy as np

from progen_tpu_torch._device import resolve_device
from progen_tpu_torch.checkpoint import get_checkpoint_fns
from progen_tpu_torch.config import ProGenConfig
from progen_tpu_torch.data.dataset import iterator_from_tfrecords_folder
from progen_tpu_torch.models.progen import ProGen
from progen_tpu_torch.workloads.scoring import score_step


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="progen_tpu_torch.cli.eval", allow_abbrev=False,
        description="Loss and perplexity of the newest checkpoint.")
    p.add_argument("--checkpoint_path", default="./ckpts")
    p.add_argument("--data_path", default="./train_data")
    p.add_argument("--split", default="valid", choices=("train", "valid"))
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def load_model(checkpoint_path: str, dev):
    """(model, package) from the newest checkpoint's parameters."""
    _, get_last, _ = get_checkpoint_fns(checkpoint_path)
    pkg = get_last.restore_params(device=dev)
    if pkg is None:
        raise SystemExit(f"no checkpoints found at {checkpoint_path}")
    model = ProGen(ProGenConfig.from_dict(pkg.model_config), device=dev,
                   seed=None)
    model.load_state_dict(pkg.state)
    return model.eval(), pkg


def run(argv=None) -> dict:
    """Evaluate; returns the split, its sequence count, the batches run,
    the mean loss and the perplexity."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    model, _ = load_model(args.checkpoint_path, dev)
    num_seqs, iter_fn = iterator_from_tfrecords_folder(args.data_path,
                                                       args.split)
    if num_seqs == 0:
        raise SystemExit(f"no {args.split} records under {args.data_path}")
    losses = []
    for batch in iter_fn(model.config.seq_len, args.batch_size):
        n = batch.shape[0]
        if n < args.batch_size:
            batch = np.pad(batch, ((0, args.batch_size - n), (0, 0)))
        nll = score_step(model, batch, device=dev)[0]
        losses.append(nll.cpu().numpy()[:n])
    per_seq = np.concatenate(losses)
    if per_seq.shape[0] != num_seqs:
        raise RuntimeError(f"scored {per_seq.shape[0]} of {num_seqs} "
                           "sequences")
    mean = float(per_seq.mean())
    perplexity = float(np.exp(mean))
    print(f"{args.split} sequences: {num_seqs:,}")
    print(f"loss: {mean:.4f}")
    print(f"perplexity: {perplexity:.4f}")
    return {"split": args.split, "sequences": num_seqs,
            "batches": len(losses), "loss": mean, "perplexity": perplexity}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

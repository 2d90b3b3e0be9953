"""Sampling CLI: generate protein sequences from the newest checkpoint,
the JAX package's ``cli/sample.py``.

The model is rebuilt from the checkpoint's stored config alone, the prime
is byte-tokenised, the decode runs with BOS prepended, and what follows
the prime is printed. Primes: ``"[tax=Mammalia] #"`` generates a
sequence, ``"SEQ #"`` its annotations.

Fixed-position infilling (``workloads/infill.py``): ``--template
"MK?LV??G"`` keeps the non-``?`` characters verbatim and samples the
free slots (``--free_char`` names the sentinel); the leading frozen run
primes the decode, so ``--prime`` and ``--template`` exclude each other,
and a template decodes one sequence.

Run: python -m progen_tpu_torch.cli.sample --prime "[tax=Mammalia] #"
"""

from __future__ import annotations

import argparse

import numpy as np

from progen_tpu_torch._device import resolve_device
from progen_tpu_torch.cli.eval import load_model
from progen_tpu_torch.data.tokenizer import decode_tokens, encode_tokens
from progen_tpu_torch.sampling import (
    sample,
    sample_batched,
    sample_fast,
    sample_fast_batched,
)
from progen_tpu_torch.workloads.infill import (
    infill_request_arrays,
    parse_template,
)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="progen_tpu_torch.cli.sample", allow_abbrev=False,
        description="Sample sequences from the newest checkpoint.")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--checkpoint_path", default="./ckpts")
    p.add_argument("--prime", default="")
    p.add_argument("--top_k", default=25, type=int)
    p.add_argument("--temperature", default=1.0, type=float,
                   help="logit temperature before top-k/top-p filtering")
    p.add_argument("--top_p", default=None, type=float,
                   help="nucleus sampling: keep the smallest top set with "
                        "cumulative mass >= p (combines with --top_k)")
    p.add_argument("--naive", action="store_true",
                   help="a full forward per token instead of the KV cache")
    p.add_argument("--num_samples", default=1, type=int,
                   help="decode this many sequences from the prime in one "
                        "batch")
    p.add_argument("--template", default=None,
                   help="infilling template: non-free characters are frozen "
                        "verbatim, --free_char slots are sampled (replaces "
                        "--prime; the frozen prefix primes the decode)")
    p.add_argument("--free_char", default="?",
                   help="the free-position sentinel inside --template")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def run(argv=None) -> dict:
    """Sample; returns ``tokens`` ((length,), or (num_samples, length) on
    the device) and ``texts``, the decoded continuations."""
    args = parse_args(argv)
    prime, length, infill = args.prime, None, {}
    if args.template is not None:
        if args.prime:
            raise SystemExit("--template and --prime are mutually exclusive "
                             "(the template's frozen prefix is the prime)")
        if args.num_samples > 1:
            raise SystemExit("--template decodes one sequence "
                             "(--num_samples 1)")
        toks, frz = parse_template(args.template, args.free_char)
        prime_tokens, length, tpl, frz = infill_request_arrays(
            toks, frz, add_bos=True)
        prime = decode_tokens(prime_tokens)
        infill = dict(template=tpl, frozen=frz)
    else:
        prime_tokens = encode_tokens(prime)
    dev = resolve_device(args.device)
    model, pkg = load_model(args.checkpoint_path, dev)
    config = model.config
    print(f"params: {sum(p.numel() for p in model.parameters()):,}")
    print(f"sequence length: {config.seq_len}")
    print(f"trained for {max(pkg.next_seq_index, 0):,} sequences")

    prime_length = len(prime_tokens) + 1  # + BOS
    knobs = dict(top_k=args.top_k, add_bos=True,
                 temperature=args.temperature, top_p=args.top_p, device=dev)
    if args.num_samples > 1:
        batched = sample_batched if args.naive else sample_fast_batched
        tokens = batched(args.seed, model,
                         np.tile(prime_tokens, (args.num_samples, 1)),
                         config.seq_len, **knobs)
        texts = [decode_tokens(row[prime_length:])
                 for row in tokens.cpu().numpy()]
        print("\n", prime, "\n", "*" * 40)
        for text in texts:
            print(text, "\n", "-" * 40)
    else:
        single = sample if args.naive else sample_fast
        tokens = single(args.seed, model, prime_tokens,
                        length or config.seq_len, **knobs, **infill)
        texts = [decode_tokens(tokens.cpu().numpy()[prime_length:])]
        print("\n", prime, "\n", "*" * 40, "\n", texts[0])
    return {"tokens": tokens, "texts": texts}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

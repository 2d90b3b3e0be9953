"""Mutagenesis scan CLI: score every point mutant of a sequence, the JAX
package's ``cli/scan.py``.

In-silico deep mutational scanning (``workloads/mutagenesis.py``): the
positions x 20 substitution rows are built on the device and scored
``--chunk`` at a time, then ranked by ``delta_nll = wt_nll -
mutant_nll`` (positive: the model prefers the mutant). An aligned table
of the top K is printed; ``--out`` writes the full report (the NLL
matrix and the top table) as JSON.

Run: python -m progen_tpu_torch.cli.scan --checkpoint_path ./ckpts \\
         --sequence MKTAYIAKQR --context "[tax=Mammalia]"
"""

from __future__ import annotations

import argparse
import json

from progen_tpu_torch._device import resolve_device
from progen_tpu_torch.cli.eval import load_model
from progen_tpu_torch.workloads.mutagenesis import mutagenesis_scan


def _parse_positions(spec, seq_len):
    """"START:END" (0-based, half-open) or a comma list -> indices."""
    if spec is None:
        return None
    if ":" in spec:
        start_s, end_s = spec.split(":", 1)
        start = int(start_s) if start_s else 0
        end = int(end_s) if end_s else seq_len
        return range(start, end)
    return [int(p) for p in spec.split(",") if p.strip()]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="progen_tpu_torch.cli.scan", allow_abbrev=False,
        description="Score every point mutant of a sequence.")
    p.add_argument("--checkpoint_path", default="./ckpts")
    p.add_argument("--sequence", default=None,
                   help="the amino-acid sequence to scan (or use --fasta)")
    p.add_argument("--fasta", default=None,
                   help="take the sequence from this FASTA file instead")
    p.add_argument("--index", default=0, type=int,
                   help="which FASTA record to scan (0-based)")
    p.add_argument("--context", default="",
                   help="conditioning tag (scored as 'context # SEQ')")
    p.add_argument("--positions", default=None,
                   help="residues to scan: 'START:END' (0-based, "
                        "half-open) or 'p1,p2,...' (default: every "
                        "position)")
    p.add_argument("--top", default=20, type=int,
                   help="report the K best substitutions")
    p.add_argument("--chunk", default=32, type=int,
                   help="mutants scored per forward (the peak-memory knob)")
    p.add_argument("--out", dest="out_path", default=None,
                   help="write the full report (NLL matrix + top table) as "
                        "JSON here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def run(argv=None) -> dict:
    """Scan; returns the report (``nll`` a (positions, 20) array)."""
    args = parse_args(argv)
    if (args.sequence is None) == (args.fasta is None):
        raise SystemExit("pass exactly one of --sequence / --fasta")
    dev = resolve_device(args.device)
    sequence = args.sequence
    if args.fasta is not None:
        from progen_tpu_torch.data.fasta import parse_fasta

        recs = list(parse_fasta(args.fasta))
        if not 0 <= args.index < len(recs):
            raise SystemExit(f"--index {args.index} outside {len(recs)} "
                             "FASTA records")
        sequence = recs[args.index][1]
    model, _ = load_model(args.checkpoint_path, dev)
    report = mutagenesis_scan(
        model, sequence, context=args.context,
        positions=_parse_positions(args.positions, len(sequence)),
        chunk=args.chunk, top=args.top)
    print(f"wild-type NLL: {report['wt_nll']:.4f} "
          f"({len(report['positions'])} positions x "
          f"{len(report['alphabet'])} substitutions)")
    print(f"{'pos':>5} {'wt':>3} {'mut':>4} {'nll':>9} {'delta_nll':>10}")
    for e in report["top"]:
        print(f"{e['pos']:>5} {e['wt']:>3} {e['aa']:>4} "
              f"{e['nll']:>9.4f} {e['delta_nll']:>+10.4f}")
    if args.out_path:
        doc = dict(report)
        doc["nll"] = [[float(x) for x in row] for row in report["nll"]]
        doc["positions"] = [int(p) for p in report["positions"]]
        with open(args.out_path, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2)
        print(f"report written to {args.out_path}")
    return report


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""``progen-tpu-torch-lint`` — the gate over the port's PGL rules, the
port's copy of the JAX package's ``cli/lint.py`` (argparse in place of
click, with the same flags, output and exit codes).

Pure-host tooling: it imports nothing of JAX, click or the JAX package,
and runs on any host. Exit code contract:

  0  no findings beyond the baseline
  1  at least one NEW finding (printed, and written to --json if given),
     or a stale registry block under --registry-check
  2  usage/baseline errors (malformed baseline entries fail loudly —
     a silent baseline is how gates rot)

The baseline is ``lint_baseline_torch.json``, found next to the first
PATH, at the root of the repo the first PATH belongs to, or in the
working directory; ``--baseline`` names another.

Run: python -m progen_tpu_torch.cli.lint progen_tpu_torch/ chip_smoke.py \\
         tests/test_torch_*.py
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from progen_tpu_torch.analysis import (
    RULE_DOCS,
    BaselineError,
    lint_paths,
    load_baseline,
    report_json,
)
from progen_tpu_torch.cli import echo, existing_file

BASELINE_NAME = "lint_baseline_torch.json"


def existing_path(path: str) -> str:
    """An argparse type: a file or directory that exists."""
    if not Path(path).exists():
        raise argparse.ArgumentTypeError(f"path {path!r} does not exist")
    return path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="progen_tpu_torch.cli.lint", allow_abbrev=False,
        description="Lint PATHS (files or directories) with the port's PGL "
                    "rule set.")
    p.add_argument("paths", nargs="*", type=existing_path)
    p.add_argument("--baseline", dest="baseline_path", default=None,
                   help="baseline JSON of grandfathered findings (default: "
                        f"{BASELINE_NAME} next to the first PATH, at its "
                        "repo's root or in the cwd, when present)")
    p.add_argument("--no-baseline", dest="no_baseline",
                   action="store_true",
                   help="ignore any baseline file: report every finding as "
                        "new")
    p.add_argument("--json", dest="json_out", default=None,
                   help="write the machine-readable findings report here")
    p.add_argument("--list-rules", dest="list_rules", action="store_true",
                   help="print the rule table and exit")
    p.add_argument("--registry-dump", dest="registry_dump",
                   action="store_true",
                   help="print the generated chaos-site + event-grammar "
                        "registry block (paste between the registry-torch "
                        "markers in README.md) and exit")
    p.add_argument("--registry-check", dest="registry_check_path",
                   type=existing_file, default=None,
                   help="verify the port's registry block committed in the "
                        "given markdown file matches the code; exit 1 on "
                        "drift")
    return p


def _baseline_candidates(paths, baseline_path):
    if baseline_path:
        return [Path(baseline_path)]
    from progen_tpu_torch.analysis.registry import repo_root

    first = Path(paths[0]).resolve()
    out = [first.parent / BASELINE_NAME]
    try:
        out.append(repo_root(first) / BASELINE_NAME)
    except FileNotFoundError:
        pass
    out.append(Path.cwd() / BASELINE_NAME)
    return out


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.list_rules:
        for rule_id in sorted(RULE_DOCS):
            echo(f"{rule_id}  {RULE_DOCS[rule_id]}")
        return 0
    if args.registry_dump:
        from progen_tpu_torch.analysis.registry import (
            render_registry_markdown,
        )

        echo(render_registry_markdown())
        return 0
    if args.registry_check_path:
        from progen_tpu_torch.analysis.registry import registry_check

        problem = registry_check(args.registry_check_path)
        if problem is not None:
            echo(f"error: {problem}", err=True)
            return 1
        echo(f"{args.registry_check_path}: registry block up to date")
        return 0
    if not args.paths:
        parser.error("no paths given (try: progen-tpu-torch-lint "
                     "progen_tpu_torch/)")

    baseline = []
    if not args.no_baseline:
        for cand in _baseline_candidates(args.paths, args.baseline_path):
            if cand.is_file():
                try:
                    baseline = load_baseline(cand)
                except (BaselineError, json.JSONDecodeError) as e:
                    echo(f"error: bad baseline: {e}", err=True)
                    return 2
                break
        else:
            if args.baseline_path:
                echo(f"error: baseline not found: {args.baseline_path}",
                     err=True)
                return 2

    new, baselined = lint_paths(args.paths, baseline=baseline)

    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(
            json.dumps(report_json(new, baselined), indent=2) + "\n"
        )

    for f in new:
        echo(f.render())
    if new:
        by_rule = {}
        for f in new:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        breakdown = ", ".join(
            f"{k}: {v}" for k, v in sorted(by_rule.items())
        )
        echo(
            f"\n{len(new)} finding(s) ({breakdown})"
            + (f"; {len(baselined)} baselined" if baselined else ""),
            err=True,
        )
        return 1
    echo(
        f"clean ({len(baselined)} baselined finding(s))"
        if baselined
        else "clean"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's generated registry block of README.md, drift-locked. The
port's copy of the JAX package's ``analysis/registry.py``, over the
port's surface and between markers of its own, in the README's port
section; the JAX package's block stays the JAX lint's.

Two registries document the distributed-systems surface of the port:
the chaos-injection sites (``resilience/chaos.py``'s KNOWN_TARGETS,
cross-checked against the installed span/retry/inject calls by PGL009)
and the telemetry event grammars (``analysis/event_grammar.py``,
enforced producer-side by PGL006 and consumer-side by PGL010). Both
live in code; the README copies rot the moment someone adds a site or
an event field and forgets the docs.

So the README does not hand-maintain them: the block between the
``<!-- registry-torch:begin -->`` / ``<!-- registry-torch:end -->``
markers is generated by ``progen-tpu-torch-lint --registry-dump``, and
``progen-tpu-torch-lint --registry-check README.md`` fails when the
committed copy differs from what the code declares.

Everything here is AST-level: KNOWN_TARGETS and the installed-site
index come from :class:`~progen_tpu_torch.analysis.project.ProjectContext`,
NOT from importing ``resilience.chaos`` — the lint CLI must run with
jax, click and the JAX package blocked (``tests/test_torch_analysis.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

from progen_tpu_torch.analysis.core import ModuleContext
from progen_tpu_torch.analysis.event_grammar import render_grammar_markdown
from progen_tpu_torch.analysis.project import ProjectContext
from progen_tpu_torch.analysis.runner import discover_files

REGISTRY_BEGIN = "<!-- registry-torch:begin -->"
REGISTRY_END = "<!-- registry-torch:end -->"


def repo_root(start=None) -> Path:
    """Walk up from ``start`` (default: this file) to pyproject.toml."""
    cur = Path(start) if start is not None else Path(__file__)
    cur = cur.resolve()
    if cur.is_file():
        cur = cur.parent
    while True:
        if (cur / "pyproject.toml").is_file():
            return cur
        if cur.parent == cur:
            raise FileNotFoundError(
                "no pyproject.toml above " + str(cur)
            )
        cur = cur.parent


def build_project(paths: Sequence, rel_to: Optional[Path] = None
                  ) -> ProjectContext:
    """Parse every discovered file under ``paths`` into the shared
    project index (no rules run, no text files — sites and
    KNOWN_TARGETS only)."""
    contexts: List[ModuleContext] = []
    for f in discover_files(paths):
        try:
            contexts.append(
                ModuleContext(f, Path(f).read_text(), rel_to=rel_to)
            )
        except (OSError, SyntaxError):
            continue
    return ProjectContext.build(contexts)


def render_chaos_sites_markdown(proj: ProjectContext) -> str:
    """The "Chaos sites" table: every KNOWN_TARGETS entry with the
    modules that install it. Module paths only (no line numbers), so
    the committed copy survives unrelated edits to the installing
    file."""
    lines = [
        "### Chaos sites of the port",
        "",
        "Injection targets for `PROGEN_CHAOS=\"target:spec\"` "
        "(see `progen_tpu_torch/resilience/chaos.py`); the port's PGL009 "
        "keeps this registry, the installed sites, and every kill-matrix "
        "reference in lockstep.",
        "",
        "| target | installed in |",
        "|---|---|",
    ]
    for target in sorted(proj.declared):
        mods = sorted({p for p, _line in proj.sites.get(target, ())})
        where = ", ".join(f"`{m}`" for m in mods) if mods else "—"
        lines.append(f"| `{target}` | {where} |")
    return "\n".join(lines)


def render_registry_markdown(paths: Sequence = (),
                             rel_to: Optional[Path] = None) -> str:
    """The full generated block (without the begin/end markers)."""
    if not paths:
        root = repo_root()
        paths = [root / "progen_tpu_torch"]
        rel_to = rel_to or root
    proj = build_project(paths, rel_to=rel_to)
    return "\n".join([
        render_chaos_sites_markdown(proj),
        "",
        "### Event grammars of the port",
        "",
        "Declared in `progen_tpu_torch/analysis/event_grammar.py`; "
        "producers are held to them by PGL006, consumers by PGL010.",
        "",
        render_grammar_markdown(),
    ])


def extract_registry_block(text: str) -> Optional[str]:
    """The committed block between the markers, or None if the
    markers are absent/malformed."""
    try:
        _, rest = text.split(REGISTRY_BEGIN, 1)
        block, _ = rest.split(REGISTRY_END, 1)
    except ValueError:
        return None
    return block.strip("\n")


def registry_check(doc_path) -> Optional[str]:
    """None when the committed block matches the generated one, else
    a human-readable mismatch description."""
    text = Path(doc_path).read_text()
    committed = extract_registry_block(text)
    if committed is None:
        return (
            f"{doc_path}: missing {REGISTRY_BEGIN} / {REGISTRY_END} "
            f"markers"
        )
    generated = render_registry_markdown().strip("\n")
    if committed == generated:
        return None
    got = committed.splitlines()
    want = generated.splitlines()
    for i, (g, w) in enumerate(zip(got, want), start=1):
        if g != w:
            return (
                f"{doc_path}: registry block is stale (first diff at "
                f"block line {i}):\n  committed: {g!r}\n  generated: "
                f"{w!r}\nregenerate with: progen-tpu-torch-lint "
                f"--registry-dump"
            )
    return (
        f"{doc_path}: registry block is stale (committed {len(got)} "
        f"lines, generated {len(want)}); regenerate with: "
        f"progen-tpu-torch-lint --registry-dump"
    )

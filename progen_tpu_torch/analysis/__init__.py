"""progen-tpu-torch-lint: the static analysis of the port's host stack.

The port's copy of the JAX package's ``analysis/``, with the rules that
do not depend on the backend. An AST linter with one rule per defect
class, run over the port (``progen-tpu-torch-lint progen_tpu_torch/
chip_smoke.py tests/test_torch_*.py``), failing on any non-baselined
finding. It imports nothing of JAX or of the JAX package.

Rules (see each module's docstring for the full rationale):

  PGL006  telemetry hygiene (literal span names, event-grammar
          producer checks via analysis/event_grammar.py,
          Prometheus-legal metric names)
  PGL007  durable-path write discipline (atomic tmp+fsync+replace
          publishes, fsync'd ledger appends)
  PGL008  lock discipline (guarded-attr consistency; no blocking
          locks or lock-holding I/O in tap/excepthook/signal handlers)
  PGL009  chaos-site drift (every PROGEN_CHAOS target referenced in
          the port's tests, chip_smoke.py and the README's port section
          names an installed site; KNOWN_TARGETS matches the installed
          surface) — whole-project pass
  PGL010  event-grammar exhaustiveness, consumer side (dispatches on
          op/status/state handle every declared value or carry a
          default branch)

PGL001-PGL005 (host syncs in jitted regions, PRNG key reuse, donated
buffers, recompilation hazards, side effects in traced code) and their
traced-region index are the JAX package's alone: the port has no
``jax.jit``, ``lax.scan``, PRNG key or ``donate_argnums`` to judge.

Suppress a single accepted finding inline with
``# progen: ignore[PGL007]``; grandfathered findings live in
``lint_baseline_torch.json`` with a reason string each
(analysis/runner.py).
"""

from progen_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    ProjectRule,
    Rule,
)
from progen_tpu_torch.analysis.event_grammar import (
    BY_EV,
    GRAMMARS,
    EventGrammar,
    render_grammar_markdown,
)
from progen_tpu_torch.analysis.project import (
    ProjectContext,
    default_text_files,
)
from progen_tpu_torch.analysis.runner import (
    PROJECT_RULES,
    RULE_DOCS,
    RULES,
    BaselineError,
    discover_files,
    lint_file,
    lint_paths,
    load_baseline,
    report_json,
)

__all__ = [
    "Finding",
    "ModuleContext",
    "ProjectContext",
    "ProjectRule",
    "Rule",
    "RULES",
    "PROJECT_RULES",
    "RULE_DOCS",
    "BY_EV",
    "GRAMMARS",
    "EventGrammar",
    "BaselineError",
    "default_text_files",
    "discover_files",
    "lint_file",
    "lint_paths",
    "load_baseline",
    "render_grammar_markdown",
    "report_json",
]

"""PGL009 — chaos-site drift: every referenced target must exist. The
port's copy of the JAX package's rule; the port's references are its
tests, ``chip_smoke.py`` and the README's port section.

The chaos harness (``resilience/chaos.py``) keys injection rules on
site names — span names, retry labels, ``maybe_inject``/``perturb``
call sites. A ``PROGEN_CHAOS="ckpt/save:kill@2"`` kill-matrix entry in
a test, in ``chip_smoke.py``, or in the README only tests something if a site
named ``ckpt/save`` is actually installed in the code. When the code
is refactored and a span renamed, the kill-matrix keeps passing — it
now injects into nothing, and the crash-safety property it used to
prove is unguarded. That is the worst kind of CI rot: green and
meaningless. Chaos.py's runtime warn-once on unknown targets catches
the env-var case *if someone reads the logs*; this rule fails the
build instead, and from the whole-project index, so a reference in a
doc is held to the same standard as one in a test.

Three drift directions, all errors:

  * **ghost reference** — a ``target:spec`` string (test, CI workflow,
    doc) names a site no span/retry-label/inject call installs;
  * **stale registry** — a referenced site exists in code but is
    missing from ``KNOWN_TARGETS``, so the runtime's
    unknown-target warning fires spuriously and the declared registry
    no longer documents the real surface;
  * **dead declaration** — ``KNOWN_TARGETS`` declares a site nothing
    installs: the registry promises an injection point that is not
    there.

Site and reference indices come from
:class:`~progen_tpu_torch.analysis.project.ProjectContext`, built once over
the whole linted set (plus the README's port section). The rule
only judges when a ``KNOWN_TARGETS`` declaration is in the linted set:
the declaration is the marker that the injection surface is in scope.
Linting a single test file proves nothing about which sites exist, so
no findings are produced — lint the package and the declaration comes
with it.
"""

from __future__ import annotations

from typing import Set, Tuple

from progen_tpu_torch.analysis.core import ProjectRule


class ChaosDriftRule(ProjectRule):
    id = "PGL009"
    severity = "error"
    doc = ("chaos-site drift: every PROGEN_CHAOS target referenced in "
           "tests/chip_smoke.py/the README's port section must name an "
           "installed span/retry/"
           "inject site, and resilience/chaos.py's KNOWN_TARGETS must "
           "match the installed surface in both directions — a ghost "
           "reference is a kill-matrix that silently tests nothing")

    def run(self):
        proj = self.project
        if proj.declaration is None:
            # without KNOWN_TARGETS in the linted set the installed
            # surface is not in scope — a partial lint (one test file)
            # proves nothing about which sites exist
            return self.findings
        seen: Set[Tuple[str, str, int, str]] = set()

        def once(kind: str, target: str, path: str, line: int) -> bool:
            key = (kind, target, path, line)
            if key in seen:
                return False
            seen.add(key)
            return True

        for ref in proj.chaos_refs:
            if ref.target in proj.sites:
                if (
                    proj.declaration is not None
                    and ref.target not in proj.declared
                    and once("undecl", ref.target, ref.path, ref.line)
                ):
                    self._emit(
                        ref,
                        f"chaos target '{ref.target}' is installed in "
                        f"code but missing from KNOWN_TARGETS — the "
                        f"runtime will warn-once 'unknown chaos "
                        f"target' on every install and the declared "
                        f"registry no longer documents the real "
                        f"injection surface; add it to KNOWN_TARGETS",
                    )
                continue
            if once("ghost", ref.target, ref.path, ref.line):
                self._emit(
                    ref,
                    f"chaos target '{ref.target}' is referenced here "
                    f"but no span/retry-label/inject site installs it "
                    f"— this kill-matrix entry injects into nothing "
                    f"and the crash-safety property it claims to test "
                    f"is unguarded (site renamed or removed?)",
                )
        if proj.declaration is not None:
            for target, (ctx, node) in sorted(proj.declared.items()):
                if target in proj.sites:
                    continue
                self.report_at(
                    ctx, node,
                    f"KNOWN_TARGETS declares chaos site '{target}' "
                    f"but no span/retry-label/inject call installs it "
                    f"— the registry promises an injection point that "
                    f"does not exist",
                )
        self.findings.sort(key=lambda f: (f.path, f.line, f.message))
        return self.findings

    def _emit(self, ref, message: str) -> None:
        if ref.ctx is not None and ref.node is not None:
            self.report_at(ref.ctx, ref.node, message)
        elif ref.ctx is not None:
            # comment-only reference: suppression still honored via
            # the line check, no AST node to hang qualname on
            if not ref.ctx.is_suppressed(self.id, ref.line):
                self.report_text(ref.path, ref.line, message)
        else:
            self.report_text(ref.path, ref.line, message)

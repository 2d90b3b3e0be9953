"""The port's lint (``progen_tpu_torch.analysis``, PGL006-PGL010, and
``progen_tpu_torch.cli.lint``) against the JAX package's:

  * each ``tests/lint_fixtures/pgl00{6..10}_{tp,tn}.py`` gives the same
    findings (rule, path, line, column, function, message) through both
    lints' ``lint_file``; the JAX lint's PGL001-PGL005 are left out, and
    a message that names a package directory is compared with the port's
    ``progen_tpu_torch/`` read as ``progen_tpu/`` (the port's messages
    name its own directories);
  * ``python -m progen_tpu_torch.cli.lint progen_tpu_torch/ chip_smoke.py
    tests/test_torch_*.py`` exits 0 against ``lint_baseline_torch.json``
    with jax, flax, click and progen_tpu blocked, and every baseline entry
    has a reason and matches a finding;
  * the exit codes 0/1/2 and the README's generated port registry block;
  * the project pass reads the README's port section and nothing else of
    the repo's docs, so no JAX-only file can produce a finding there.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from progen_tpu.analysis import lint_file as jax_lint_file
from progen_tpu.analysis.event_grammar import GRAMMARS as JAX_GRAMMARS
from progen_tpu_torch.analysis import (
    GRAMMARS,
    PROJECT_RULES,
    RULE_DOCS,
    RULES,
    ProjectContext,
    default_text_files,
    lint_file,
    lint_paths,
    load_baseline,
)
from progen_tpu_torch.analysis.project import (
    PORT_README_HEADING,
    section_lines,
)
from progen_tpu_torch.cli import lint as lint_cli

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "lint_fixtures"
PORT_RULES = ("PGL006", "PGL007", "PGL008", "PGL009", "PGL010")
BLOCKED = ("jax", "jaxlib", "flax", "click", "progen_tpu")


def _key(f, port: bool):
    msg = f.message.replace("progen_tpu_torch/", "progen_tpu/") if port \
        else f.message
    return (f.rule, f.severity, f.path, f.line, f.col, f.func, msg)


@pytest.mark.parametrize("name", [
    f"{rule.lower()}_{kind}.py" for rule in PORT_RULES
    for kind in ("tp", "tn")])
def test_fixture_findings_equal_the_jax_lint(name, monkeypatch):
    monkeypatch.chdir(REPO)
    path = Path("tests") / "lint_fixtures" / name
    got = [_key(f, True) for f in lint_file(path)]
    want = [_key(f, False) for f in jax_lint_file(path)
            if f.rule in PORT_RULES]
    assert got == want
    assert bool(got) == name.endswith("_tp.py")


def test_rule_set_is_the_backend_free_one():
    assert sorted({r.id for r in RULES} | {r.id for r in PROJECT_RULES}) \
        == list(PORT_RULES)
    assert sorted(RULE_DOCS) == list(PORT_RULES)
    # the grammar table is the JAX package's, record for record
    assert [(g.ev, g.owners, g.scope, g.required,
             [(e.field, e.values) for e in g.enums]) for g in GRAMMARS] == \
        [(g.ev, g.owners, g.scope, g.required,
          [(e.field, e.values) for e in g.enums]) for g in JAX_GRAMMARS]


def _blocked_cli(args, cwd=REPO):
    """``python -m progen_tpu_torch.cli.lint ARGS`` with the JAX stack,
    click and the JAX package unimportable."""
    code = (
        "import runpy, sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"sys.argv = ['progen_tpu_torch.cli.lint', *{list(args)!r}]\n"
        "runpy.run_module('progen_tpu_torch.cli.lint', "
        "run_name='__main__')\n")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=240)


def test_port_surface_is_clean_against_its_baseline(tmp_path):
    """The gate over the port: exit 0 with the JAX stack blocked, every
    baseline entry carrying a reason and matching a finding."""
    report = tmp_path / "report.json"
    surface = ["progen_tpu_torch/", "chip_smoke.py"] + sorted(
        str(p.relative_to(REPO)) for p in
        (REPO / "tests").glob("test_torch_*.py"))
    res = _blocked_cli([*surface, "--json", str(report)])
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert res.stdout.strip() == "clean (2 baselined finding(s))"
    rep = json.loads(report.read_text())
    assert rep["tool"] == "progen-tpu-torch-lint"
    assert rep["findings"] == []
    baseline = load_baseline(REPO / "lint_baseline_torch.json")
    assert all(e["reason"].strip() for e in baseline)
    matched = {(f["rule"], f["func"]) for f in rep["baselined"]}
    for e in baseline:
        assert (e["rule"], e["func"]) in matched, e
    assert sorted(f["func"] for f in rep["baselined"]) == \
        ["RequestJournal.emit", "ScoreJournal.emit"]


class TestCli:
    def test_clean_file_exits_zero(self, capsys):
        assert lint_cli.main(["--no-baseline",
                              str(FIXTURES / "pgl007_tn.py")]) == 0
        assert capsys.readouterr().out.strip() == "clean"

    def test_findings_exit_one_and_print(self, capsys, tmp_path):
        out = tmp_path / "r.json"
        assert lint_cli.main(["--no-baseline", "--json", str(out),
                              str(FIXTURES / "pgl007_tp.py")]) == 1
        assert capsys.readouterr().out.count("PGL007") == 5
        assert json.loads(out.read_text())["summary"]["by_rule"] == \
            {"PGL007": 5}

    def test_baseline_grandfathers(self, tmp_path, capsys):
        base = tmp_path / "b.json"
        base.write_text(json.dumps({"findings": [
            {"rule": "PGL007", "path": "pgl007_tp.py",
             "reason": "fixture corpus"}]}))
        assert lint_cli.main(["--baseline", str(base),
                              str(FIXTURES / "pgl007_tp.py")]) == 0
        assert "5 baselined" in capsys.readouterr().out

    @pytest.mark.parametrize("entries", [
        [{"rule": "PGL007", "path": "x.py"}],  # no reason
        {"findings": "not a list"},
    ])
    def test_malformed_baseline_exits_two(self, tmp_path, entries):
        bad = tmp_path / "b.json"
        bad.write_text(json.dumps(entries))
        assert lint_cli.main(["--baseline", str(bad),
                              str(FIXTURES / "pgl007_tn.py")]) == 2

    def test_usage_errors_exit_two(self, tmp_path):
        for argv in ([], [str(tmp_path / "missing.py")],
                     ["--baseline", str(tmp_path / "none.json"),
                      str(FIXTURES / "pgl007_tn.py")],
                     ["--registry-check", str(tmp_path / "none.md")]):
            try:
                rc = lint_cli.main(argv)
            except SystemExit as e:  # argparse's usage exit
                rc = e.code
            assert rc == 2, argv

    def test_list_rules(self, capsys):
        assert lint_cli.main(["--list-rules"]) == 0
        out = capsys.readouterr().out
        assert [ln.split()[0] for ln in out.splitlines()] == \
            list(PORT_RULES)


class TestRegistry:
    def test_readme_port_block_is_up_to_date(self):
        res = _blocked_cli(["--registry-check", "README.md"])
        assert res.returncode == 0, res.stderr
        assert "registry block up to date" in res.stdout

    def test_dump_lists_the_ports_sites_and_grammars(self, capsys):
        from progen_tpu_torch.resilience.chaos import KNOWN_TARGETS

        assert lint_cli.main(["--registry-dump"]) == 0
        out = capsys.readouterr().out
        assert "### Chaos sites of the port" in out
        assert "### Event grammars of the port" in out
        for target in KNOWN_TARGETS:
            assert f"| `{target}` | `progen_tpu_torch/" in out
        assert "progen_tpu/" not in out.replace("progen_tpu_torch/", "")

    def test_stale_block_exits_one_and_jax_block_untouched(self, tmp_path):
        from progen_tpu.analysis import registry as jax_registry
        from progen_tpu_torch.analysis.registry import (
            REGISTRY_BEGIN,
            REGISTRY_END,
            registry_check,
        )

        assert REGISTRY_BEGIN != jax_registry.REGISTRY_BEGIN
        doc = tmp_path / "doc.md"
        doc.write_text(f"{REGISTRY_BEGIN}\nold\n{REGISTRY_END}\n")
        assert "stale" in registry_check(doc)
        assert lint_cli.main(["--registry-check", str(doc)]) == 1
        doc.write_text("no markers\n")
        assert "markers" in registry_check(doc)
        # the JAX block of the same README is still the JAX lint's
        assert jax_registry.registry_check(REPO / "README.md") is None


class TestPortSection:
    def test_text_files_are_the_readme_port_section(self):
        assert default_text_files([REPO / "progen_tpu_torch"]) == \
            [(REPO / "README.md", PORT_README_HEADING)]

    def test_section_lines(self):
        text = ("# top\n## PyTorch/CUDA port\nin 1\n### sub\nin 2\n"
                "## Configs\nout\n")
        assert section_lines(text, "## PyTorch/CUDA port") == [
            (2, "## PyTorch/CUDA port"), (3, "in 1"), (4, "### sub"),
            (5, "in 2")]
        assert section_lines(text, "## Missing") == []
        assert len(section_lines(text)) == 7

    def test_only_the_port_section_is_judged(self, tmp_path):
        """A ghost target in the README's port section is a finding; the
        same outside it, or in another doc or a workflow, is not."""
        ghost = "ghost/site" + ":kill@1"
        (tmp_path / "pyproject.toml").write_text("[project]\nname='x'\n")
        (tmp_path / "README.md").write_text(
            f"# x\n{ghost}\n## PyTorch/CUDA port\nrun with {ghost}\n"
            f"## Configs\n{ghost}\n")
        (tmp_path / "PERF.md").write_text(f"{ghost}\n")
        (tmp_path / ".github" / "workflows").mkdir(parents=True)
        (tmp_path / ".github" / "workflows" / "ci.yml").write_text(
            f"run: {ghost}\n")
        pkg = tmp_path / "pkg"
        pkg.mkdir()
        (pkg / "chaos.py").write_text(
            'KNOWN_TARGETS = frozenset({"real/site"})\n')
        (pkg / "work.py").write_text(
            'def f(span):\n    with span("real/site"):\n        pass\n')
        new, _ = lint_paths([pkg], rel_to=tmp_path)
        assert [(f.rule, Path(f.path).name, f.line) for f in new] == \
            [("PGL009", "README.md", 4)]

    def test_project_context_takes_sections_and_paths(self, tmp_path):
        doc = tmp_path / "doc.md"
        spec = "real/site" + ":fail@2"
        doc.write_text(f"{spec}\n## Part\n{spec}\n")
        whole = ProjectContext.build([], text_files=[doc])
        part = ProjectContext.build([], text_files=[(doc, "## Part")])
        assert [r.line for r in whole.chaos_refs] == [1, 3]
        assert [r.line for r in part.chaos_refs] == [3]

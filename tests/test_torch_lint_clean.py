"""The port is clean under its own invariant linter, every suppression in
it is justified and listed in docs/analysis_torch.md, and the linter runs
with neither jax nor the JAX package importable."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.analysis import Project, analyze  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def project():
    return Project.load(REPO)


def test_port_is_lint_clean(project):
    assert {sf.rel.split("/")[1] for sf in project.files} == {"repro_torch"}
    active = [f for f in analyze(project) if not f.suppressed]
    assert not active, (
        "unsuppressed findings of the port's linter (fix, or suppress with "
        "a justified '# repro: disable=REPxxx -- why'):\n"
        + "\n".join(f.render() for f in active))


def test_every_suppression_in_the_port_is_justified_and_listed(project):
    listed = (REPO / "docs" / "analysis_torch.md").read_text()
    seen = 0
    for sf in project.files:
        for d in sf.directives.values():
            seen += 1
            assert d.justification, (
                f"{sf.rel}:{d.line}: suppression without justification")
            for code in d.codes:
                assert f"`{sf.rel}` {code}" in listed, (
                    f"{sf.rel}:{d.line} {code} is not listed in "
                    f"docs/analysis_torch.md")
    assert seen


def test_linter_runs_without_jax_or_the_reference():
    code = ("import runpy, sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "sys.argv = ['repro-torch-lint', '--format', 'json']; "
            "runpy.run_module('repro_torch.analysis', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    doc = json.loads(out.stdout)
    assert doc["ok"] is True
    assert doc["files_scanned"] == len(
        list((REPO / "src" / "repro_torch").rglob("*.py")))

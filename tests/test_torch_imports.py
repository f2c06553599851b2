"""The port stands alone: nothing under src/repro_torch and nothing in
chip_smoke.py imports jax, the JAX package or the reference benches under
``benchmarks/`` (the machine with the card has no jax), and chip_smoke.py refuses to run without a card or a checkout."""
import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SOURCES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_sources_found():
    assert len(SOURCES) > 15
    assert (REPO / "src" / "repro_torch" / "kernels" / "csrc"
            / "tiled_matmul.cu").exists()


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_no_jax_or_reference_imports(path):
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    for cwd in (REPO, tmp_path):
        if cwd == tmp_path:
            shutil.copy(REPO / "chip_smoke.py", tmp_path)
        res = _run_smoke(cwd)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


def test_chip_smoke_alone_fails_even_with_torch(tmp_path):
    """Without src/repro_torch beside it the script cannot import the port;
    it must say so and exit non-zero before touching a card."""
    pytest.importorskip("torch")
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy, torch; "
         "torch.cuda.is_available = lambda: True; "
         "sys.argv = ['chip_smoke.py']; "
         "runpy.run_path('chip_smoke.py', run_name='__main__')"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "checkout" in res.stderr
    assert '"ok"' not in res.stdout

"""The harness's guards: no JAX and no JAX package in the process, a
reference that imports nothing of the program, no run without a card or
without the program, and no writes outside the checkout, HOME,
XDG_CACHE_HOME and TMPDIR."""
import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

from perfbench import bench, run as entry
from perfbench.tests.conftest import REPO

REFERENCE = REPO / "perfbench" / "reference"


def test_forbidden_modules_compare_whole_top_level_names():
    loaded = ["repro_torch", "repro_torch.models", "reprox", "jaxtyping",
              "jax", "jax.numpy", "jaxlib.xla", "flax.linen", "repro",
              "repro.models", "torch"]
    assert bench.forbidden_modules(loaded) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla", "repro",
        "repro.models"]


def test_reference_imports_nothing_of_the_program():
    for path in REFERENCE.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split(".")[0] not in ("repro_torch", "repro",
                                                  "jax", "perfbench"), \
                    (path.name, name)
    code = ("import sys; sys.path.insert(0, %r); "
            "import perfbench.reference.model; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('repro_torch', 'repro', 'jax')))"
            % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env=_env()).stdout
    assert out.strip() == "[]"


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


def _run(cwd, *args, env=None):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "stablelm-3b.train-4x4096", "--seed", str(2**31 + 3),
         "--seconds", "1", "--trace", "0", *args], cwd=cwd,
        capture_output=True, text=True, env=env or _env(), timeout=120)


def test_no_result_without_a_card():
    r = _run(REPO)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""
    code = ("import sys, time, pathlib; sys.path.insert(0, '.'); "
            "from perfbench import bench; "
            "bench.run_cell(pathlib.Path('.'), 'stablelm-3b.train-4x4096', "
            "1, 1, False, 'cpu', time.perf_counter())")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, env=_env())
    assert r.returncode != 0 and "repro_torch" in r.stderr


def test_caches_are_fixed_directories_in_the_checkout(tmp_path):
    before = dict(os.environ)
    try:
        entry.set_caches(tmp_path)
        for var, sub in entry.CACHES.items():
            assert os.environ[var] == str(tmp_path / ".bench_cache" / sub)
    finally:
        os.environ.clear()
        os.environ.update(before)


def _listing(path: pathlib.Path):
    try:
        return set(os.listdir(path))
    except OSError:
        return set()


def test_a_run_writes_only_where_it_may(tiny_root, tmp_path):
    dirs = {k: tmp_path / k for k in ("home", "cache", "tmp")}
    for d in dirs.values():
        d.mkdir()
    shared = [pathlib.Path("/tmp"), pathlib.Path("/dev/shm")]
    seen = {p: _listing(p) for p in shared}
    code = ("import sys, time, pathlib; sys.path.insert(0, '.'); "
            "sys.path.insert(0, 'src'); from perfbench import bench, run; "
            "run.set_caches(pathlib.Path('.')); "
            "r = bench.run_cell(pathlib.Path('.'), 'tiny-dense.train', 5, "
            "0.3, True, 'cpu', time.perf_counter()); "
            "print(r['correct'])")
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=tiny_root, capture_output=True,
        text=True, timeout=300,
        env=_env(HOME=str(dirs["home"]), XDG_CACHE_HOME=str(dirs["cache"]),
                 TMPDIR=str(dirs["tmp"])))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("True")
    for p in shared:
        # other processes may write there too: only names this run could
        # have made are looked for
        new = _listing(p) - seen[p]
        assert not [n for n in new if "perfbench" in n or "trace" in n
                    or n.startswith("tmp")], (p, new)


def test_result_line_keys_and_checks_last(tiny_root):
    import time
    r = bench.run_cell(tiny_root, "tiny-dense.serve", 3, 0.3, False, "cpu",
                       time.perf_counter())
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    json.dumps(r)

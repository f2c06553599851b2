"""The port's invariant linter (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``), at exact equality: these are deterministic
AST tools.

* Framework parity: both packages' suppression scanner, call graph, lock
  analysis and ``attr_reads`` over both trees (``src/repro`` and
  ``src/repro_torch``) give the same results.
* Rule parity: every fixture tree of tests/test_analysis.py and
  tests/test_analysis_dataflow.py that names no jax, run through both
  linters (``scope_all``), gives the same (path, line, code, suppressed)
  set.  The reference's tests run as written; their trees are recorded
  and handed to the port with the reference's paths and module names
  mapped to the port's (``src/repro/`` -> ``src/repro_torch/``,
  ``benchmarks/run.py`` and ``scripts/diff_bench.py`` -> the port's
  ``bench/``).
* Twins of the jax fixtures: ``jax.random`` -> torch's global generator,
  ``jnp`` -> ``torch``, ``@jax.jit`` / ``static_argnames`` ->
  ``@device_program(...)`` and its host names; the port's rule fires where
  the reference's fires on the original, and quiet twins stay quiet.
* What only the port checks: the device waits REP007 and REP009 add.
* Output and CLI: the renderers byte-equal, the CLI's exit codes, JSON
  shape, baseline, budget and rule list; the generated knob table.
"""
import dataclasses
import inspect
import json
import re
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

import repro.analysis as r_an  # noqa: E402
import repro.analysis.callgraph as r_cg  # noqa: E402
import repro.analysis.cli as r_cli  # noqa: E402
import repro.analysis.dataflow as r_df  # noqa: E402
import repro.analysis.locksets as r_ls  # noqa: E402
import repro.analysis.registry as r_reg  # noqa: E402
import repro.analysis.report as r_rep  # noqa: E402
import repro.analysis.suppressions as r_sup  # noqa: E402
import repro.core.engine as r_engine  # noqa: E402

import test_analysis  # noqa: E402
import test_analysis_dataflow  # noqa: E402

import repro_torch.analysis as t_an  # noqa: E402
import repro_torch.analysis.callgraph as t_cg  # noqa: E402
import repro_torch.analysis.cli as t_cli  # noqa: E402
import repro_torch.analysis.dataflow as t_df  # noqa: E402
import repro_torch.analysis.locksets as t_ls  # noqa: E402
import repro_torch.analysis.registry as t_reg  # noqa: E402
import repro_torch.analysis.report as t_rep  # noqa: E402
import repro_torch.analysis.suppressions as t_sup  # noqa: E402
import repro_torch.core.engine as t_engine  # noqa: E402
from repro_torch.core import envvars as t_env  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TREES = ("src/repro", "src/repro_torch")
CODES = tuple(f"REP00{i}" for i in range(10))


# -- framework parity over both trees ----------------------------------------

@pytest.fixture(scope="module")
def loaded():
    """Each tree loaded once by each package, with its call graph and lock
    analysis."""
    out = {}
    for tree in TREES:
        pair = []
        for an, cg, ls in ((r_an, r_cg, r_ls), (t_an, t_cg, t_ls)):
            project = an.Project.load(REPO, [tree])
            graph = cg.CallGraph(project)
            pair.append((project, graph, ls.LockAnalysis(project, graph)))
        out[tree] = pair
    return out


@pytest.mark.parametrize("tree", TREES)
def test_suppression_scan_parity(tree):
    files = sorted((REPO / tree).rglob("*.py"))
    assert files
    for path in files:
        text = path.read_text()
        got = {k: dataclasses.astuple(d) for k, d in t_sup.scan(text).items()}
        want = {k: dataclasses.astuple(d)
                for k, d in r_sup.scan(text).items()}
        assert got == want, path


@pytest.mark.parametrize("tree", TREES)
def test_callgraph_parity(loaded, tree):
    (_, r_graph, _), (_, t_graph, _) = loaded[tree]
    assert len(t_graph.functions) > 100
    assert set(t_graph.functions) == set(r_graph.functions)

    def edges(graph):
        return {(q, c.line, c.callee, c.bound_args)
                for q, sites in graph.calls.items() for c in sites}

    assert edges(t_graph) == edges(r_graph)
    assert t_graph.classes == r_graph.classes
    assert t_graph.attr_types == r_graph.attr_types
    assert t_graph.var_types == r_graph.var_types


@pytest.mark.parametrize("tree", TREES)
def test_lock_analysis_parity(loaded, tree):
    (r_proj, _, r_la), (t_proj, _, t_la) = loaded[tree]
    assert len(t_la.locks) == 4
    assert t_la.locks == r_la.locks
    assert t_la.conditions == r_la.conditions
    assert t_la.closures == r_la.closures
    assert t_la.order_edges() == r_la.order_edges()
    assert list(t_la.self_deadlocks()) == list(r_la.self_deadlocks())
    assert list(t_la.cycles()) == list(r_la.cycles())
    assert list(t_la.blocking_under_lock()) == \
        list(r_la.blocking_under_lock())
    assert t_ls.lock_order_edges(t_proj) == r_ls.lock_order_edges(r_proj)


@pytest.mark.parametrize("tree", TREES)
def test_attr_reads_parity(loaded, tree):
    (_, r_graph, _), (_, t_graph, _) = loaded[tree]
    qual = f"{tree[4:]}.core.engine.run_batched_ga"
    got = t_df.attr_reads(t_graph, qual, "cfg")
    assert {"population", "generations", "devices", "pipeline"} <= set(got)
    assert got == r_df.attr_reads(r_graph, qual, "cfg")


def test_the_port_lists_its_four_real_locks(loaded):
    (_, _, la) = loaded["src/repro_torch"][1]
    assert la.locks == {
        "repro_torch.core.flexion_batched._TABLE_LOCK": "lock",
        "repro_torch.core.result_cache.ResultCache._lock": "rlock",
        "repro_torch.serve.dse_service.DSEService._lock": "lock",
        "repro_torch.kernels._build._LOCK": "lock"}
    assert la.conditions == {
        "repro_torch.serve.dse_service.DSEService._wake":
            "repro_torch.serve.dse_service.DSEService._lock"}


def test_the_port_marks_the_six_device_programs(loaded):
    project = loaded["src/repro_torch"][1][0]
    got = {q: s.host_params
           for q, s in project.device_program_qualnames.items()}
    core = "repro_torch.core."
    assert got == {
        core + "cost_model.evaluate_mapping": ("hw", "hard_partition"),
        core + "cost_model.evaluate_population": ("hw", "hard_partition"),
        core + "cost_model.evaluate_rows": ("hw",),
        core + "engine._ga_program": ("n_gens", "hw", "n_elite",
                                      "objective", "with_repr"),
        core + "mapper._fixed_configs_objective": ("hw", "hard_partition",
                                                   "objective"),
        core + "flexion_batched._eval_jobs": ("backend", "device")}


def test_device_program_returns_the_function_itself():
    from repro_torch.core import cost_model, flexion_batched, mapper
    from repro_torch.device import device_program

    def f(x, n):
        return x * n

    assert device_program("n")(f) is f
    for fn in (cost_model.evaluate_mapping, cost_model.evaluate_population,
               cost_model.evaluate_rows, t_engine._ga_program,
               mapper._fixed_configs_objective, flexion_batched._eval_jobs):
        assert fn.__code__.co_name == fn.__name__
        assert not hasattr(fn, "__wrapped__")


def test_ga_key_excluded_fields_match_the_reference():
    assert set(t_engine.GA_KEY_EXCLUDED_FIELDS) == \
        set(r_engine.GA_KEY_EXCLUDED_FIELDS)
    assert all(t_engine.GA_KEY_EXCLUDED_FIELDS.values())


# -- rule parity on the reference's fixtures ----------------------------------

def _port_path(rel: str) -> str:
    if rel == "benchmarks/run.py":
        return "src/repro_torch/bench/run.py"
    if rel == "scripts/diff_bench.py":
        return "src/repro_torch/bench/diff_bench.py"
    return re.sub(r"^src/repro/", "src/repro_torch/", rel)


def _port_source(src: str) -> str:
    return re.sub(r"\brepro\.", "repro_torch.", src)


def _fixture_tests():
    """(module, name) of every reference test that builds a fixture tree
    with ``_project`` and names no jax."""
    out = []
    for mod in (test_analysis, test_analysis_dataflow):
        for name, fn in sorted(vars(mod).items()):
            if not (name.startswith("test_") and callable(fn)):
                continue
            src = inspect.getsource(fn)
            if "_project(" in src and "jax" not in src:
                out.append(pytest.param(mod, name,
                                        id=f"{mod.__name__}.{name}"))
    return out


def _findings(found):
    return {(f.path, f.line, f.code, f.suppressed) for f in found}


def _port_tree(root: Path, files: dict, kw: dict):
    for rel, src in files.items():
        p = root / _port_path(rel)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(_port_source(textwrap.dedent(src)))
    return t_an.Project.load(root, sorted(_port_path(r) for r in files),
                             **kw)


@pytest.mark.parametrize("mod,name", _fixture_tests())
def test_rule_parity_on_reference_fixtures(mod, name, tmp_path,
                                           monkeypatch):
    trees = []
    build = mod._project

    def recording(root, files, **kw):
        project = build(root, files, **kw)
        trees.append((project, files))
        return project

    monkeypatch.setattr(mod, "_project", recording)
    getattr(mod, name)(tmp_path / "ref")         # the reference test, as is
    assert trees
    for i, (ref, files) in enumerate(trees):
        want = {(_port_path(p), line, code, s)
                for p, line, code, s in _findings(r_an.analyze(ref))}
        port = _port_tree(tmp_path / "port" / str(i), files, dict(
            scope_all=ref.scope_all, registered_env=ref._registered_env))
        assert _findings(t_an.analyze(port)) == want, files


# -- twins of the jax fixtures -----------------------------------------------

def _tree(tmp_path, files, an, **kw):
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    kw.setdefault("scope_all", True)
    kw.setdefault("registered_env", set())
    return an.Project.load(tmp_path, sorted(files), **kw)


def _lines(found, code):
    return sorted((f.path, f.line) for f in found
                  if f.code == code and not f.suppressed)


#: (code, the reference's fixture, its port twin, whether it fires).  Each
#: twin keeps its original's lines, so the finding lines must agree.
TWINS = {
    "rep001_unguarded_repr_arithmetic": ("REP001", """\
        import jax
        import functools

        @functools.partial(jax.jit, static_argnames=("hw",))
        def cost(x, repr_bits, hw):
            bscale = repr_bits / 32.0
            return x * bscale
    """, """\
        import torch
        from repro_torch.device import device_program

        @device_program("hw")
        def cost(x, repr_bits, hw):
            bscale = repr_bits / 32.0
            return x * bscale
    """, True),
    "rep002_device_draw_in_core": ("REP002", """\
        import jax

        def draw(key):
            return jax.random.uniform(key, (4,))
    """, """\
        import torch

        def draw(key):
            return torch.rand(4, generator=key)
    """, True),
    "rep002_seeded_host_stream": ("REP002", """\
        import jax.numpy as jnp
        import numpy as np

        def draws(seed):
            rng = np.random.default_rng(seed)
            return jnp.asarray(rng.integers(0, 10, 4))
    """, """\
        import torch
        import numpy as np

        def draws(seed):
            rng = np.random.default_rng(seed)
            return torch.as_tensor(rng.integers(0, 10, 4))
    """, False),
    "rep004_dead_host_name": ("REP004", """\
        import functools
        import jax

        @functools.partial(jax.jit, static_argnames=("hw",))
        def f(x, n):
            return x * n
    """, """\
        import functools
        from repro_torch.device import device_program

        @device_program("hw")
        def f(x, n):
            return x * n
    """, True),
    "rep004_unhashable_host_default": ("REP004", """\
        import functools
        import jax

        @functools.partial(jax.jit, static_argnames=("opts",))
        def f(x, opts=[]):
            return x
    """, """\
        import functools
        from repro_torch.device import device_program

        @device_program("opts")
        def f(x, opts=[]):
            return x
    """, True),
    "rep004_shape_arg_unless_host": ("REP004", """\
        import functools
        import jax

        @functools.partial(jax.jit, static_argnames=("n",))
        def f(x, m, *, n=1):
            return x

        def call(x):
            return f(x, len(x), n=len(x))
    """, """\
        import functools
        from repro_torch.device import device_program

        @device_program("n")
        def f(x, m, *, n=1):
            return x

        def call(x):
            return f(x, len(x), n=len(x))
    """, True),
    "rep004_bucketed_int_wrap": ("REP004", """\
        import functools
        import jax
        import numpy as np

        @functools.partial(jax.jit, static_argnames=("hw",))
        def f(x, gens, *, hw=None):
            return x * gens

        def call(x, c):
            return f(x, np.int32(c.gens), hw=c.hw)
    """, """\
        import functools
        from repro_torch.device import device_program
        import numpy as np

        @device_program("hw")
        def f(x, gens, *, hw=None):
            return x * gens

        def call(x, c):
            return f(x, np.int32(c.gens), hw=c.hw)
    """, False),
    "rep004_call_form": ("REP004", """\
        import jax

        def f(x, m):
            return x

        g = jax.jit(f, static_argnames=("k",))
    """, """\
        from repro_torch.device import device_program

        def f(x, m):
            return x

        g = device_program("k")(f)
    """, True),
    "rep005_literal_backend_in_xp_operator": ("REP005", """\
        import numpy as np
        import jax.numpy as jnp

        def mutate(pop, rate, xp=np):
            return jnp.where(pop > rate, pop, 0)
    """, """\
        import numpy as np
        import torch

        def mutate(pop, rate, xp=np):
            return torch.where(pop > rate, pop, 0)
    """, True),
    "rep005_xp_calls_and_np_default": ("REP005", """\
        import numpy as np
        import jax.numpy as jnp

        def mutate(pop, rate, xp=np):
            return xp.where(pop > rate, pop, 0)
    """, """\
        import numpy as np
        import torch

        def mutate(pop, rate, xp=np):
            return xp.where(pop > rate, pop, 0)
    """, False),
    "rep009_traveled_len_taint": ("REP009", """\
        import jax

        @jax.jit
        def prog(x, n):
            return x * n

        def helper(data):
            return len(data)

        def driver(data, x):
            n = helper(data)        # len() two hops away
            return prog(x, n)
    """, """\
        from repro_torch.device import device_program

        @device_program()
        def prog(x, n):
            return x * n

        def helper(data):
            return len(data)

        def driver(data, x):
            n = helper(data)        # len() two hops away
            return prog(x, n)
    """, True),
    "rep009_laundered_taint": ("REP009", """\
        import jax
        import numpy as np

        @jax.jit
        def prog(x, n):
            return x * n

        def _bucket(n, base=64):
            return base

        def ok_bucketed(data, x):
            n = _bucket(len(data))
            return prog(x, n)

        def ok_wrapped(data, x):
            n = np.int32(len(data))
            return prog(x, n)
    """, """\
        from repro_torch.device import device_program
        import torch

        @device_program()
        def prog(x, n):
            return x * n

        def _bucket(n, base=64):
            return base

        def ok_bucketed(data, x):
            n = _bucket(len(data))
            return prog(x, n)

        def ok_wrapped(data, x):
            n = torch.tensor(len(data))
            return prog(x, n)
    """, False),
    "rep009_branch_across_functions": ("REP009", """\
        import jax

        def pick(v):
            if v > 0:               # traced value in Python control flow
                return v
            return -v

        @jax.jit
        def prog(x):
            return pick(x)
    """, """\
        from repro_torch.device import device_program

        def pick(v):
            if v > 0:               # tensor value in Python control flow
                return v
            return -v

        @device_program()
        def prog(x):
            return pick(x)
    """, True),
    "rep009_static_reads_and_is_none_split": ("REP009", """\
        import jax
        import jax.numpy as jnp

        def helper(q, reprs):
            h, s, d = q.shape       # shapes are static inside a trace
            assert s % 2 == 0
            if reprs is None:       # the sanctioned static split
                return q * 2
            if q.ndim == 3:
                return q
            return q * jnp.float32(h)

        @jax.jit
        def prog(q, reprs):
            return helper(q, reprs)
    """, """\
        from repro_torch.device import device_program
        import torch

        def helper(q, reprs):
            h, s, d = q.shape       # shapes are host ints
            assert s % 2 == 0
            if reprs is None:       # the sanctioned static split
                return q * 2
            if q.ndim == 3:
                return q
            return q * torch.tensor(h, dtype=q.dtype, device=q.device)

        @device_program()
        def prog(q, reprs):
            return helper(q, reprs)
    """, False),
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_port_twin_fires_where_the_reference_fires(name, tmp_path):
    code, original, twin, fires = TWINS[name]
    ref = _tree(tmp_path / "ref", {"src/repro/core/m.py": original}, r_an)
    port = _tree(tmp_path / "port", {"src/repro_torch/core/m.py": twin},
                 t_an)
    want = [(_port_path(p), line)
            for p, line in _lines(r_an.analyze(ref), code)]
    got = _lines(t_an.analyze(port), code)
    assert got == want
    assert bool(got) == fires


def test_port_twin_of_the_planted_bugs_tree(tmp_path):
    """tests/test_analysis_dataflow.py's planted-bugs tree with its jit
    program as a device program: each bug fires exactly its own rule, at
    the reference's lines."""
    program = """
        import jax

        @jax.jit
        def prog(x, n):
            return x * n

        def driver(data, x):
            n = len(data)
            return prog(x, n)
    """
    files = dict(test_analysis_dataflow.ABBA)
    files.update(test_analysis_dataflow._keyed(
        extra_field="mut_rate: float = 0.1", extra_read="* cfg.mut_rate"))
    ref_files = dict(files, **{"src/repro/core/t.py": program})
    port_files = {_port_path(k): _port_source(v) for k, v in files.items()}
    port_files["src/repro_torch/core/t.py"] = program.replace(
        "import jax", "from repro_torch.device import device_program"
    ).replace("@jax.jit", "@device_program()")
    rules = ["REP007", "REP008", "REP009"]
    want = {(_port_path(p), line, code) for p, line, code, _ in _findings(
        r_an.analyze(_tree(tmp_path / "ref", ref_files, r_an), rules))}
    got = {(p, line, code) for p, line, code, _ in _findings(
        t_an.analyze(_tree(tmp_path / "port", port_files, t_an), rules))}
    assert {c for _, _, c in got} == set(rules)
    assert got == want


# -- what only the port checks ------------------------------------------------

def _port_codes(tmp_path, src, rules):
    p = _tree(tmp_path, {"src/repro_torch/core/m.py": src}, t_an)
    return [(f.line, f.code) for f in t_an.analyze(p, rules)
            if not f.suppressed]


@pytest.mark.parametrize("read", ["v.item()", "v.tolist()", "v.cpu()",
                                  "v.numpy()", "float(v.sum())"])
def test_rep009_host_reads_of_a_device_value_fire(read, tmp_path):
    src = f"""\
        from repro_torch.device import device_program

        def best(v):
            return {read}

        @device_program("n_gens")
        def prog(pop, n_gens):
            for g in range(n_gens):
                pop = pop * 2
            return best(pop)
    """
    assert _port_codes(tmp_path, src, ["REP009"]) == [(4, "REP009")]


def test_rep009_host_metadata_and_host_params_stay_quiet(tmp_path):
    src = """\
        import torch
        from repro_torch.device import device_program

        @device_program("n_gens", "objective")
        def prog(pop, n_gens, objective):
            dev = pop.device
            zeros = torch.zeros(pop.shape[0], device=dev)
            if not isinstance(n_gens, int):
                raise TypeError(n_gens)
            for g in range(n_gens):
                pop = pop + zeros[:, None] * len(pop)
            if objective == "edp" and pop.ndim == 2:
                return pop.size(0)
            return pop
    """
    assert _port_codes(tmp_path, src, ["REP009"]) == []


@pytest.mark.parametrize("wait", ["torch.cuda.synchronize()",
                                  "self.stream.synchronize()",
                                  "self.done.synchronize()"])
def test_rep007_device_wait_under_a_lock_fires(wait, tmp_path):
    src = f"""\
        import threading
        import torch

        class Svc:
            def __init__(self):
                self._lock = threading.Lock()

            def bad(self):
                with self._lock:
                    {wait}

            def fine(self):
                with self._lock:
                    n = 1
                {wait}
    """
    got = _port_codes(tmp_path, src, ["REP007"])
    assert got == [(10, "REP007")]


def test_rep002_torch_draws_are_core_only(tmp_path):
    files = {"src/repro_torch/core/a.py": """\
        import torch

        def init(n):
            torch.manual_seed(0)
            return torch.randperm(n)
    """, "src/repro_torch/bench/b.py": """\
        import torch

        def noise(n):
            return torch.randn(n)
    """}
    p = _tree(tmp_path, files, t_an, scope_all=False)
    got = [(f.path, f.line) for f in t_an.analyze(p, ["REP002"])]
    assert got == [("src/repro_torch/core/a.py", 4),
                   ("src/repro_torch/core/a.py", 5)]


def test_rep006_reads_the_port_registry_and_accessor(tmp_path):
    files = {"src/repro_torch/core/envvars.py": """\
        REGISTRY = ()
    """, "src/repro_torch/core/knob.py": """\
        from .envvars import get_env

        def knob():
            return get_env("REPRO_NOT_A_REAL_KNOB")
    """}
    p = _tree(tmp_path, files, t_an, scope_all=False, registered_env=None)
    got = [(f.path, f.line, f.code) for f in t_an.analyze(p, ["REP006"])]
    assert got == [("src/repro_torch/core/knob.py", 4, "REP006")]


# -- output and CLI ----------------------------------------------------------

def _both(cls_a, cls_b, rows):
    return [cls_a(*r) for r in rows], [cls_b(*r) for r in rows]


@pytest.mark.parametrize("fmt", ["text", "json", "github"])
def test_renderers_byte_equal(fmt):
    rows = [("a/b.py", 3, "REP002", "legacy draw: x, y%", False),
            ("a/b.py", 9, "REP009", "line\nbreak", True),
            ("c.py", 1, "REP000", "no why", False)]
    r_f, t_f = _both(r_reg.Finding, t_reg.Finding, rows)
    r_render = getattr(r_rep, f"render_{fmt}")
    t_render = getattr(t_rep, f"render_{fmt}")
    for elapsed in (None, 1.23456):
        assert t_render(t_f, 7, elapsed_s=elapsed) == \
            r_render(r_f, 7, elapsed_s=elapsed)
    assert t_render([], 0) == r_render([], 0)


def _write_tree(tmp_path, name, text):
    (tmp_path / "pyproject.toml").write_text("[project]\nname='x'\n")
    (tmp_path / name).write_text(text)


DIRTY = "import os\nV = os.environ.get('REPRO_NOT_A_REAL_KNOB')\n"


def test_cli_exit_zero_and_json_shape_on_clean_tree(tmp_path, capsys):
    _write_tree(tmp_path, "clean.py", "def f():\n    return 1\n")
    rc = t_cli.main(["--root", str(tmp_path), "--format", "json",
                     "clean.py"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert doc["ok"] is True and doc["unsuppressed"] == 0
    assert doc["files_scanned"] == 1
    assert set(doc) >= {"version", "files_scanned", "findings",
                        "unsuppressed", "suppressed", "counts", "ok"}


def test_cli_exit_one_and_finding_fields_on_dirty_tree(tmp_path, capsys):
    _write_tree(tmp_path, "dirty.py", DIRTY)
    rc = t_cli.main(["--root", str(tmp_path), "--format", "json",
                     "dirty.py"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert doc["ok"] is False and doc["unsuppressed"] == 1
    f = doc["findings"][0]
    assert set(f) == {"path", "line", "code", "message", "suppressed"}
    assert f["code"] == "REP006" and f["path"] == "dirty.py"


def test_cli_json_equals_the_reference_on_the_same_tree(tmp_path, capsys):
    """Same findings, same document (less the wall clock)."""
    _write_tree(tmp_path, "hygiene.py",
                "x = 1  # repro: disable=REP001\n"
                "y = 2  # repro: disable=REP999 -- typo'd code\n")
    docs = []
    for main in (r_cli.main, t_cli.main):
        assert main(["--root", str(tmp_path), "--format", "json",
                     "hygiene.py"]) == 1
        doc = json.loads(capsys.readouterr().out)
        doc.pop("elapsed_s")
        docs.append(doc)
    assert docs[0] == docs[1] and docs[1]["counts"] == {"REP000": 2}


def test_cli_list_rules_covers_all_codes(capsys):
    assert t_cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert [line.split()[0] for line in out.splitlines()] == list(CODES)
    assert [r.code for r in t_an.all_rules()] == list(CODES)
    assert [(r.code, r.name) for r in t_an.all_rules()] == \
        [(r.code, r.name) for r in r_an.all_rules()]


def test_cli_bad_usage_exits_two():
    with pytest.raises(SystemExit) as e:
        t_cli.main(["--format", "yaml"])
    assert e.value.code == 2


def test_cli_github_format_renders_workflow_commands(tmp_path, capsys):
    _write_tree(tmp_path, "dirty.py", DIRTY)
    rc = t_cli.main(["--root", str(tmp_path), "--format", "github",
                     "dirty.py"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "::error file=dirty.py,line=2,title=REP006::" in out


def test_cli_baseline_roundtrip_demotes_known_findings(tmp_path, capsys):
    _write_tree(tmp_path, "dirty.py", DIRTY)
    base = tmp_path / "lint-baseline.json"
    assert t_cli.main(["--root", str(tmp_path), "--write-baseline",
                       str(base), "dirty.py"]) == 0
    doc = json.loads(base.read_text())
    assert doc["version"] == 1 and len(doc["entries"]) == 1
    capsys.readouterr()
    rc = t_cli.main(["--root", str(tmp_path), "--format", "json",
                     "--baseline", str(base), "dirty.py"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert out["unsuppressed"] == 0 and out["suppressed"] == 1
    (tmp_path / "dirty.py").write_text(
        DIRTY + "W = os.environ.get('REPRO_ALSO_NOT_REAL')\n")
    rc = t_cli.main(["--root", str(tmp_path), "--format", "json",
                     "--baseline", str(base), "dirty.py"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert out["unsuppressed"] == 1 and out["suppressed"] == 1


def test_cli_missing_baseline_is_usage_error(tmp_path):
    _write_tree(tmp_path, "dirty.py", DIRTY)
    with pytest.raises(SystemExit) as e:
        t_cli.main(["--root", str(tmp_path),
                    "--baseline", str(tmp_path / "nope.json"), "dirty.py"])
    assert e.value.code == 2


def test_cli_budget_and_elapsed_in_summary(tmp_path, capsys):
    _write_tree(tmp_path, "clean.py", "def f():\n    return 1\n")
    rc = t_cli.main(["--root", str(tmp_path), "clean.py"])
    out = capsys.readouterr().out
    assert rc == 0
    assert re.search(r"in \d+\.\d\ds", out)
    rc = t_cli.main(["--root", str(tmp_path), "--budget-seconds", "0",
                     "clean.py"])
    err = capsys.readouterr().err
    assert rc == 1
    assert "lint budget exceeded" in err


def test_cli_default_scan_set_is_the_port(tmp_path, capsys):
    _write_tree(tmp_path, "outside.py", DIRTY)
    pkg = tmp_path / "src" / "repro_torch"
    pkg.mkdir(parents=True)
    (pkg / "inside.py").write_text(DIRTY)
    rc = t_cli.main(["--root", str(tmp_path), "--format", "json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1 and doc["files_scanned"] == 1
    assert [f["path"] for f in doc["findings"]] == [
        "src/repro_torch/inside.py"]


# -- the knob table -----------------------------------------------------------

def test_envvars_torch_docs_table_in_sync():
    """docs/envvars_torch.md is generated from the port's registry;
    regenerate with
    `PYTHONPATH=src python -m repro_torch.core.envvars > docs/envvars_torch.md`.
    """
    want = t_env.render_table()
    got = (REPO / "docs" / "envvars_torch.md").read_text()
    assert got == want, "docs/envvars_torch.md drifted from the registry"
    for v in t_env.REGISTRY:
        assert f"`{v.name}`" in got

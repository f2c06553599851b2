"""The port's invariant rules (REP000–REP009).

Each rule encodes a correctness discipline the JAX package shipped a bug
against (or nearly did), in the form it takes in the port — see
docs/analysis.md for the incident behind each code and
docs/analysis_torch.md for what the port checks.  Rules are deliberately narrow: they check the mechanical shadow of a
discipline (names, guards, call shapes), not the discipline itself, so every
message says what invariant is at stake and what the compliant pattern is.

Scopes are repo-relative path sets; ``Project(scope_all=True)`` (used by the
fixture tests) widens every scope to the whole file set so rules can be
exercised on synthetic trees.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from . import dataflow as df
from .callgraph import get_callgraph
from .locksets import LockAnalysis
from .registry import Finding, known_codes, rule
from .walker import (FunctionNode, Project, SourceFile,
                     iter_device_program_sites)

# --------------------------------------------------------------------------
# REP000 — suppression hygiene
# --------------------------------------------------------------------------

@rule("REP000", "suppression-hygiene",
      "every suppression names known codes and carries a justification")
def check_suppressions(project: Project) -> Iterator[Finding]:
    codes = known_codes()
    for sf in project.files:
        for d in sf.directives.values():
            if d.justification is None:
                yield Finding(
                    sf.rel, d.line, "REP000",
                    "suppression has no justification — write "
                    "'# repro: disable=REPxxx -- <why this is safe>'")
            for c in d.codes:
                if c not in codes:
                    yield Finding(
                        sf.rel, d.line, "REP000",
                        f"suppression names unknown code {c!r} "
                        f"(it silences nothing)")


# --------------------------------------------------------------------------
# REP001 — parity purity (the `* bscale` FMA-refusion ULP hazard)
# --------------------------------------------------------------------------

REP001_SCOPE = {
    "src/repro_torch/core/engine.py",
    "src/repro_torch/core/ga_ops.py",
    "src/repro_torch/core/cost_model.py",
    "src/repro_torch/core/mapper.py",
}
#: values carrying the representation (R) axis scale through the cost graph
REPR_NAMES = {"reprs", "repr_bits", "bscale", "mscale"}
#: host-side booleans that select the pre-R vs width-scaled program
GUARD_FLAGS = {"with_repr", "r_live"}


def _is_none_const(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value is None


def _has_repr_guard(fn: ast.AST) -> bool:
    """Does ``fn`` (including nested defs) contain the static split —
    ``if with_repr:`` / ``x if r_live else None`` / ``if reprs is None:`` —
    that keeps R-pinned rows on the exact pre-R cost program?"""
    for node in ast.walk(fn):
        if not isinstance(node, (ast.If, ast.IfExp)):
            continue
        t = node.test
        if isinstance(t, ast.UnaryOp):
            t = t.operand
        if isinstance(t, ast.Name) and t.id in GUARD_FLAGS:
            return True
        if (isinstance(t, ast.Compare) and len(t.ops) == 1
                and isinstance(t.ops[0], (ast.Is, ast.IsNot))
                and isinstance(t.left, ast.Name)
                and t.left.id in REPR_NAMES
                and _is_none_const(t.comparators[0])):
            return True
    return False


@rule("REP001", "parity-purity",
      "repr-scale arithmetic in the cost path must sit behind the "
      "with_repr/is-None static split")
def check_parity_purity(project: Project) -> Iterator[Finding]:
    guard_cache: Dict[ast.AST, bool] = {}
    for sf in project.files:
        if not (project.scope_all or sf.rel in REP001_SCOPE):
            continue
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Name) and node.id in REPR_NAMES
                    and isinstance(node.ctx, ast.Load)):
                continue
            parent = sf.parent(node)
            is_arith = isinstance(parent, (ast.BinOp, ast.UnaryOp,
                                           ast.Compare))
            is_index = (isinstance(parent, ast.Subscript)
                        and parent.value is node
                        and isinstance(parent.ctx, ast.Load))
            if not (is_arith or is_index):
                continue
            chain = sf.enclosing_functions(node)
            if not chain:
                continue            # module level: host-side, never traced
            guarded = False
            for fn in chain:
                if fn not in guard_cache:
                    guard_cache[fn] = _has_repr_guard(fn)
                if guard_cache[fn]:
                    guarded = True
                    break
            if not guarded:
                yield Finding(
                    sf.rel, node.lineno, "REP001",
                    f"arithmetic on repr-scale value {node.id!r} with no "
                    f"with_repr/is-None static split in the enclosing "
                    f"function — an unconditional scale op (even * 1.0) "
                    f"refuses FMAs and shifts R-pinned rows off the golden "
                    f"pre-R XLA program by 1 ULP")


# --------------------------------------------------------------------------
# REP002 — RNG discipline (byte-identical host draw streams)
# --------------------------------------------------------------------------

REP002_PREFIXES = ("src/repro_torch/core/", "src/repro_torch/bench/",
                   "src/repro_torch/examples/")
REP002_TORCH_SCOPE = "src/repro_torch/core/"
#: numpy.random attributes that are NOT legacy global-state draws
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "BitGenerator",
                 "PCG64", "Philox", "MT19937", "SFC64"}
#: draws from (or reseeds of) torch's global generator
_TORCH_DRAWS = {f"torch.{n}" for n in (
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "normal", "bernoulli", "multinomial", "manual_seed")}


@rule("REP002", "rng-discipline",
      "mapper/engine/GA paths draw only from seeded generators fed by the "
      "ga_ops shared streams")
def check_rng(project: Project) -> Iterator[Finding]:
    for sf in project.files:
        in_scope = (project.scope_all
                    or sf.rel.startswith(REP002_PREFIXES))
        if not in_scope:
            continue
        torch_scope = (project.scope_all
                       or sf.rel.startswith(REP002_TORCH_SCOPE))
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            d = sf.dotted(node.func)
            if d is None:
                continue
            if d.startswith("numpy.random."):
                tail = d.split(".", 2)[2]
                if tail not in _NP_RANDOM_OK:
                    yield Finding(
                        sf.rel, node.lineno, "REP002",
                        f"legacy global-state draw numpy.random.{tail} — "
                        f"draw order is process-global, so any reordering "
                        f"silently breaks serial<->batched golden parity; "
                        f"use a seeded np.random.default_rng fed by "
                        f"ga_ops.draw_run")
                elif (tail == "default_rng" and not node.args
                        and not node.keywords):
                    yield Finding(
                        sf.rel, node.lineno, "REP002",
                        "default_rng() with no seed draws fresh OS entropy "
                        "— results are unreproducible; thread the row seed "
                        "(ga_ops draw streams) or an explicit constant")
            elif torch_scope and d in _TORCH_DRAWS:
                yield Finding(
                    sf.rel, node.lineno, "REP002",
                    f"draw {d} from torch's global generator in a "
                    f"mapper/GA path — the golden streams are host numpy; "
                    f"route draws through ga_ops.draw_run")


# --------------------------------------------------------------------------
# REP003 — lock discipline under the DSE service dispatcher
# --------------------------------------------------------------------------

_MUTATORS = {"append", "add", "update", "setdefault", "pop", "popitem",
             "clear", "extend", "insert", "remove", "discard",
             "appendleft", "extendleft"}
_CONTAINER_CTORS = {"dict", "list", "set", "collections.OrderedDict",
                    "collections.defaultdict", "collections.deque",
                    "OrderedDict", "defaultdict", "deque"}


def _module_bindings(sf: SourceFile) -> Tuple[Set[str], Set[str]]:
    """(container names, all names) bound by module-level assignments.
    Bindings whose initializer is self-locking (``ResultCache``, ``Lock``,
    ``RLock``...) are excluded from the container set."""
    containers: Set[str] = set()
    all_names: Set[str] = set()
    for stmt in sf.tree.body:
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        else:
            continue
        for t in targets:
            if not isinstance(t, ast.Name):
                continue
            all_names.add(t.id)
            if isinstance(value, (ast.Dict, ast.List, ast.Set,
                                  ast.DictComp, ast.ListComp, ast.SetComp)):
                containers.add(t.id)
            elif (isinstance(value, ast.Call)
                    and sf.dotted(value.func) in _CONTAINER_CTORS):
                containers.add(t.id)
    return containers, all_names


@rule("REP003", "lock-discipline",
      "serve-reachable module state mutates only under a lock "
      "(or a self-locking ResultCache/_locked_memo)")
def check_locks(project: Project) -> Iterator[Finding]:
    reachable = None if project.scope_all else project.serve_reachable
    for sf in project.files:
        if reachable is not None and sf.rel not in reachable:
            continue
        containers, module_names = _module_bindings(sf)

        # (a) `global X` rebinding outside a lock
        for fn in sf.functions():
            declared = {n for stmt in ast.walk(fn)
                        if isinstance(stmt, ast.Global)
                        for n in stmt.names if n in module_names}
            if not declared:
                continue
            for stmt in ast.walk(fn):
                target = None
                if isinstance(stmt, ast.Assign):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name) and t.id in declared:
                            target = t.id
                elif (isinstance(stmt, ast.AugAssign)
                        and isinstance(stmt.target, ast.Name)
                        and stmt.target.id in declared):
                    target = stmt.target.id
                if target and not sf.under_lock(stmt):
                    yield Finding(
                        sf.rel, stmt.lineno, "REP003",
                        f"module global {target!r} rebound without holding "
                        f"a lock — serve/ threads share this module; "
                        f"check-then-set races lose writes (guard with a "
                        f"module lock or use ResultCache)")

        # (b) mutation of module-level containers outside a lock
        for node in ast.walk(sf.tree):
            name = None
            if (isinstance(node, ast.Subscript)
                    and isinstance(node.ctx, (ast.Store, ast.Del))
                    and isinstance(node.value, ast.Name)
                    and node.value.id in containers):
                name = node.value.id
            elif (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _MUTATORS
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in containers):
                name = node.func.value.id
            if name is None:
                continue
            if not sf.enclosing_functions(node):
                continue            # import-time init is single-threaded
            if not sf.under_lock(node):
                yield Finding(
                    sf.rel, node.lineno, "REP003",
                    f"module-level container {name!r} mutated without "
                    f"holding a lock in a serve-reachable module — wrap "
                    f"in `with <lock>:` or move to a ResultCache")

        # (c) bare lru_cache on a function somebody cache_clear()s
        for fn in sf.functions():
            for dec in fn.decorator_list:
                base = dec.func if isinstance(dec, ast.Call) else dec
                if sf.dotted(base) not in ("functools.lru_cache",
                                           "lru_cache"):
                    continue
                if fn.name in project.cache_clear_names:
                    yield Finding(
                        sf.rel, dec.lineno, "REP003",
                        f"bare functools.lru_cache on {fn.name!r}, which "
                        f"is cache_clear()'d at runtime — clearing races "
                        f"concurrent fills; use _locked_memo "
                        f"(flexion_batched) or a ResultCache")


# --------------------------------------------------------------------------
# REP004 — host/tensor hygiene at device programs
# --------------------------------------------------------------------------

def _fn_params(fn: ast.AST) -> List[str]:
    a = fn.args
    return [p.arg for p in
            list(getattr(a, "posonlyargs", [])) + a.args + a.kwonlyargs]


def _host_params(site) -> Set[str]:
    return set(site.host_params or ()) & set(_fn_params(site.fn))


def _defaults_by_param(fn: ast.AST) -> Dict[str, ast.expr]:
    a = fn.args
    pos = list(getattr(a, "posonlyargs", [])) + a.args
    out: Dict[str, ast.expr] = {}
    for p, d in zip(pos[len(pos) - len(a.defaults):], a.defaults):
        out[p.arg] = d
    for p, d in zip(a.kwonlyargs, a.kw_defaults):
        if d is not None:
            out[p.arg] = d
    return out


def _is_unhashable_literal(sf: SourceFile, node: ast.expr) -> bool:
    if isinstance(node, (ast.Dict, ast.List, ast.Set,
                         ast.DictComp, ast.ListComp, ast.SetComp)):
        return True
    return (isinstance(node, ast.Call)
            and sf.dotted(node.func) in ("dict", "list", "set"))


def _shape_dependent(sf: SourceFile, node: ast.expr) -> Optional[str]:
    """A human-readable tag when ``node`` is a Python-int-from-shape
    expression (``len(x)``, ``x.shape``, ``x.shape[0]``)."""
    if isinstance(node, ast.Call) and sf.dotted(node.func) == "len":
        return "len(...)"
    if isinstance(node, ast.Attribute) and node.attr == "shape":
        return ".shape"
    if (isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Attribute)
            and node.value.attr == "shape"):
        return ".shape[...]"
    return None


@rule("REP004", "retrace-hygiene",
      "device-program host declarations name real params, host defaults "
      "are hashable, and shape-dependent args are bucketed")
def check_retrace(project: Project) -> Iterator[Finding]:
    for sf in project.files:
        local_programs: Dict[str, object] = {}
        for site in iter_device_program_sites(sf):
            params = _fn_params(site.fn)
            local_programs[site.fn.name] = site
            for name in site.host_params or ():
                if name not in params:
                    yield Finding(
                        sf.rel, site.decl_node.lineno, "REP004",
                        f"device_program host entry {name!r} names no "
                        f"parameter of {site.fn.name!r} — the declaration "
                        f"is dead and the real arg is taken for a tensor")
            defaults = _defaults_by_param(site.fn)
            for p in sorted(_host_params(site)):
                d = defaults.get(p)
                if d is not None and _is_unhashable_literal(sf, d):
                    yield Finding(
                        sf.rel, d.lineno, "REP004",
                        f"host parameter {p!r} of {site.fn.name!r} has "
                        f"an unhashable default — one mutable object is "
                        f"shared by every call; use a tuple or None "
                        f"sentinel")

        # call sites of known device programs (this file or cross-module)
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            d = sf.dotted(node.func)
            site = None
            if d is not None:
                site = project.device_program_qualnames.get(d)
                if site is None and sf.module and "." not in d:
                    site = project.device_program_qualnames.get(
                        f"{sf.module}.{d}")
                if site is None and "." not in (d or ""):
                    site = local_programs.get(d)
            if site is None:
                continue
            hosts = _host_params(site)
            for kw in node.keywords:
                if kw.arg in hosts:
                    continue
                tag = _shape_dependent(sf, kw.value)
                if tag:
                    yield Finding(
                        sf.rel, kw.value.lineno, "REP004",
                        f"shape-dependent Python value ({tag}) passed to "
                        f"device program {site.fn.name!r} as tensor arg "
                        f"{kw.arg!r} — a per-size host value where the "
                        f"program takes a tensor; bucket it (_bucket) or "
                        f"declare it a host parameter")
            a = site.fn.args
            pos = [p.arg for p in list(getattr(a, "posonlyargs", [])) + a.args]
            for i, arg in enumerate(node.args):
                if i < len(pos) and pos[i] in hosts:
                    continue
                tag = _shape_dependent(sf, arg)
                if tag:
                    yield Finding(
                        sf.rel, arg.lineno, "REP004",
                        f"shape-dependent Python value ({tag}) passed to "
                        f"device program {site.fn.name!r} — a per-size "
                        f"host value where the program takes a tensor; "
                        f"bucket it (_bucket), wrap as a tensor, or "
                        f"declare it a host parameter")


# --------------------------------------------------------------------------
# REP005 — xp-genericity of GA operators
# --------------------------------------------------------------------------

REP005_SCOPE = {
    "src/repro_torch/core/ga_ops.py",
    "src/repro_torch/core/flexion_batched.py",
}


@rule("REP005", "xp-genericity",
      "functions taking an `xp` backend use only xp.*, never literal "
      "np./torch.")
def check_xp_generic(project: Project) -> Iterator[Finding]:
    for sf in project.files:
        if not (project.scope_all or sf.rel in REP005_SCOPE):
            continue
        for fn in sf.functions():
            if "xp" not in _fn_params(fn):
                continue
            skip: Set[ast.AST] = set()
            a = fn.args
            for d in list(a.defaults) + [x for x in a.kw_defaults if x]:
                skip.update(ast.walk(d))
            for node in ast.walk(fn):
                if node in skip or not isinstance(node, ast.Name):
                    continue
                if not isinstance(node.ctx, ast.Load):
                    continue
                if sf.aliases.get(node.id) in ("numpy", "torch"):
                    yield Finding(
                        sf.rel, node.lineno, "REP005",
                        f"literal {node.id}. call inside xp-generic "
                        f"{fn.name!r} — this operator runs on both "
                        f"backends (serial numpy / batched torch, "
                        f"ga_ops.TORCH) and a hard-wired backend breaks "
                        f"golden parity; use xp.")


# --------------------------------------------------------------------------
# REP006 — env / schema registry
# --------------------------------------------------------------------------

def _env_literal(node: ast.expr) -> Optional[str]:
    if (isinstance(node, ast.Constant) and isinstance(node.value, str)
            and node.value.startswith("REPRO_")):
        return node.value
    return None


def iter_env_refs(sf: SourceFile) -> Iterator[Tuple[int, str]]:
    """(line, var) for every literal ``REPRO_*`` reference through
    ``os.environ`` / ``os.getenv`` in the file."""
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call):
            f = sf.dotted(node.func)
            if f in ("os.environ.get", "os.environ.pop",
                     "os.environ.setdefault", "os.getenv",
                     "repro_torch.core.envvars.get_env"):
                if node.args:
                    v = _env_literal(node.args[0])
                    if v:
                        yield node.lineno, v
        elif isinstance(node, ast.Subscript):
            if sf.dotted(node.value) == "os.environ":
                sl = node.slice
                v = _env_literal(sl)
                if v:
                    yield node.lineno, v
        elif isinstance(node, ast.Compare):
            if (len(node.ops) == 1 and isinstance(node.ops[0], (ast.In,
                                                                ast.NotIn))
                    and sf.dotted(node.comparators[0]) == "os.environ"):
                v = _env_literal(node.left)
                if v:
                    yield node.lineno, v


def _module_literal(sf: SourceFile, name: str):
    """ast.literal_eval of a module-level ``NAME = <literal>`` assignment,
    or None."""
    for stmt in sf.tree.body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and stmt.targets[0].id == name):
            try:
                return ast.literal_eval(stmt.value), stmt.lineno
            except ValueError:
                return None
    return None


def parity_coverage_gaps(parity_benches, required_keys) -> List[str]:
    """Parity benches with no (or an empty) REQUIRED_KEYS entry — the
    benches whose derived metrics could silently vanish from a fresh
    artifact without failing the diff gate."""
    return [b for b in sorted(parity_benches)
            if not required_keys.get(b)]


@rule("REP006", "env-schema-registry",
      "every REPRO_* env read is registered; every parity bench has "
      "REQUIRED_KEYS coverage")
def check_registry(project: Project) -> Iterator[Finding]:
    registered = project.registered_env
    for sf in project.files:
        if sf.rel == "src/repro_torch/core/envvars.py":
            continue                 # the registry itself
        for line, var in iter_env_refs(sf):
            if var not in registered:
                yield Finding(
                    sf.rel, line, "REP006",
                    f"env var {var!r} referenced but not registered in "
                    f"repro_torch.core.envvars.REGISTRY — unregistered "
                    f"knobs fall out of docs/envvars_torch.md and silently "
                    f"change behavior between machines")

    run_sf = project.by_rel("src/repro_torch/bench/run.py")
    diff_sf = project.by_rel("src/repro_torch/bench/diff_bench.py")
    if run_sf is None or diff_sf is None:
        return
    parity = _module_literal(run_sf, "PARITY_BENCHES")
    required = _module_literal(diff_sf, "REQUIRED_KEYS")
    if parity is None or required is None:
        return
    req_val, req_line = required
    for bench in parity_coverage_gaps(parity[0], req_val):
        yield Finding(
            diff_sf.rel, req_line, "REP006",
            f"parity bench {bench!r} has no REQUIRED_KEYS entry — its "
            f"derived metrics could be dropped from a fresh artifact "
            f"without failing repro_torch.bench.diff_bench")


# --------------------------------------------------------------------------
# REP007 — lock order (interprocedural; the DSE service's lock set)
# --------------------------------------------------------------------------

@rule("REP007", "lock-order",
      "no acquisition-order cycles, self-deadlocks, or blocking calls "
      "while holding a lock (interprocedural)")
def check_lock_order(project: Project) -> Iterator[Finding]:
    analysis = LockAnalysis(project, get_callgraph(project))
    for rel, line, msg in analysis.self_deadlocks():
        yield Finding(rel, line, "REP007", msg)
    for cycle, witnesses in analysis.cycles():
        if not witnesses:
            continue
        rel, line, _ = witnesses[0]
        chain = " -> ".join(cycle + (cycle[0],))
        ws = "; ".join(f"{r}:{ln} {how}" for r, ln, how in witnesses)
        yield Finding(
            rel, line, "REP007",
            f"lock acquisition-order cycle {chain} — two threads taking "
            f"the locks in opposite order deadlock; pick one global order "
            f"(witnesses: {ws})")
    for rel, line, msg in analysis.blocking_under_lock():
        yield Finding(rel, line, "REP007", msg)


# --------------------------------------------------------------------------
# REP008 — cache-key completeness (stale-cache wrong answers)
# --------------------------------------------------------------------------

#: the module-level dict naming GAConfig fields deliberately NOT in
#: ga_params_key, each with its justification — lives next to ga_params_key
EXCLUDED_FIELDS_NAME = "GA_KEY_EXCLUDED_FIELDS"


def _first_param(fn: ast.AST) -> Optional[str]:
    a = fn.args
    pos = list(getattr(a, "posonlyargs", [])) + a.args
    return pos[0].arg if pos else None


def _direct_attr_reads(fn: ast.AST, param: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for node in ast.walk(fn):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == param):
            out.setdefault(node.attr, node.lineno)
    return out


@rule("REP008", "cache-key-completeness",
      "every result-affecting GAConfig field is folded into ga_params_key "
      "or explicitly excluded with a justification")
def check_cache_key(project: Project) -> Iterator[Finding]:
    graph = get_callgraph(project)

    key_fns = graph.find_by_name("ga_params_key")
    run_fns = graph.find_by_name("run_batched_ga")
    cfg_classes = [(sf, node) for sf in project.files
                   for node in ast.walk(sf.tree)
                   if isinstance(node, ast.ClassDef)
                   and node.name == "GAConfig"]
    if not key_fns or not run_fns or not cfg_classes:
        return                       # anchors absent: nothing to compare
    key_fn = key_fns[0]
    run_fn = run_fns[0]
    cfg_sf, cfg_cls = cfg_classes[0]

    fields = df.dataclass_fields(cfg_cls)
    key_param = _first_param(key_fn.node)
    keyed = set(_direct_attr_reads(key_fn.node, key_param)) \
        if key_param else set()
    excluded = df.dict_literal_keys(key_fn.sf, EXCLUDED_FIELDS_NAME) or {}

    reads: Dict[str, Tuple[str, int]] = {}
    if "cfg" in run_fn.params:
        reads = df.attr_reads(graph, run_fn.qualname, "cfg")

    for f, def_line in sorted(fields.items()):
        in_key = f in keyed
        in_excl = f in excluded
        if in_key and in_excl:
            yield Finding(
                key_fn.sf.rel, excluded[f], "REP008",
                f"GAConfig field {f!r} is both folded into ga_params_key "
                f"and listed in {EXCLUDED_FIELDS_NAME} — the exclusion "
                f"list must name only fields the key omits")
            continue
        if in_key or in_excl:
            continue
        if f in reads:
            rel, line = reads[f]
            yield Finding(
                rel, line, "REP008",
                f"GAConfig field {f!r} is read on run_batched_ga's "
                f"dispatch path but folded into neither ga_params_key nor "
                f"{EXCLUDED_FIELDS_NAME} — two configs differing only in "
                f"{f!r} share a cache key, so the second gets the first's "
                f"STALE result; add it to the key or classify it as a "
                f"placement knob")
        else:
            yield Finding(
                cfg_sf.rel, def_line, "REP008",
                f"GAConfig field {f!r} is in neither ga_params_key nor "
                f"{EXCLUDED_FIELDS_NAME} — every field must be classified "
                f"when added (key member if it can affect results, or an "
                f"entry in {EXCLUDED_FIELDS_NAME} with a justification) "
                f"so the row cache can never serve stale results")

    # every wave-group key must fold the GA params in
    for gk in graph.find_by_name("group_key"):
        calls_key = any(
            cs.callee == key_fn.qualname
            or (isinstance(cs.node.func, ast.Name)
                and cs.node.func.id == "ga_params_key")
            for cs in graph.calls.get(gk.qualname, ()))
        if not calls_key:
            yield Finding(
                gk.sf.rel, gk.node.lineno, "REP008",
                "group_key does not fold ga_params_key(cfg) in — queries "
                "with different GA parameters would share one engine wave "
                "group and cross-contaminate rows; include "
                "ga_params_key(self.cfg) in the tuple")


# --------------------------------------------------------------------------
# REP009 — device-value escape (dataflow upgrade of REP004)
# --------------------------------------------------------------------------

@rule("REP009", "traced-value-escape",
      "len()/.shape-derived ints must not travel into device-program "
      "tensor args, and device values must not be read on the host")
def check_traced_escape(project: Project) -> Iterator[Finding]:
    taint = df.ShapeTaint(project, get_callgraph(project))
    for rel, line, msg in taint.host_to_device_findings():
        yield Finding(rel, line, "REP009", msg)
    for rel, line, msg in taint.device_escape_findings():
        yield Finding(rel, line, "REP009", msg)

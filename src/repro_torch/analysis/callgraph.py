"""Project-wide call graph for the interprocedural rules (REP007–REP009).

The per-function rules (REP001–REP006) are pattern matches; the hazards
behind REP007–REP009 — a lock taken in opposite orders by two threads, a
cache key that misses a field read two calls down, a device value read on
the host inside a helper — are *cross-function* properties.  This module
builds the shared substrate the flow-based rules stand on: every
function/method in the scanned tree indexed by a stable qualname, and every
call site resolved to its callee where stdlib-``ast`` facts allow.

Resolution is deliberately a conservative approximation (no imports, no
type inference beyond what one pass over the AST yields):

  * **dotted names** — alias-expanded via :meth:`SourceFile.dotted`, so
    ``from repro_torch.core import engine as eng; eng.run_batched_ga(...)``
    and ``from ..core.engine import run_batched_ga`` both resolve to
    ``repro_torch.core.engine.run_batched_ga``;
  * **local / nested defs** — a bare-name call searches enclosing function
    scopes innermost-first, then the module top level;
  * **methods** — ``self.m(...)`` resolves within the enclosing class;
    ``obj.m(...)`` resolves when ``obj`` has a known project class (a
    ``self.x = Cls(...)`` / module-level ``X = Cls(...)`` binding — the
    ``DSEService.cache`` → ``ResultCache`` pattern), else by unique method
    name across the project (common container/threading method names are
    excluded from that fallback: a ``.get`` could be any dict);
  * **functools.partial** — ``partial(f, ...)(...)`` and
    ``g = partial(f, ...); g(...)`` both resolve to ``f`` with the bound
    positional count recorded, so argument→parameter mapping stays right;
  * **constructors** — ``Cls(...)`` resolves to ``Cls.__init__``.

Unresolved calls stay in the graph as :class:`CallSite` with
``callee=None`` — the lockset analysis still sees them (they can't acquire
project locks, but they can block).
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from .walker import FunctionNode, Project, SourceFile

#: method names too generic for the unique-name fallback — resolving a bare
#: ``x.get(...)`` to the one project class that defines ``get`` would be a
#: guess about ``x``'s type that dict/list/queue/threading objects break.
_AMBIGUOUS_METHOD_NAMES = frozenset({
    "get", "put", "pop", "update", "clear", "append", "add", "extend",
    "insert", "remove", "discard", "setdefault", "popitem", "keys",
    "values", "items", "copy", "join", "wait", "acquire", "release",
    "start", "close", "run", "read", "write", "open", "send", "submit",
    "sort", "index", "count", "split", "strip", "format", "mean", "sum",
    "astype", "reshape", "result", "done", "set", "notify", "notify_all",
})


@dataclasses.dataclass
class FunctionInfo:
    """One function/method definition with its location facts."""

    qualname: str
    sf: SourceFile
    node: ast.AST                     # FunctionDef / AsyncFunctionDef
    cls: Optional[str] = None         # enclosing class name, if a method
    is_method: bool = False

    @property
    def params(self) -> List[str]:
        a = self.node.args
        return [p.arg for p in
                list(getattr(a, "posonlyargs", [])) + a.args + a.kwonlyargs]

    @property
    def positional(self) -> List[str]:
        a = self.node.args
        return [p.arg for p in
                list(getattr(a, "posonlyargs", [])) + a.args]


@dataclasses.dataclass
class CallSite:
    """One call expression inside ``caller``; ``callee`` is the resolved
    project qualname or None.  ``bound_args`` counts positionals already
    consumed (``self`` of a method call, ``functools.partial`` bindings)."""

    caller: str
    node: ast.Call
    callee: Optional[str]
    line: int
    bound_args: int = 0

    def arg_bindings(self, info: FunctionInfo
                     ) -> List[Tuple[str, ast.expr]]:
        """(callee param name, caller arg expression) pairs for the
        resolvable arguments of this call (starred args are skipped)."""
        pos = info.positional
        offset = self.bound_args + (1 if info.is_method else 0)
        out: List[Tuple[str, ast.expr]] = []
        for i, arg in enumerate(self.node.args):
            if isinstance(arg, ast.Starred):
                break
            j = offset + i
            if j < len(pos):
                out.append((pos[j], arg))
        params = set(info.params)
        for kw in self.node.keywords:
            if kw.arg is not None and kw.arg in params:
                out.append((kw.arg, kw.value))
        return out


def _base_name(sf: SourceFile) -> str:
    """Qualname prefix for definitions in ``sf`` — the dotted module for
    importable files, the repo-relative path for scripts."""
    return sf.module if sf.module else sf.rel


def body_walk(node: ast.AST) -> Iterator[ast.AST]:
    """Walk ``node``'s own body without descending into nested function or
    class definitions (their statements belong to their own summaries).
    Decorators and default expressions of nested defs DO belong to the
    enclosing function and are walked."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(node))
    while stack:
        cur = stack.pop()
        if isinstance(cur, (*FunctionNode, ast.ClassDef, ast.Lambda)):
            if isinstance(cur, FunctionNode):
                for dec in cur.decorator_list:
                    stack.append(dec)
                a = cur.args
                for d in list(a.defaults) + [x for x in a.kw_defaults if x]:
                    stack.append(d)
            continue
        yield cur
        stack.extend(ast.iter_child_nodes(cur))


class CallGraph:
    """Function index + resolved call sites for one :class:`Project`."""

    def __init__(self, project: Project):
        self.project = project
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, Set[str]] = {}      # class qual -> methods
        #: (class qualname, attr) / module-var qualname -> class qualname
        self.attr_types: Dict[Tuple[str, str], str] = {}
        self.var_types: Dict[str, str] = {}
        #: scope-local ``g = partial(f, ...)`` bindings:
        #: (scope qualname, name) -> (target qualname, n bound positionals)
        self.partials: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self.calls: Dict[str, List[CallSite]] = {}
        self._method_by_name: Dict[str, List[str]] = {}
        for sf in project.files:
            self._index_file(sf)
        for sf in project.files:
            self._infer_types(sf)
        for qual, info in self.functions.items():
            self.calls[qual] = list(self._resolve_calls(info))

    # -- indexing ----------------------------------------------------------

    def _index_file(self, sf: SourceFile) -> None:
        base = _base_name(sf)

        def visit(node: ast.AST, prefix: str, cls: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, FunctionNode):
                    qual = f"{prefix}.{child.name}"
                    info = FunctionInfo(qual, sf, child, cls=cls,
                                        is_method=cls is not None)
                    self.functions[qual] = info
                    if cls is not None:
                        self.classes.setdefault(
                            f"{prefix}", set()).add(child.name)
                        self._method_by_name.setdefault(
                            child.name, []).append(qual)
                    visit(child, qual, None)
                elif isinstance(child, ast.ClassDef):
                    cqual = f"{prefix}.{child.name}"
                    self.classes.setdefault(cqual, set())
                    visit(child, cqual, child.name)

        visit(sf.tree, base, None)

    def class_qual(self, sf: SourceFile, name: str) -> Optional[str]:
        """Project class qualname a (possibly imported/aliased) name
        spells, or None."""
        dotted = sf.aliases.get(name, name)
        if dotted in self.classes:
            return dotted
        local = f"{_base_name(sf)}.{dotted}"
        if local in self.classes:
            return local
        return None

    def _infer_types(self, sf: SourceFile) -> None:
        """Record ``X = Cls(...)`` / ``self.x = Cls(...)`` bindings (also
        looking through ``a if c else Cls(...)`` ternaries) so attribute
        calls on those objects resolve precisely."""
        base = _base_name(sf)

        def ctor_class(value: ast.expr) -> Optional[str]:
            if isinstance(value, ast.IfExp):
                return (ctor_class(value.body)
                        or ctor_class(value.orelse))
            if not isinstance(value, ast.Call):
                return None
            d = sf.dotted(value.func)
            if d is None:
                return None
            if d in self.classes:
                return d
            local = f"{base}.{d}"
            return local if local in self.classes else None

        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Assign):
                continue
            cq = ctor_class(node.value)
            if cq is None:
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    chain = sf.enclosing_functions(t)
                    if not chain:       # module-level instance
                        self.var_types[f"{base}.{t.id}"] = cq
                elif (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    for anc in sf.ancestors(t):
                        if isinstance(anc, ast.ClassDef):
                            self.attr_types[(f"{base}.{anc.name}"
                                             if "." not in anc.name else
                                             anc.name, t.attr)] = cq
                            break

    # -- resolution --------------------------------------------------------

    def _enclosing_quals(self, info: FunctionInfo) -> List[str]:
        """Qualname prefixes to search for bare-name callees: the function
        itself (nested defs), enclosing *function* scopes, then the module.
        Class scopes are skipped — a bare name inside a method does not see
        sibling methods in Python."""
        out = [info.qualname]
        prefix = info.qualname
        base = _base_name(info.sf)
        while "." in prefix and prefix != base:
            prefix = prefix.rsplit(".", 1)[0]
            if prefix == base or prefix in self.functions:
                out.append(prefix)
        if base not in out:
            out.append(base)
        return out

    def resolve_name(self, info: FunctionInfo, name: str
                     ) -> Optional[Tuple[str, int]]:
        """Resolve a bare or dotted callee name from inside ``info`` to
        (qualname, bound positional count)."""
        sf = info.sf
        for scope in self._enclosing_quals(info):
            bound = self.partials.get((scope, name))
            if bound is not None:
                return bound
            cand = f"{scope}.{name}"
            if cand in self.functions:
                return cand, 0
        dotted = sf.aliases.get(name, name)
        if dotted in self.functions:
            return dotted, 0
        if dotted in self.classes:
            init = f"{dotted}.__init__"
            return (init, 0) if init in self.functions else None
        return None

    def resolve_call(self, info: FunctionInfo, node: ast.Call
                     ) -> Tuple[Optional[str], int]:
        sf = info.sf
        func = node.func
        # functools.partial(f, ...) called immediately
        if isinstance(func, ast.Call):
            target = self._partial_target(info, func)
            if target is not None:
                return target
            return None, 0
        if isinstance(func, ast.Name):
            got = self.resolve_name(info, func.id)
            return got if got is not None else (None, 0)
        if isinstance(func, ast.Attribute):
            # self.m(...) within a class
            if (isinstance(func.value, ast.Name) and func.value.id == "self"
                    and info.cls is not None):
                cq = self._own_class_qual(info)
                if cq is not None and func.attr in self.classes.get(cq, ()):
                    return f"{cq}.{func.attr}", 0
            dotted = sf.dotted(func)
            if dotted is not None:
                if dotted in self.functions:
                    return dotted, 0
                if dotted in self.classes:
                    init = f"{dotted}.__init__"
                    if init in self.functions:
                        return init, 0
                local = f"{_base_name(sf)}.{dotted}"
                if local in self.functions:
                    return local, 0
            # typed receiver: self.x.m(...) / MODULE_VAR.m(...)
            recv_cls = self._receiver_class(info, func.value)
            if recv_cls is not None:
                if func.attr in self.classes.get(recv_cls, ()):
                    return f"{recv_cls}.{func.attr}", 0
                return None, 0
            # unique method name fallback
            if func.attr not in _AMBIGUOUS_METHOD_NAMES:
                quals = self._method_by_name.get(func.attr, ())
                if len(quals) == 1:
                    return quals[0], 0
        return None, 0

    def _own_class_qual(self, info: FunctionInfo) -> Optional[str]:
        if info.cls is None:
            return None
        # the method qualname is <...>.<Class>.<name>
        prefix = info.qualname.rsplit(".", 1)[0]
        return prefix if prefix in self.classes else None

    def _receiver_class(self, info: FunctionInfo, value: ast.expr
                        ) -> Optional[str]:
        """Class of ``value`` when it is ``self.attr`` with a recorded type
        or a module-level instance (possibly imported)."""
        if (isinstance(value, ast.Attribute)
                and isinstance(value.value, ast.Name)
                and value.value.id == "self"):
            cq = self._own_class_qual(info)
            if cq is not None:
                return self.attr_types.get((cq, value.attr))
            return None
        if isinstance(value, ast.Name):
            dotted = info.sf.aliases.get(value.id, value.id)
            got = self.var_types.get(dotted)
            if got is not None:
                return got
            return self.var_types.get(f"{_base_name(info.sf)}.{value.id}")
        return None

    def _partial_target(self, info: FunctionInfo, call: ast.Call
                        ) -> Optional[Tuple[str, int]]:
        """(target qualname, bound positional count) when ``call`` is
        ``functools.partial(project_fn, ...)``."""
        if info.sf.dotted(call.func) not in ("functools.partial", "partial"):
            return None
        if not call.args:
            return None
        target = call.args[0]
        resolved: Optional[Tuple[str, int]] = None
        if isinstance(target, ast.Name):
            resolved = self.resolve_name(info, target.id)
        elif isinstance(target, ast.Attribute):
            dotted = info.sf.dotted(target)
            if dotted in self.functions:
                resolved = (dotted, 0)
        if resolved is None:
            return None
        qual, already = resolved
        return qual, already + len(call.args) - 1

    def _resolve_calls(self, info: FunctionInfo) -> Iterator[CallSite]:
        # record scope-local partial bindings first so later calls resolve
        for node in body_walk(info.node):
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                target = self._partial_target(info, node.value)
                if target is None:
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.partials[(info.qualname, t.id)] = target
        # module-level partial bindings visible from this function
        base = _base_name(info.sf)
        for stmt in info.sf.tree.body:
            if (isinstance(stmt, ast.Assign)
                    and isinstance(stmt.value, ast.Call)):
                target = self._partial_target(info, stmt.value)
                if target is None:
                    continue
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        self.partials.setdefault((base, t.id), target)
        for node in body_walk(info.node):
            if isinstance(node, ast.Call):
                callee, bound = self.resolve_call(info, node)
                yield CallSite(caller=info.qualname, node=node,
                               callee=callee, line=node.lineno,
                               bound_args=bound)

    # -- queries -----------------------------------------------------------

    def callees(self, qual: str) -> Set[str]:
        return {c.callee for c in self.calls.get(qual, ())
                if c.callee is not None}

    def lookup(self, qual: str) -> Optional[FunctionInfo]:
        return self.functions.get(qual)

    def find_by_name(self, name: str) -> List[FunctionInfo]:
        """Every function whose terminal name is ``name`` (used by rules to
        locate anchors like ``ga_params_key`` in fixture trees)."""
        return [info for qual, info in self.functions.items()
                if qual.rsplit(".", 1)[-1] == name]


def get_callgraph(project: Project) -> CallGraph:
    """The project's call graph, built once and memoized on the project —
    REP007/REP008/REP009 all run over the same graph."""
    cached = getattr(project, "_callgraph_cache", None)
    if cached is None or cached.project is not project:
        cached = CallGraph(project)
        project._callgraph_cache = cached
    return cached

"""Source loading and cross-file facts for the port's invariant linter.

:class:`SourceFile` wraps one parsed module: AST with parent links, the
per-line suppression directives, and an import-alias map so rules can ask
"what dotted name does this expression spell?" without caring whether the
file wrote ``np.random.rand``, ``numpy.random.rand``, or imported the symbol
directly.

:class:`Project` owns the file set plus the facts that only exist across
files: which modules a ``repro_torch.serve`` thread can reach (import
closure — the REP003 lock-discipline scope), which functions are device
programs and which of their parameters they take as host values (REP004,
REP009), and which cached callables ever get ``.cache_clear()``'d at runtime
(the REP003 bare-``lru_cache`` check).

A **device program** is the port's counterpart of a ``jax.jit`` site: a
plain function on tensors whose work is queued on the device, marked
``@device_program("hw", ...)`` (``repro_torch.device.device_program``, which
returns the function itself) with the names of the parameters it takes as
host values — the jit site's ``static_argnames`` plus any parameter that is
a plain Python value in the port.  Every other parameter is a tensor.

Everything here is stdlib ``ast`` — the linter never imports the code it
checks, except for the env-var registry (``repro_torch.core.envvars``),
which is stdlib-only by construction and is the single source of truth
REP006 compares reads against.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from . import suppressions

#: directories scanned by default, relative to the repo root: the port's
#: benches and examples live inside its package.  tests/ is deliberately
#: absent: tests monkeypatch env vars, draw ad-hoc RNG, and poke private
#: state on purpose.
DEFAULT_SCAN_DIRS = ("src/repro_torch",)

FunctionNode = (ast.FunctionDef, ast.AsyncFunctionDef)


def _module_name(rel: str) -> Optional[str]:
    """Dotted import name for a repo-relative path
    (``src/repro_torch/core/x.py`` -> ``repro_torch.core.x``; package
    ``__init__`` maps to the package itself).
    Top-level script dirs (scripts/, examples/) are not importable packages
    here and return None."""
    parts = Path(rel).parts
    if parts[0] == "src":
        parts = parts[1:]
    elif parts[0] not in ("benchmarks",):
        return None
    if not parts or not parts[-1].endswith(".py"):
        return None
    parts = parts[:-1] + (parts[-1][:-3],)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) if parts else None


class SourceFile:
    """One parsed source file with parent links, aliases, directives."""

    def __init__(self, root: Path, path: Path):
        self.path = path
        self.rel = path.relative_to(root).as_posix()
        self.text = path.read_text()
        self.tree = ast.parse(self.text, filename=self.rel)
        self.directives = suppressions.scan(self.text)
        self.module = _module_name(self.rel)
        self.is_pkg_init = path.name == "__init__.py"
        self._parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent
        self.aliases = self._build_aliases()

    # -- imports / dotted-name resolution ---------------------------------

    def _resolve_from(self, node: ast.ImportFrom) -> Optional[str]:
        """Absolute dotted module an ``ImportFrom`` pulls from (relative
        imports resolved against this file's package)."""
        if node.level == 0:
            return node.module
        if self.module is None:
            return None
        pkg = self.module.split(".")
        if not self.is_pkg_init:
            pkg = pkg[:-1]
        if node.level - 1 > len(pkg):
            return None
        base = pkg[: len(pkg) - (node.level - 1)]
        if node.module:
            base = base + node.module.split(".")
        return ".".join(base)

    def _build_aliases(self) -> Dict[str, str]:
        """Local name -> absolute dotted name, for both module imports
        (``import numpy as np`` -> np: numpy) and symbol imports
        (``from numpy.random import default_rng`` -> default_rng:
        numpy.random.default_rng)."""
        out: Dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        out[a.asname] = a.name
                    else:
                        head = a.name.split(".")[0]
                        out.setdefault(head, head)
            elif isinstance(node, ast.ImportFrom):
                mod = self._resolve_from(node)
                if mod is None:
                    continue
                for a in node.names:
                    if a.name == "*":
                        continue
                    out[a.asname or a.name] = f"{mod}.{a.name}"
        return out

    def dotted(self, node: ast.AST) -> Optional[str]:
        """The absolute dotted name an expression spells, alias-expanded
        (``np.random.rand`` -> ``numpy.random.rand``), or None for
        non-name expressions."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        head = self.aliases.get(parts[0], parts[0])
        return ".".join([head] + parts[1:])

    # -- tree navigation ---------------------------------------------------

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    def enclosing_functions(self, node: ast.AST) -> List[ast.AST]:
        """Innermost-first FunctionDef/AsyncFunctionDef chain above node."""
        return [a for a in self.ancestors(node) if isinstance(a, FunctionNode)]

    def functions(self) -> Iterator[ast.AST]:
        for node in ast.walk(self.tree):
            if isinstance(node, FunctionNode):
                yield node

    def under_lock(self, node: ast.AST) -> bool:
        """True when node sits inside ``with <something lock-like>:`` —
        a context manager whose terminal name contains "lock" (covers
        ``_TABLE_LOCK``, ``self._lock``, ``threading.Lock()`` instances
        bound to conventional names)."""
        for anc in self.ancestors(node):
            if not isinstance(anc, (ast.With, ast.AsyncWith)):
                continue
            for item in anc.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call):
                    expr = expr.func
                name = None
                if isinstance(expr, ast.Attribute):
                    name = expr.attr
                elif isinstance(expr, ast.Name):
                    name = expr.id
                if name and "lock" in name.lower():
                    return True
        return False


# -- device programs -------------------------------------------------------

#: the marker's dotted name, however a file imports it
DEVICE_PROGRAM = "repro_torch.device.device_program"


class DeviceProgramSite:
    """One device program: the marked FunctionDef plus the host parameter
    names its marker spells (None = not literally given)."""

    def __init__(self, sf: SourceFile, fn: ast.AST, call: ast.Call,
                 decl_node: ast.AST):
        self.sf = sf
        self.fn = fn
        self.decl_node = decl_node          # node to anchor findings on
        self.host_params = self._names(call)

    @staticmethod
    def _names(call: ast.Call) -> Optional[Tuple[str, ...]]:
        if call.keywords or not all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in call.args):
            return None
        return tuple(e.value for e in call.args)


def _is_marker_call(sf: SourceFile, node: ast.AST) -> bool:
    """``device_program(...)`` — the marker called with its host names."""
    return (isinstance(node, ast.Call)
            and sf.dotted(node.func) == DEVICE_PROGRAM)


def _local_functiondef(sf: SourceFile, at: ast.AST, name: str):
    """Find ``def name`` visible from ``at``: same enclosing function bodies
    or module top level.  Good enough for the ``device_program(...)(fn)``
    call form where fn is defined a few lines above."""
    scopes = sf.enclosing_functions(at) + [sf.tree]
    for scope in scopes:
        body = scope.body if hasattr(scope, "body") else []
        for stmt in body:
            if isinstance(stmt, FunctionNode) and stmt.name == name:
                return stmt
    return None


def iter_device_program_sites(sf: SourceFile) -> Iterator[DeviceProgramSite]:
    """Every device program in the file, in the decorator form
    (``@device_program("hw", ...)``) and the call form
    (``device_program("hw", ...)(fn)``)."""
    for fn in sf.functions():
        for dec in fn.decorator_list:
            if _is_marker_call(sf, dec):
                yield DeviceProgramSite(sf, fn, dec, dec)
    for node in ast.walk(sf.tree):
        if (isinstance(node, ast.Call) and _is_marker_call(sf, node.func)
                and node.args and isinstance(node.args[0], ast.Name)):
            fn = _local_functiondef(sf, node, node.args[0].id)
            if fn is not None:
                yield DeviceProgramSite(sf, fn, node.func, node)


# -- project ---------------------------------------------------------------

class Project:
    """The file set plus lazily-computed cross-file facts.

    ``scope_all=True`` (fixture tests) makes every rule treat every file as
    in scope, so rules can be exercised on synthetic single-file trees
    without replicating the repo's package layout.  ``registered_env``
    overrides the env-var registry import for the same reason.
    """

    def __init__(self, root: Path, files: Sequence[SourceFile], *,
                 scope_all: bool = False,
                 registered_env: Optional[Set[str]] = None):
        self.root = Path(root)
        self.files = list(files)
        self.scope_all = scope_all
        self._registered_env = registered_env
        self._by_module = {sf.module: sf for sf in self.files if sf.module}
        self._serve_reachable: Optional[Set[str]] = None
        self._cache_clear_names: Optional[Set[str]] = None
        self._program_qualnames: Optional[
            Dict[str, DeviceProgramSite]] = None

    @classmethod
    def load(cls, root, paths: Optional[Sequence[str]] = None,
             **kw) -> "Project":
        root = Path(root).resolve()
        if paths:
            targets = [root / p for p in paths]
        else:
            targets = [root / d for d in DEFAULT_SCAN_DIRS]
        seen: Set[Path] = set()
        files: List[SourceFile] = []
        for t in targets:
            if t.is_file() and t.suffix == ".py":
                candidates = [t]
            elif t.is_dir():
                candidates = sorted(t.rglob("*.py"))
            else:
                continue
            for p in candidates:
                p = p.resolve()
                if p in seen:
                    continue
                seen.add(p)
                files.append(SourceFile(root, p))
        return cls(root, files, **kw)

    def by_rel(self, rel: str) -> Optional[SourceFile]:
        for sf in self.files:
            if sf.rel == rel:
                return sf
        return None

    # -- serve-reachability (REP003 scope) --------------------------------

    def _imports_of(self, sf: SourceFile) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name in self._by_module:
                        out.add(a.name)
            elif isinstance(node, ast.ImportFrom):
                mod = sf._resolve_from(node)
                if mod is None:
                    continue
                if mod in self._by_module:
                    out.add(mod)
                for a in node.names:
                    sub = f"{mod}.{a.name}"
                    if sub in self._by_module:
                        out.add(sub)
        return out

    @property
    def serve_reachable(self) -> Set[str]:
        """Repo-relative paths of every module importable (transitively)
        from ``repro_torch.serve`` — the modules whose shared state the DSE
        service's dispatcher and client threads can touch concurrently."""
        if self._serve_reachable is None:
            queue = [m for m in self._by_module if m == "repro_torch.serve"
                     or m.startswith("repro_torch.serve.")]
            seen = set(queue)
            while queue:
                mod = queue.pop()
                for dep in self._imports_of(self._by_module[mod]):
                    if dep not in seen:
                        seen.add(dep)
                        queue.append(dep)
            self._serve_reachable = {self._by_module[m].rel for m in seen}
        return self._serve_reachable

    # -- runtime cache_clear references (REP003 lru_cache check) ----------

    @property
    def cache_clear_names(self) -> Set[str]:
        """Names ``X`` such that ``X.cache_clear`` is referenced anywhere in
        the scanned tree — a bare ``lru_cache`` on such a function races
        with the clearer unless the memo is lock-wrapped."""
        if self._cache_clear_names is None:
            names: Set[str] = set()
            for sf in self.files:
                for node in ast.walk(sf.tree):
                    if (isinstance(node, ast.Attribute)
                            and node.attr == "cache_clear"
                            and isinstance(node.value, ast.Name)):
                        names.add(node.value.id)
            self._cache_clear_names = names
        return self._cache_clear_names

    # -- device programs (REP004 call-site check) ------------------------

    @property
    def device_program_qualnames(self) -> Dict[str, DeviceProgramSite]:
        """``module.function`` -> DeviceProgramSite for module-level device
        programs, so call sites in other files can be checked."""
        if self._program_qualnames is None:
            out: Dict[str, DeviceProgramSite] = {}
            for sf in self.files:
                if sf.module is None:
                    continue
                top = {n.name for n in sf.tree.body
                       if isinstance(n, FunctionNode)}
                for site in iter_device_program_sites(sf):
                    if site.fn.name in top:
                        out[f"{sf.module}.{site.fn.name}"] = site
            self._program_qualnames = out
        return self._program_qualnames

    # -- env registry (REP006) --------------------------------------------

    @property
    def registered_env(self) -> Set[str]:
        """Names in repro_torch.core.envvars.REGISTRY.  Loaded by file
        path, not through the ``repro_torch.core`` package — the package
        __init__ imports torch, and the linter must run on a bare stdlib."""
        if self._registered_env is None:
            path = self.root / "src" / "repro_torch" / "core" / "envvars.py"
            try:
                import importlib.util
                import sys
                spec = importlib.util.spec_from_file_location(
                    "_repro_torch_envvars_registry", path)
                mod = importlib.util.module_from_spec(spec)
                # dataclasses resolve cls.__module__ through sys.modules
                # during class creation, so the module must be registered
                # before exec
                sys.modules[spec.name] = mod
                spec.loader.exec_module(mod)
                self._registered_env = {v.name for v in mod.REGISTRY}
            except Exception:
                self._registered_env = set()
        return self._registered_env

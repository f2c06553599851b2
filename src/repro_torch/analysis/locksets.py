"""Interprocedural lock-order analysis (the REP007 substrate).

The DSE service puts a dispatcher thread and N client threads behind one
process, and the port owns four real locks: the flexion table lock
(``repro_torch.core.flexion_batched._TABLE_LOCK``), the ``ResultCache``
instance RLock, the ``DSEService`` lock (whose ``Condition`` wraps the
*same* lock object — acquiring ``self._wake`` IS acquiring ``self._lock``)
and the kernel build lock (``repro_torch.kernels._build._LOCK``).  A
deadlock needs two facts no single function shows: who holds what when they
call whom, and what the callee (transitively) acquires.

This module computes exactly that, stdlib-``ast`` only:

  * **lock discovery** — module-level ``X = threading.Lock()/RLock()`` and
    instance ``self.x = threading.Lock()`` bindings become stable lock ids
    (``repro_torch.core.flexion_batched._TABLE_LOCK``,
    ``repro_torch.core.result_cache.ResultCache._lock``);
    ``threading.Condition(existing_lock)`` *aliases* the wrapped lock;
  * **per-function summaries** — a walk of each body (nested defs excluded;
    they summarize separately) tracking the held-set through ``with``
    nesting, recording every acquisition and every call with the locks held
    at that point;
  * **acquires-closure** — fixpoint over the call graph: every lock a call
    to ``f`` may acquire, including through decorators (``@_locked_memo``'s
    wrapper acquires ``_TABLE_LOCK`` on the decorated function's behalf);
  * **order edges** — ``A -> B`` whenever B is acquired (directly or via a
    call's closure) with A held.  A cycle in this graph is a potential
    deadlock; a non-reentrant lock reappearing in its own held-set is a
    guaranteed one.
  * **blocking-under-lock** — indefinite waits (``.wait()``/``.join()``/
    ``.result()``/``time.sleep``), the device waits
    (``torch.cuda.synchronize()`` and ``.synchronize()`` on a stream or an
    event: the host stalls until the card drains) and engine dispatch
    (``run_batched_ga``) made while holding any lock.  ``Condition.wait``
    is exempt when the condition's own lock is the only lock held — wait
    releases it; holding a *second* lock across the wait still starves
    other threads.

:func:`lock_order_edges` exports the static edge set so a runtime recorder
(``tests/_lockorder.py``) can assert observed acquisition orders are a
subset of it.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

from .callgraph import CallGraph, CallSite, FunctionInfo, _base_name
from .walker import FunctionNode, Project

_LOCK_CTORS = {"threading.Lock": "lock", "threading.RLock": "rlock"}
_CONDITION_CTOR = "threading.Condition"

#: attribute calls that block indefinitely — holding any lock across one of
#: these stalls every thread contending for that lock
_BLOCKING_ATTRS = frozenset({"wait", "join", "result", "synchronize"})
_BLOCKING_DOTTED = frozenset({"time.sleep", "torch.cuda.synchronize"})
#: resolved project callees that are themselves long-running dispatch
_BLOCKING_CALLEE_SUFFIXES = (".run_batched_ga",)


@dataclasses.dataclass
class Acquire:
    lock: str
    line: int
    held: FrozenSet[str]


@dataclasses.dataclass
class CallEvent:
    node: ast.Call
    site: Optional[CallSite]
    line: int
    held: FrozenSet[str]


@dataclasses.dataclass
class Summary:
    acquires: List[Acquire] = dataclasses.field(default_factory=list)
    calls: List[CallEvent] = dataclasses.field(default_factory=list)

    @property
    def direct_locks(self) -> Set[str]:
        return {a.lock for a in self.acquires}


class LockAnalysis:
    """Locks, conditions, per-function summaries, closures, order edges."""

    def __init__(self, project: Project, graph: CallGraph):
        self.project = project
        self.graph = graph
        self.locks: Dict[str, str] = {}          # lock id -> "lock"/"rlock"
        self.conditions: Dict[str, str] = {}     # condition qual -> lock id
        self._discover()
        self.summaries: Dict[str, Summary] = {
            qual: self._summarize(info)
            for qual, info in graph.functions.items()}
        self._extra_callees = self._decorator_edges()
        self.closures = self._fixpoint()

    # -- discovery ---------------------------------------------------------

    def _discover(self) -> None:
        cond_bindings: List[Tuple[str, ast.expr, "ast.AST"]] = []
        for sf in self.project.files:
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Assign):
                    continue
                value = node.value
                if not isinstance(value, ast.Call):
                    continue
                ctor = sf.dotted(value.func)
                for t in node.targets:
                    owner = self._target_owner(sf, t)
                    if owner is None:
                        continue
                    if ctor in _LOCK_CTORS:
                        self.locks[owner] = _LOCK_CTORS[ctor]
                    elif ctor == _CONDITION_CTOR:
                        if value.args:
                            cond_bindings.append((owner, value.args[0], sf))
                        else:
                            # a Condition() owns a fresh RLock
                            self.locks[owner] = "rlock"
                            self.conditions[owner] = owner
        for owner, arg, sf in cond_bindings:
            target = self._expr_lock_id(sf, arg, cls_of=owner)
            if target is not None:
                self.conditions[owner] = target

    def _target_owner(self, sf, t: ast.expr) -> Optional[str]:
        """Stable id for an assignment target: module-level ``X`` or
        ``self.x`` inside a class."""
        base = _base_name(sf)
        if isinstance(t, ast.Name):
            if not sf.enclosing_functions(t):
                return f"{base}.{t.id}"
            return None
        if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                and t.value.id == "self"):
            for anc in sf.ancestors(t):
                if isinstance(anc, ast.ClassDef):
                    return f"{base}.{anc.name}.{t.attr}"
        return None

    def _expr_lock_id(self, sf, expr: ast.expr, *,
                      cls_of: Optional[str] = None,
                      info: Optional[FunctionInfo] = None) -> Optional[str]:
        """Lock id an expression refers to (conditions resolve to their
        underlying lock), or None when it isn't a known lock."""
        cand: Optional[str] = None
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"):
            cq = None
            if info is not None:
                cq = self.graph._own_class_qual(info)
            if cq is None and cls_of is not None and "." in cls_of:
                cq = cls_of.rsplit(".", 1)[0]
            if cq is not None:
                cand = f"{cq}.{expr.attr}"
        else:
            dotted = sf.dotted(expr)
            if dotted is not None:
                if dotted in self.locks or dotted in self.conditions:
                    cand = dotted
                else:
                    local = f"{_base_name(sf)}.{dotted}"
                    if local in self.locks or local in self.conditions:
                        cand = local
        if cand is None:
            return None
        if cand in self.conditions:
            return self.conditions[cand]
        if cand in self.locks:
            return cand
        return None

    def condition_lock(self, info: FunctionInfo, expr: ast.expr
                       ) -> Optional[str]:
        """Underlying lock id when ``expr`` names a known *Condition*."""
        sf = info.sf
        cand: Optional[str] = None
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"):
            cq = self.graph._own_class_qual(info)
            if cq is not None:
                cand = f"{cq}.{expr.attr}"
        else:
            dotted = sf.dotted(expr)
            if dotted is not None:
                cand = (dotted if dotted in self.conditions
                        else f"{_base_name(sf)}.{dotted}")
        if cand is not None:
            return self.conditions.get(cand)
        return None

    # -- per-function summaries -------------------------------------------

    def _summarize(self, info: FunctionInfo) -> Summary:
        out = Summary()
        by_node = {id(cs.node): cs for cs in
                   self.graph.calls.get(info.qualname, ())}

        def handle(node: ast.AST, held: FrozenSet[str]) -> None:
            if isinstance(node, (*FunctionNode, ast.ClassDef, ast.Lambda)):
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner = held
                for item in node.items:
                    # calls inside the context expr run before acquisition
                    handle(item.context_expr, inner)
                    lk = self._expr_lock_id(info.sf, item.context_expr,
                                            info=info)
                    if lk is not None:
                        out.acquires.append(Acquire(
                            lk, item.context_expr.lineno, inner))
                        inner = inner | {lk}
                for stmt in node.body:
                    handle(stmt, inner)
                return
            if isinstance(node, ast.Call):
                self._note_call(out, by_node, node, held)
                # explicit X.acquire() counts as an acquisition
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr == "acquire"):
                    lk = self._expr_lock_id(info.sf, node.func.value,
                                            info=info)
                    if lk is not None:
                        out.acquires.append(Acquire(
                            lk, node.lineno, held))
            for child in ast.iter_child_nodes(node):
                handle(child, held)

        for child in ast.iter_child_nodes(info.node):
            handle(child, frozenset())
        return out

    @staticmethod
    def _note_call(out: Summary, by_node, node: ast.Call,
                   held: FrozenSet[str]) -> None:
        out.calls.append(CallEvent(node, by_node.get(id(node)),
                                   node.lineno, held))

    # -- closures ----------------------------------------------------------

    def _decorator_edges(self) -> Dict[str, Set[str]]:
        """Synthetic call edges for decorators: calling a decorated function
        runs the decorator's wrapper, so the decorated function inherits the
        decorator's (and its nested defs') acquisitions."""
        out: Dict[str, Set[str]] = {}
        for qual, info in self.graph.functions.items():
            for dec in info.node.decorator_list:
                expr = dec.func if isinstance(dec, ast.Call) else dec
                dq: Optional[str] = None
                if isinstance(expr, ast.Name):
                    got = self.graph.resolve_name(info, expr.id)
                    if got is not None:
                        dq = got[0]
                elif isinstance(expr, ast.Attribute):
                    dotted = info.sf.dotted(expr)
                    if dotted in self.graph.functions:
                        dq = dotted
                if dq is None:
                    continue
                edges = out.setdefault(qual, set())
                edges.add(dq)
                prefix = dq + "."
                edges.update(q for q in self.graph.functions
                             if q.startswith(prefix))
        return out

    def _callees_of(self, qual: str) -> Set[str]:
        out = set(self.graph.callees(qual))
        out |= self._extra_callees.get(qual, set())
        return out

    def _fixpoint(self) -> Dict[str, FrozenSet[str]]:
        closures: Dict[str, Set[str]] = {
            qual: set(s.direct_locks)
            for qual, s in self.summaries.items()}
        changed = True
        while changed:
            changed = False
            for qual in closures:
                merged = set(closures[qual])
                for callee in self._callees_of(qual):
                    merged |= closures.get(callee, set())
                if merged != closures[qual]:
                    closures[qual] = merged
                    changed = True
        return {q: frozenset(s) for q, s in closures.items()}

    # -- order edges / hazards --------------------------------------------

    def order_edges(self) -> Dict[Tuple[str, str],
                                  List[Tuple[str, int, str]]]:
        """``(held, acquired) -> [(path, line, how), ...]`` witnesses."""
        edges: Dict[Tuple[str, str], List[Tuple[str, int, str]]] = {}
        for qual, summary in self.summaries.items():
            info = self.graph.functions[qual]
            rel = info.sf.rel
            for acq in summary.acquires:
                for held in acq.held:
                    if held != acq.lock:
                        edges.setdefault((held, acq.lock), []).append(
                            (rel, acq.line,
                             f"{qual} acquires {acq.lock} while holding "
                             f"{held}"))
            for ev in summary.calls:
                if not ev.held or ev.site is None or ev.site.callee is None:
                    continue
                for lock in self.closures.get(ev.site.callee, ()):
                    for held in ev.held:
                        if held != lock:
                            edges.setdefault((held, lock), []).append(
                                (rel, ev.line,
                                 f"{qual} calls {ev.site.callee} (which "
                                 f"may acquire {lock}) while holding "
                                 f"{held}"))
        return edges

    def self_deadlocks(self) -> Iterator[Tuple[str, int, str]]:
        """Non-reentrant locks re-acquired while already held — directly,
        or through a call whose closure re-enters the lock."""
        for qual, summary in self.summaries.items():
            rel = self.graph.functions[qual].sf.rel
            for acq in summary.acquires:
                if acq.lock in acq.held and self.locks.get(
                        acq.lock) == "lock":
                    yield (rel, acq.line,
                           f"{qual} re-acquires non-reentrant lock "
                           f"{acq.lock} already held on this thread — "
                           f"guaranteed deadlock; use an RLock or hoist "
                           f"the outer acquisition")
            for ev in summary.calls:
                if ev.site is None or ev.site.callee is None:
                    continue
                for lock in self.closures.get(ev.site.callee, ()):
                    if lock in ev.held and self.locks.get(lock) == "lock":
                        yield (rel, ev.line,
                               f"{qual} calls {ev.site.callee}, which may "
                               f"acquire non-reentrant lock {lock} this "
                               f"thread already holds — guaranteed "
                               f"deadlock; call outside the lock or make "
                               f"it an RLock")

    def cycles(self) -> Iterator[Tuple[Tuple[str, ...],
                                       List[Tuple[str, int, str]]]]:
        """Acquisition-order cycles: (canonical lock cycle, witnesses)."""
        edges = self.order_edges()
        adj: Dict[str, Set[str]] = {}
        for (a, b) in edges:
            adj.setdefault(a, set()).add(b)
        seen_cycles: Set[Tuple[str, ...]] = set()
        for start in sorted(adj):
            stack = [(start, (start,))]
            while stack:
                node, path = stack.pop()
                for nxt in sorted(adj.get(node, ())):
                    if nxt == start and len(path) > 1:
                        lo = min(range(len(path)),
                                 key=lambda i: path[i])
                        canon = path[lo:] + path[:lo]
                        if canon in seen_cycles:
                            continue
                        seen_cycles.add(canon)
                        witnesses: List[Tuple[str, int, str]] = []
                        cyc = list(canon) + [canon[0]]
                        for a, b in zip(cyc, cyc[1:]):
                            witnesses.extend(edges.get((a, b), ())[:1])
                        yield canon, witnesses
                    elif nxt not in path and len(path) < 6:
                        stack.append((nxt, path + (nxt,)))

    def blocking_under_lock(self) -> Iterator[Tuple[str, int, str]]:
        for qual, summary in self.summaries.items():
            info = self.graph.functions[qual]
            for ev in summary.calls:
                if not ev.held:
                    continue
                desc = self._blocking_desc(info, ev)
                if desc is None:
                    continue
                held = ", ".join(sorted(ev.held))
                yield (info.sf.rel, ev.line,
                       f"{qual} makes blocking call {desc} while holding "
                       f"{held} — every thread contending for the lock "
                       f"stalls; move the wait outside the critical "
                       f"section")

    def _blocking_desc(self, info: FunctionInfo,
                       ev: CallEvent) -> Optional[str]:
        node = ev.node
        dotted = info.sf.dotted(node.func)
        if dotted in _BLOCKING_DOTTED:
            return dotted
        if ev.site is not None and ev.site.callee is not None:
            if ev.site.callee.endswith(_BLOCKING_CALLEE_SUFFIXES):
                return f"{ev.site.callee} (engine dispatch)"
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in _BLOCKING_ATTRS:
                if attr == "wait":
                    under = self.condition_lock(info, node.func.value)
                    if under is not None and ev.held == frozenset({under}):
                        # Condition.wait releases its own (sole held) lock
                        return None
                recv = info.sf.dotted(node.func.value) or "<obj>"
                return f"{recv}.{attr}()"
        return None


def lock_order_edges(project: Project) -> Set[Tuple[str, str]]:
    """Static ``(held, then-acquired)`` lock-order pairs for the scanned
    tree — the runtime recorder asserts observed orders ⊆ this set."""
    analysis = LockAnalysis(project, CallGraph(project))
    return set(analysis.order_edges())

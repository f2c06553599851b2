"""Interprocedural value-flow facts for REP008/REP009.

Two small dataflow analyses over the :class:`~.callgraph.CallGraph`, both
deliberately *syntactic* — they track names and attribute reads, not
values, which is exactly the precision the two rules need:

* :func:`attr_reads` — which attributes of a parameter are read anywhere
  on the call paths out of a root function.  REP008 runs it from
  ``run_batched_ga``'s ``cfg`` to learn which ``GAConfig`` fields the
  dispatch path actually consumes (transitively: ``ga_ops.n_elite`` reads
  ``elite_frac`` two calls down), then compares against the fields folded
  into ``ga_params_key``.

* :class:`ShapeTaint` — REP009's two hazards around the device-program
  boundary (``repro_torch.device.device_program``, the port's counterpart
  of a ``jax.jit`` site):

  - **host→device**: a Python int derived from ``len(...)``/``.shape``
    that flows through assignments/returns/parameters into a *tensor*
    parameter of a device program (REP004 catches the direct call-site
    pattern; this catches the value after it has traveled).  ``_bucket(...)``
    and ``numpy``/``torch`` wraps (``np.int32(...)``, ``torch.tensor(...)``)
    launder the taint — those are the documented compliant patterns.
  - **device→host**: a *tensor* value (a parameter the marker does not
    declare host, or anything derived from one — including inside helpers
    the program calls) reaching Python control flow or a host read:
    ``if``/``while``/ternary/``assert`` tests, ``bool()``/``int()``/
    ``float()``/``range()``, ``.item()``/``.tolist()``/``.cpu()``/
    ``.numpy()``.  Each makes the host wait for the device, inside a GA
    generation that is queued without one.  ``x is None`` / ``x is not
    None`` tests are exempt — that comparison is the static split REP001
    *requires* — and so are a tensor's ``.shape``, ``.ndim``, ``.dtype``,
    ``.device`` and ``len()``, which are host metadata.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .callgraph import CallGraph, FunctionInfo, body_walk
from .walker import (DeviceProgramSite, FunctionNode, Project,
                     iter_device_program_sites)


# -- REP008: parameter attribute reads --------------------------------------

def _nested_quals(graph: CallGraph, qual: str) -> List[str]:
    """``qual`` plus every function nested inside it (closures read and
    forward the tracked parameter too)."""
    prefix = qual + "."
    return [qual] + [q for q in graph.functions if q.startswith(prefix)]


def attr_reads(graph: CallGraph, root_qual: str, param: str
               ) -> Dict[str, Tuple[str, int]]:
    """Attribute names read (``p.x`` or ``getattr(p, "x", ...)``) on
    ``param`` of ``root_qual`` anywhere on its call paths, with the first
    ``(path, line)`` witness for each."""
    out: Dict[str, Tuple[str, int]] = {}
    work: List[Tuple[str, str]] = [(root_qual, param)]
    seen: Set[Tuple[str, str]] = set()
    while work:
        qual, p = work.pop()
        if (qual, p) in seen:
            continue
        seen.add((qual, p))
        info = graph.functions.get(qual)
        if info is None:
            continue
        rel = info.sf.rel
        for node in ast.walk(info.node):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == p):
                out.setdefault(node.attr, (rel, node.lineno))
            elif (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "getattr"
                    and len(node.args) >= 2
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id == p
                    and isinstance(node.args[1], ast.Constant)
                    and isinstance(node.args[1].value, str)):
                out.setdefault(node.args[1].value, (rel, node.lineno))
        for scope in _nested_quals(graph, qual):
            for cs in graph.calls.get(scope, ()):
                if cs.callee is None:
                    continue
                callee = graph.functions.get(cs.callee)
                if callee is None:
                    continue
                for pname, arg in cs.arg_bindings(callee):
                    if isinstance(arg, ast.Name) and arg.id == p:
                        work.append((cs.callee, pname))
    return out


def dataclass_fields(cls_node: ast.ClassDef) -> Dict[str, int]:
    """Annotated field name -> def line for a dataclass body."""
    out: Dict[str, int] = {}
    for stmt in cls_node.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target,
                                                          ast.Name):
            out[stmt.target.id] = stmt.lineno
    return out


def dict_literal_keys(sf, var_name: str) -> Optional[Dict[str, int]]:
    """String keys (-> line) of a module-level ``var_name = {...}`` dict
    literal, or None when no such literal exists."""
    for stmt in sf.tree.body:
        if not isinstance(stmt, ast.Assign):
            continue
        for t in stmt.targets:
            if isinstance(t, ast.Name) and t.id == var_name:
                if not isinstance(stmt.value, ast.Dict):
                    return None
                out: Dict[str, int] = {}
                for k in stmt.value.keys:
                    if isinstance(k, ast.Constant) and isinstance(k.value,
                                                                  str):
                        out[k.value] = k.lineno
                return out
    return None


# -- REP009: shape/device-value taint ---------------------------------------

#: callables that launder a host int for a tensor slot — the compliant ways
#: to pass a size-derived value into a device program
_TAINT_CLEARING_HEADS = ("numpy.", "torch.")
_TAINT_CLEARING_NAMES = frozenset({"_bucket"})

_SOURCE_ATTRS = frozenset({"shape"})


@dataclasses.dataclass
class FnTaintSummary:
    """How taint moves through one function (host→device direction)."""

    returns_tainted: bool = False
    #: params that flow (unlaundered) into a tensor arg of a device program
    #: called inside this function or its callees:
    #: param -> (path, line, program name)
    param_to_program: Dict[str, Tuple[str, int, str]] = dataclasses.field(
        default_factory=dict)


class ShapeTaint:
    """Project-wide shape/device-value taint facts for REP009."""

    def __init__(self, project: Project, graph: CallGraph):
        self.project = project
        self.graph = graph
        #: program qualname -> site for callables resolvable cross-module,
        #: plus per-file local sites
        self.program_by_qual: Dict[str, DeviceProgramSite] = dict(
            project.device_program_qualnames)
        self.local_sites: Dict[str, List[DeviceProgramSite]] = {}
        for sf in project.files:
            sites = list(iter_device_program_sites(sf))
            if sites:
                self.local_sites[sf.rel] = sites
        self.summaries: Dict[str, FnTaintSummary] = {}
        for qual in graph.functions:
            self._summary(qual, ())

    # -- host→device -------------------------------------------------------

    def _is_cleared(self, info: FunctionInfo, node: ast.Call) -> bool:
        dotted = info.sf.dotted(node.func)
        if dotted is not None:
            if dotted.startswith(_TAINT_CLEARING_HEADS):
                return True
            if dotted.rsplit(".", 1)[-1] in _TAINT_CLEARING_NAMES:
                return True
        return False

    def _tainted_walk(self, info: FunctionInfo, node: ast.expr,
                      tainted: Set[str]) -> bool:
        if isinstance(node, ast.Call):
            if self._is_cleared(info, node):
                return False
            if (isinstance(node.func, ast.Name)
                    and node.func.id == "len"):
                return True
            got = self.graph.resolve_call(info, node)[0]
            if got is not None and self.summaries.get(
                    got, FnTaintSummary()).returns_tainted:
                return True
            return False
        if isinstance(node, ast.Attribute):
            if node.attr in _SOURCE_ATTRS:
                return True
            return False
        if isinstance(node, ast.Name):
            return node.id in tainted
        if isinstance(node, ast.Subscript):
            return self._tainted_walk(info, node.value, tainted)
        if isinstance(node, ast.BinOp):
            return (self._tainted_walk(info, node.left, tainted)
                    or self._tainted_walk(info, node.right, tainted))
        if isinstance(node, ast.UnaryOp):
            return self._tainted_walk(info, node.operand, tainted)
        if isinstance(node, ast.IfExp):
            return (self._tainted_walk(info, node.body, tainted)
                    or self._tainted_walk(info, node.orelse, tainted))
        return False

    def local_tainted(self, info: FunctionInfo,
                      seed: FrozenSet[str] = frozenset()) -> Set[str]:
        """Names in ``info`` bound to shape-derived ints (simple forward
        pass; one iteration to a small fixpoint for straight-line reuse)."""
        tainted: Set[str] = set(seed)
        for _ in range(3):
            before = len(tainted)
            for node in body_walk(info.node):
                if isinstance(node, ast.Assign):
                    if self._tainted_walk(info, node.value, tainted):
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                tainted.add(t.id)
                elif isinstance(node, ast.AugAssign):
                    if (isinstance(node.target, ast.Name)
                            and self._tainted_walk(info, node.value,
                                                   tainted)):
                        tainted.add(node.target.id)
            if len(tainted) == before:
                break
        return tainted

    def _program_site_for_call(self, info: FunctionInfo, node: ast.Call
                               ) -> Optional[Tuple[str, DeviceProgramSite]]:
        dotted = info.sf.dotted(node.func)
        if dotted in self.program_by_qual:
            return dotted, self.program_by_qual[dotted]
        qual = self.graph.resolve_call(info, node)[0]
        if qual is not None and qual in self.graph.functions:
            target = self.graph.functions[qual]
            for site in self.local_sites.get(target.sf.rel, ()):
                if site.fn is target.node:
                    return qual, site
        if isinstance(node.func, ast.Name):
            for site in self.local_sites.get(info.sf.rel, ()):
                if site.fn.name == node.func.id:
                    return node.func.id, site
        return None

    @staticmethod
    def tensor_positions(site: DeviceProgramSite) -> Dict[int, str]:
        """positional index -> param name for the tensor (NON-host) params
        of a device program."""
        fn = site.fn
        args = fn.args
        params = [p.arg for p in
                  list(getattr(args, "posonlyargs", [])) + args.args]
        host = set(site.host_params or ())
        return {i: p for i, p in enumerate(params) if p not in host}

    def _summary(self, qual: str, stack: Tuple[str, ...]) -> FnTaintSummary:
        if qual in self.summaries:
            return self.summaries[qual]
        if qual in stack or len(stack) > 12:
            return FnTaintSummary()
        self.summaries[qual] = FnTaintSummary()  # cycle-safe placeholder
        info = self.graph.functions[qual]
        summary = FnTaintSummary()
        params = set(info.params)
        # which params reach a tensor position of a program, here or deeper
        tainted = self.local_tainted(info, frozenset())
        for cs in self.graph.calls.get(qual, ()):
            node = cs.node
            hit = self._program_site_for_call(info, node)
            if hit is not None:
                name, site = hit
                tensors = self.tensor_positions(site)
                for i, arg in enumerate(node.args):
                    if i not in tensors or not isinstance(arg, ast.Name):
                        continue
                    if arg.id in params:
                        summary.param_to_program.setdefault(
                            arg.id, (info.sf.rel, node.lineno, str(name)))
                continue
            if cs.callee is None or cs.callee not in self.graph.functions:
                continue
            sub = self._summary(cs.callee, stack + (qual,))
            callee_info = self.graph.functions[cs.callee]
            for pname, arg in cs.arg_bindings(callee_info):
                if (pname in sub.param_to_program
                        and isinstance(arg, ast.Name) and arg.id in params):
                    summary.param_to_program.setdefault(
                        arg.id, sub.param_to_program[pname])
        # does the function return a tainted expression?
        for node in body_walk(info.node):
            if isinstance(node, ast.Return) and node.value is not None:
                if self._tainted_walk(info, node.value, tainted):
                    summary.returns_tainted = True
                    break
        self.summaries[qual] = summary
        return summary

    def host_to_device_findings(self):
        """(path, line, message) for tainted values entering tensor
        positions of device programs — via a local variable or via a call
        that forwards a tainted argument into a param that reaches a
        program inside the callee.  Direct ``len(...)``/``.shape`` argument
        expressions are REP004's; only *traveled* taint fires here."""
        for qual, info in self.graph.functions.items():
            tainted = self.local_tainted(info)
            for cs in self.graph.calls.get(qual, ()):
                node = cs.node
                hit = self._program_site_for_call(info, node)
                if hit is not None:
                    name, site = hit
                    tensors = self.tensor_positions(site)
                    for i, arg in enumerate(node.args):
                        if i not in tensors:
                            continue
                        if not isinstance(arg, ast.Name):
                            continue  # direct exprs belong to REP004
                        if arg.id in tainted:
                            yield (info.sf.rel, node.lineno,
                                   f"{qual} passes '{arg.id}' — a "
                                   f"len()/.shape-derived Python int — as "
                                   f"tensor argument "
                                   f"'{tensors[i]}' of device program "
                                   f"{name}: a per-size host value where "
                                   f"the program takes a tensor; bucket it "
                                   f"(_bucket), wrap as a tensor, or "
                                   f"declare it a host parameter")
                    continue
                if cs.callee is None or cs.callee not in self.graph.functions:
                    continue
                sub = self.summaries.get(cs.callee)
                if sub is None or not sub.param_to_program:
                    continue
                callee_info = self.graph.functions[cs.callee]
                for pname, arg in cs.arg_bindings(callee_info):
                    if pname not in sub.param_to_program:
                        continue
                    if not isinstance(arg, ast.Name):
                        continue
                    if arg.id in tainted:
                        _, _, jname = sub.param_to_program[pname]
                        yield (info.sf.rel, node.lineno,
                               f"{qual} passes tainted '{arg.id}' "
                               f"(len()/.shape-derived) to "
                               f"{cs.callee}, whose param '{pname}' "
                               f"reaches a tensor argument of device "
                               f"program {jname}: bucket it (_bucket), "
                               f"wrap as a tensor, or declare it a host "
                               f"parameter")

    # -- device→host -------------------------------------------------------

    #: attributes of a tensor that are host metadata — reading them waits
    #: for nothing, so they clear device taint.  ``len(tensor)`` is
    #: ``shape[0]`` and equally host-side; ``x.size()`` is its shape.
    _STATIC_EXTRACTORS = frozenset({"shape", "ndim", "dtype", "size",
                                    "device"})
    #: tensor methods that copy the value to the host (and so wait for the
    #: device): the port's counterparts of concretizing a tracer
    _HOST_READS = frozenset({"item", "tolist", "cpu", "numpy"})

    @staticmethod
    def _is_static_split(test: ast.expr) -> bool:
        """``x is None`` / ``x is not None`` / isinstance, negated or not —
        the sanctioned static splits (REP001's required idiom)."""
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            test = test.operand
        if isinstance(test, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot))
                   for op in test.ops):
                return True
        if (isinstance(test, ast.Call)
                and isinstance(test.func, ast.Name)
                and test.func.id == "isinstance"):
            return True
        return False

    def _first_tainted_name(self, node: ast.expr,
                            tainted: Set[str]) -> Optional[str]:
        """First tainted Name in ``node`` that is used as a device VALUE —
        names under a static extractor (``x.shape``, ``len(x)``, ...) are
        skipped: those are host metadata, not device values."""
        if (isinstance(node, ast.Attribute)
                and node.attr in self._STATIC_EXTRACTORS):
            return None
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "len"):
            return None
        if isinstance(node, ast.Name):
            return node.id if node.id in tainted else None
        for child in ast.iter_child_nodes(node):
            got = self._first_tainted_name(child, tainted)
            if got is not None:
                return got
        return None

    def _sink(self, node: ast.AST):
        """(tested expression, verb) when ``node`` reads a value on the
        host: a branch, ternary or assert test, a ``bool``/``int``/
        ``float``/``range`` conversion, or a host-read method call."""
        if isinstance(node, (ast.If, ast.While)):
            return node.test, "branches on"
        if isinstance(node, ast.IfExp):
            return node.test, "selects on"
        if isinstance(node, ast.Assert):
            return node.test, "asserts on"
        if not isinstance(node, ast.Call):
            return None
        if (isinstance(node.func, ast.Name)
                and node.func.id in ("bool", "int", "float", "range")
                and node.args):
            return node.args[0], f"reads on the host (via {node.func.id}())"
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in self._HOST_READS):
            return node.func.value, \
                f"reads on the host (via .{node.func.attr}())"
        return None

    def device_escape_findings(self):
        """(path, line, message) for device values read on the host inside
        device programs and the helpers they call."""
        seen_fn: Set[Tuple[str, FrozenSet[str]]] = set()
        emitted: Set[Tuple[str, int]] = set()

        def scan(info: FunctionInfo, tensor_params: FrozenSet[str],
                 origin: str, depth: int):
            key = (info.qualname, tensor_params)
            if key in seen_fn or depth > 6:
                return
            seen_fn.add(key)
            tainted = self.local_tainted_device(info, tensor_params)
            for node in body_walk(info.node):
                got = self._sink(node)
                if got is None or self._is_static_split(got[0]):
                    continue
                test, what = got
                name = self._first_tainted_name(test, tainted)
                if name is None:
                    continue
                at = (info.sf.rel, node.lineno)
                if at in emitted:
                    continue
                emitted.add(at)
                yield (info.sf.rel, node.lineno,
                       f"{info.qualname} {what} '{name}', a tensor value "
                       f"from device program {origin}: the host waits for "
                       f"the device there, inside a GA generation that is "
                       f"queued without one; branch on a host parameter, "
                       f"keep it on the device (torch.where), or split "
                       f"statically with 'x is None'")
            # follow tainted args into project helpers
            for cs in self.graph.calls.get(info.qualname, ()):
                if cs.callee is None or cs.callee not in self.graph.functions:
                    continue
                callee = self.graph.functions[cs.callee]
                fwd = set()
                for pname, arg in cs.arg_bindings(callee):
                    if (isinstance(arg, ast.Name) and arg.id in tainted):
                        fwd.add(pname)
                if fwd:
                    yield from scan(callee, frozenset(fwd), origin,
                                    depth + 1)

        for rel, sites in self.local_sites.items():
            for site in sites:
                qual = self._qual_of_site(site)
                if qual is None:
                    continue
                info = self.graph.functions[qual]
                tensors = frozenset(self.tensor_positions(site).values())
                if tensors:
                    yield from scan(info, tensors, site.fn.name, 0)

    def local_tainted_device(self, info: FunctionInfo,
                             seed: FrozenSet[str]) -> Set[str]:
        """Device-taint propagation: anything assigned from an expression
        holding a tainted name (outside a static extractor) is tainted."""
        tainted: Set[str] = set(seed)
        for _ in range(3):
            before = len(tainted)
            for node in body_walk(info.node):
                if isinstance(node, ast.Assign):
                    if self._first_tainted_name(node.value,
                                                tainted) is not None:
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                tainted.add(t.id)
                            elif isinstance(t, (ast.Tuple, ast.List)):
                                for e in t.elts:
                                    if isinstance(e, ast.Name):
                                        tainted.add(e.id)
            if len(tainted) == before:
                break
        return tainted

    def _qual_of_site(self, site: DeviceProgramSite) -> Optional[str]:
        for qual, info in self.graph.functions.items():
            if info.node is site.fn:
                return qual
        return None

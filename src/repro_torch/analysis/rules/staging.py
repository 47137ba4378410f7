"""staging-reuse — a page-locked host buffer written again while a copy
from it may still be in flight (the port's counterpart of R2,
``donation-aliasing``).

PyTorch has no donation. The hazard that takes its place on the streaming
path is the reverse one: ``x.to(dev, non_blocking=True)`` from page-locked
(pinned) host memory returns at once and the card reads ``x`` later, when
the copy reaches the head of its stream. Writing ``x`` again before then
(``copy_``, ``x[...] = ...``, ``fill_``, ``zero_``) changes what the card
reads: the copy lands the new row, silently. It is safe only after
something has waited for the stream (a ``.synchronize()``, a device->host
read on the same stream, such as ``.item()``/``.cpu()``) or at a declared
fence.

Pinned buffers are ``torch.zeros/empty/ones/full(..., pin_memory=...)``
and ``.pin_memory()`` results, bound to a name or to ``self.<attr>`` in any
method of the class; views of them (``buf[i]``) are the same buffer. The
walk is per function and in statement order, like ``donation.py``'s:
branches are traversed linearly, a loop body is walked once (a write at
the top of the next iteration is not seen), and a per-function rule cannot
see across calls. The port's two such buffers rely on exactly that cross-call
argument, which no rule here checks:

* ``SlotStreamRuntime._rows`` (``serving/slot_runtime.py``): row ``li`` is
  written and copied in ``_slot_args``, once per MoE layer;
* ``ShardedSlotRuntime._perm_rows``: rows ``(li, 0..2)`` are written and
  copied in ``_expert_fn``.

Each row is rewritten only one step later, for the same layer; between
the two, every MoE layer's routed-id read (``idx.cpu()`` in
``SlotStreamRuntime.decode``/``prefill``, the declared fence) waits for
the compute stream, and so for the copy. A path that reaches ``_slot_args``
twice for one layer without that read would race, unseen.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.analysis.callgraph import CallGraph, FuncInfo, call_attr_name
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import rule
from repro_torch.analysis.rules.host_sync import (
    Taint, _kw, _linear_stmts, _path, fence_of, hazards, in_scope)
from repro_torch.analysis.source import ModuleSource

_PIN_FACTORIES = {"zeros", "empty", "ones", "full", "zeros_like",
                  "empty_like", "ones_like", "full_like", "tensor"}
_WRITES = {"copy_", "fill_", "zero_", "index_copy_", "index_fill_",
           "scatter_", "masked_fill_", "add_", "mul_", "clamp_"}


def _base(node: ast.AST) -> Optional[str]:
    """The buffer a path names: strip subscripts (``self._rows[li]`` ->
    ``self._rows``)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return _path(node)


def _pinned_value(value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    name = call_attr_name(value.func)
    if name == "pin_memory":
        return True
    if name in _PIN_FACTORIES:
        pin = _kw(value, "pin_memory")
        return pin is not None and not (isinstance(pin, ast.Constant)
                                        and not pin.value)
    return False


def _pinned_attrs(graph: CallGraph) -> Dict[str, Set[str]]:
    """class key -> attrs bound to pinned buffers in any of its methods."""
    memo = graph.cache.get("pinned_attrs")
    if memo is not None:
        return memo                                   # type: ignore
    out: Dict[str, Set[str]] = {}
    for fi in graph.functions:
        ci = graph.class_of(fi)
        if ci is None or isinstance(fi.node, ast.Lambda):
            continue
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Assign) and _pinned_value(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        out.setdefault(ci.key(), set()).add(t.attr)
                        for sub in graph.subclasses_of(ci):
                            out.setdefault(sub.key(), set()).add(t.attr)
    graph.cache["pinned_attrs"] = out
    return out


class _State:
    def __init__(self, fi: FuncInfo, graph: CallGraph,
                 findings: List[Finding]):
        self.fi = fi
        self.m = fi.module
        self.graph = graph
        self.findings = findings
        ci = graph.class_of(fi)
        self.pinned: Set[str] = {
            f"self.{a}" for a in _pinned_attrs(graph).get(
                ci.key(), ()) } if ci is not None else set()
        self.alias: Dict[str, str] = {}          # view name -> buffer
        self.in_flight: Dict[str, int] = {}      # buffer -> copy lineno
        self.taint = Taint(fi, graph)

    def buffer(self, node: ast.AST) -> Optional[str]:
        b = _base(node)
        if b is None:
            return None
        b = self.alias.get(b, b)
        return b if b in self.pinned else None

    def _flag(self, node: ast.AST, buf: str, how: str) -> None:
        self.findings.append(Finding(
            rule="staging-reuse", path=self.m.relpath, line=node.lineno,
            col=node.col_offset,
            message=f"page-locked buffer '{buf}' is written ({how}) while "
                    "a non_blocking copy from it may still be in flight",
            hint="wait for the stream (or a declared fence) before the "
                 "write, or stage into another row",
            qualname=self.fi.qualname, code=self.m.line_text(node.lineno)))
        self.in_flight.pop(buf, None)

    def write(self, node: ast.AST, target: ast.AST, how: str) -> None:
        buf = self.buffer(target)
        if buf is not None and buf in self.in_flight:
            self._flag(node, buf, how)

    def scan(self, expr: Optional[ast.AST]) -> None:
        """Writes, copies and syncs inside one expression, in order."""
        if expr is None:
            return
        if any(True for _ in hazards(expr, self.taint)):
            self.in_flight.clear()
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            name = call_attr_name(node.func)
            if name in _WRITES and isinstance(node.func, ast.Attribute):
                self.write(node, node.func.value, f".{name}()")
            if name == "to" and isinstance(node.func, ast.Attribute):
                nb = _kw(node, "non_blocking")
                buf = self.buffer(node.func.value)
                if buf is not None and isinstance(nb, ast.Constant) \
                        and nb.value is True:
                    self.in_flight[buf] = node.lineno
            if name == "copy_" and isinstance(node.func, ast.Attribute):
                nb = _kw(node, "non_blocking")
                src = self.buffer(node.args[0]) if node.args else None
                if src is not None and isinstance(nb, ast.Constant) \
                        and nb.value is True:
                    self.in_flight[src] = node.lineno
            if self.in_flight:
                for callee in self.graph.resolve_target(self.m, node.func,
                                                         self.fi):
                    if fence_of(callee.module, callee) is not None:
                        self.in_flight.clear()

    def bind(self, targets, value: ast.AST) -> None:
        src = self.buffer(value) if isinstance(
            value, (ast.Name, ast.Attribute, ast.Subscript)) else None
        for t in targets:
            p = _path(t)
            if p is None:
                continue
            if _pinned_value(value):
                self.pinned.add(p)
                self.in_flight.pop(p, None)
            elif src is not None and isinstance(t, ast.Name):
                self.alias[p] = src
            else:
                self.alias.pop(p, None)
                if isinstance(t, ast.Name):
                    self.pinned.discard(p)


@rule("staging-reuse",
      "a page-locked host buffer written again while a non_blocking copy "
      "from it may be in flight (no stream sync or fence in between)")
def check_staging(modules: Sequence[ModuleSource],
                  graph: CallGraph) -> List[Finding]:
    findings: List[Finding] = []
    for fi in graph.functions:
        if isinstance(fi.node, ast.Lambda) or not in_scope(fi.module):
            continue
        st = _State(fi, graph, findings)
        nested = {id(c.node) for c in fi.children.values()}
        for stmt in _linear_stmts(fi.node.body):
            if id(stmt) in nested or isinstance(
                    stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
                continue
            if isinstance(stmt, ast.Assign):
                st.scan(stmt.value)
                for t in stmt.targets:
                    if isinstance(t, ast.Subscript):
                        st.write(stmt, t, "item assignment")
                st.taint.assign(stmt.targets, stmt.value)
                st.bind(stmt.targets, stmt.value)
            elif isinstance(stmt, ast.AugAssign):
                st.scan(stmt.value)
                st.write(stmt, stmt.target, "in-place update")
            elif isinstance(stmt, (ast.Expr, ast.Return)):
                st.scan(stmt.value)
            elif isinstance(stmt, (ast.If, ast.While, ast.Assert)):
                st.scan(stmt.test)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                st.scan(stmt.iter)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    st.scan(item.context_expr)
    return findings

"""capture-hazard — what breaks or silently freezes a CUDA-graph capture
(the port's counterpart of R1, ``recompile-hazard``).

ROADMAP §1 item 4 captures the declared step entries
(``callgraph.STEP_ENTRIES``) as CUDA graphs, as the reference jits them. A
capture records the device work a region enqueues and replays it later
without running its Python, so inside every function reachable from a
step entry four patterns are hazards:

* **host syncs** — everything ``host-sync`` detects, fence or not: a
  capture cannot wait for the card, and a host value read inside it is
  frozen at capture time. A declared fence inside a step entry is where
  item 4 must split the capture, and is reported as such;
* **data-dependent shapes** — ``nonzero``, ``masked_select``, ``unique``,
  ``torch.where(cond)``, boolean-mask indexing and ``repeat_interleave``
  with tensor repeats size their output from the data; a graph's shapes
  are fixed;
* **host data built in the step** — ``torch.tensor``/``torch.as_tensor``
  of host data onto the card and ``.to(<device>)`` of a host tensor (as
  ``torch.from_numpy(x).to(dev)``): the copy's source is read once, at
  capture time. A 0-d CPU tensor used as a scalar operand
  (``x * torch.tensor(c, dtype=...)``) is not copied and is not a hazard;
* **captured mutables** (R1's own) — a reachable nested function reads a
  closure variable that the enclosing scope builds as a mutable container
  and mutates: the replay keeps what the capture saw.

A step's inputs arrive as parameters, so here (unlike ``host-sync``, which
follows the reference in tainting no parameter) every parameter that may
hold a tensor is tainted: all but ``self``/``cls``/``ctx``, those
annotated with a non-tensor type, and those with a number, string or bool
default.

The reference's two other R1 patterns have no counterpart: a
``float()``/``int()`` of a tensor is a host sync here (above), and a
Python loop over an argument unrolls in both eager and captured code
alike (the captured graph holds the unrolled work).
"""
from __future__ import annotations

import ast
from typing import List, Sequence, Set

from repro_torch.analysis.callgraph import CallGraph, FuncInfo, base_name
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import rule
from repro_torch.analysis.rules.host_sync import (fence_of, in_scope,
                                                  walk_function)
from repro_torch.analysis.source import ModuleSource

_MUTATORS = {"append", "extend", "add", "pop", "update", "remove",
             "insert", "clear", "setdefault", "popitem"}
_MUTABLE_CTORS = {"list", "dict", "set", "defaultdict", "deque", "Counter"}

_KIND_TEXT = {
    "sync": "host sync",
    "test": "host sync",
    "shape": "data-dependent shape",
    "upload": "host data copied onto the device",
}


def _own_body(fi: FuncInfo):
    """Statements of fi excluding nested function/lambda bodies (the
    reference's ``recompile._own_body``)."""
    nested = {id(c.node) for c in fi.children.values()}
    body = fi.node.body if isinstance(fi.node.body, list) else [fi.node.body]

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if id(child) in nested or isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
                continue
            yield child
            yield from walk(child)

    for stmt in body:
        yield stmt
        yield from walk(stmt)


def _locals_of(fi: FuncInfo) -> Set[str]:
    out = set(fi.params)
    for node in _own_body(fi):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
        elif isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
            for n in ast.walk(node.target):
                if isinstance(n, ast.Name):
                    out.add(n.id)
    return out


def _mutable_locals(fi: FuncInfo) -> Set[str]:
    """Names this scope both builds as a mutable container and mutates."""
    built: Set[str] = set()
    mutated: Set[str] = set()
    for node in _own_body(fi):
        if isinstance(node, ast.Assign):
            v = node.value
            is_mut = isinstance(v, (ast.List, ast.Dict, ast.Set,
                                    ast.ListComp, ast.DictComp, ast.SetComp))
            if isinstance(v, ast.Call) and isinstance(v.func, ast.Name) \
                    and v.func.id in _MUTABLE_CTORS:
                is_mut = True
            for t in node.targets:
                if is_mut and isinstance(t, ast.Name):
                    built.add(t.id)
                if isinstance(t, ast.Subscript) and base_name(t):
                    mutated.add(base_name(t))
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _MUTATORS and base_name(node.func.value):
            mutated.add(base_name(node.func.value))
        if isinstance(node, ast.AugAssign) and \
                isinstance(node.target, (ast.Name, ast.Subscript)) and \
                base_name(node.target):
            mutated.add(base_name(node.target))
    return built & mutated


def _captured_mutables(fi: FuncInfo) -> List[ast.Name]:
    """Free reads in ``fi`` of a mutated container that an enclosing
    function builds (R1's check)."""
    anc = set()
    p = fi.parent
    while p is not None:
        anc |= _mutable_locals(p)
        p = p.parent
    if not anc:
        return []
    own = _locals_of(fi)
    out, seen = [], set()
    for node in _own_body(fi):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                and node.id in anc and node.id not in own \
                and node.id not in seen:
            seen.add(node.id)
            out.append(node)
    return out


@rule("capture-hazard",
      "what breaks or freezes a CUDA-graph capture of a declared step "
      "entry: host syncs (fences included), data-dependent shapes, host "
      "data copied onto the device, captured mutable closures")
def check_capture(modules: Sequence[ModuleSource],
                  graph: CallGraph) -> List[Finding]:
    findings: List[Finding] = []
    for fi in graph.functions:
        m = fi.module
        if not graph.is_reachable(fi) or not in_scope(m):
            continue
        entries = ", ".join(sorted(set(graph.entries_reaching(fi))))

        def emit(node, msg, hint):
            findings.append(Finding(
                rule="capture-hazard", path=m.relpath, line=node.lineno,
                col=node.col_offset, message=msg, hint=hint,
                qualname=fi.qualname, code=m.line_text(node.lineno)))

        fence = fence_of(m, fi)
        for node, kind, what in walk_function(fi, graph, params=True):
            if fence is not None:
                emit(node, f"declared fence {fence[1]} inside the capture "
                           f"of {entries}: {what}",
                     "split the capture around the fence: capture the "
                     "pieces on either side of it")
            else:
                emit(node, f"{_KIND_TEXT[kind]} inside the capture of "
                           f"{entries}: {what}",
                     "keep the value on the device and the shape fixed, "
                     "or move this out of the captured region")
        for node in _captured_mutables(fi):
            emit(node, f"captured function reads closure variable "
                       f"'{node.id}' that the enclosing scope builds as a "
                       "mutable container and mutates",
                 "pass it as an argument or freeze it to a tuple: a replay "
                 "keeps what the capture saw")
    return findings

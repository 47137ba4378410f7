"""kernel-launch — the discipline of the kernels' Python launch wrappers
(the port's counterpart of R4, ``pallas-purity``).

The reference's kernels are Pallas bodies, so R4 checks that a body
touches only its Refs. The port's kernels are CUDA C++ (``kernels/csrc``,
built by ``kernels/build.py``), whose purity no AST can see; what Python
controls is the launch, and ROADMAP's rules of the port state what a
launch must do. In every function that calls a handle returned by
``build.load`` (a launch site of the device-boundary graph):

* the launch's returned error code is bound and passed to ``build.check``
  (an unchecked launch fails silently: the next op reports someone else's
  error, or nothing);
* no ``try`` encloses the launch: a CUDA tensor launches the kernel or
  raises, never falls back;
* ``build.check_no_grad`` guards the inputs, unless the function is the
  ``forward`` of a ``torch.autograd.Function`` (which runs with the
  gradient off and puts the output on the graph itself): a raw launch
  writes through pointers, and its output would sit off the graph;
* the module's ``launches`` counter (a module-level int named
  ``*launches``) is bumped with ``global``: ``chip_smoke.py`` proves that
  the main path ran through the kernels by these counts.

And everywhere: a kernel's plain version (``kernels/ref.py::*_ref``) runs
only under a ``<tensor>.device.type == "cpu"`` test, and a stand-in of
``kernels/meta.py`` only under ``== "meta"`` (as ``kernels/ops.py``
dispatches). Called on any other path, either is a fallback.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.callgraph import (CallGraph, FuncInfo, LaunchSite,
                                            call_attr_name)
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import rule
from repro_torch.analysis.rules.capture import _own_body
from repro_torch.analysis.source import ModuleSource

_HINT = ("launch through the wrapper pattern of kernels/flash_decode.py: "
         "check_no_grad, err = fn(...), build.check(name, err), "
         "launches += 1, no try around it")


def _parents(fi: FuncInfo) -> Dict[int, ast.AST]:
    out: Dict[int, ast.AST] = {}
    for node in ast.walk(fi.node):
        for child in ast.iter_child_nodes(node):
            out[id(child)] = node
    return out


def _calls(fi: FuncInfo):
    for node in ast.walk(fi.node):
        if isinstance(node, ast.Call):
            yield node


def _is_build_call(graph: CallGraph, fi: FuncInfo, call: ast.Call,
                   name: str) -> bool:
    if call_attr_name(call.func) != name:
        return False
    if isinstance(call.func, ast.Attribute):
        return graph.is_module_alias(fi.module, call.func.value,
                                     "kernels.build") or \
            fi.module.relpath.endswith("kernels/build.py")
    src, orig = graph.from_import_of(fi.module, name)
    return orig == name and src.endswith("kernels.build")


def _module_counters(m: ModuleSource) -> List[str]:
    out = []
    for stmt in m.tree.body:
        if isinstance(stmt, ast.Assign):
            names = [t.id for t in stmt.targets if isinstance(t, ast.Name)]
            v = stmt.value
            if isinstance(v, ast.Constant) and isinstance(v.value, int):
                out.extend(n for n in names if n.endswith("launches"))
    return out


def _bumps_counter(fi: FuncInfo, counters: List[str]) -> bool:
    declared = {n for node in ast.walk(fi.node)
                if isinstance(node, ast.Global) for n in node.names}
    for node in ast.walk(fi.node):
        if isinstance(node, ast.AugAssign) and \
                isinstance(node.op, ast.Add) and \
                isinstance(node.target, ast.Name) and \
                node.target.id in counters and node.target.id in declared:
            return True
    return False


def _is_autograd_forward(graph: CallGraph, fi: FuncInfo) -> bool:
    ci = graph.class_of(fi)
    return ci is not None and ci in graph.autograd_functions and \
        fi.name == "forward"


def _device_branch(parents: Dict[int, ast.AST], node: ast.AST) -> str:
    """'cpu'/'meta' when ``node`` lies in the taken branch of an
    ``<x>.device.type == '<kind>'`` (or ``!=`` else) test."""
    child, cur = node, parents.get(id(node))
    while cur is not None:
        if isinstance(cur, ast.If):
            t = cur.test
            if isinstance(t, ast.Compare) and len(t.ops) == 1 and \
                    isinstance(t.left, ast.Attribute) and \
                    t.left.attr == "type" and \
                    isinstance(t.left.value, ast.Attribute) and \
                    t.left.value.attr == "device" and \
                    isinstance(t.comparators[0], ast.Constant):
                kind = t.comparators[0].value
                in_body = any(child is s for s in cur.body)
                if isinstance(t.ops[0], ast.Eq) and in_body:
                    return str(kind)
                if isinstance(t.ops[0], ast.NotEq) and not in_body:
                    return str(kind)
        child, cur = cur, parents.get(id(cur))
    return ""


def _plain_kind(graph: CallGraph, target: FuncInfo) -> str:
    path = target.module.relpath
    if path.endswith("kernels/ref.py") and target.name.endswith("_ref"):
        return "cpu"
    if path.endswith("kernels/meta.py") and target.parent is None and \
            not target.class_name:
        return "meta"
    return ""


def _check_site(graph: CallGraph, site: LaunchSite,
                emit) -> None:
    fi = site.fi
    parents = _parents(fi)
    # the error code reaches build.check
    checked = site.result is not None and any(
        _is_build_call(graph, fi, c, "check") and any(
            isinstance(a, ast.Name) and a.id == site.result
            for a in c.args)
        for c in _calls(fi))
    if not checked:
        emit(site.call, f"launch of kernel '{site.kernel}' does not pass its "
                        "error code to build.check")
    cur: Optional[ast.AST] = parents.get(id(site.call))
    while cur is not None:
        if isinstance(cur, ast.Try):
            emit(site.call, f"launch of kernel '{site.kernel}' inside a "
                            "try: a CUDA tensor launches or raises")
            break
        cur = parents.get(id(cur))
    guarded = any(_is_build_call(graph, fi, c, "check_no_grad")
                  for c in _calls(fi))
    if not guarded and not _is_autograd_forward(graph, fi):
        emit(site.call, f"launch of kernel '{site.kernel}' without "
                        "build.check_no_grad on its inputs (and not an "
                        "autograd Function's forward)")
    if not _bumps_counter(fi, _module_counters(fi.module)):
        emit(site.call, f"launch of kernel '{site.kernel}' does not bump "
                        "the module's launches counter")


@rule("kernel-launch",
      "CUDA kernel launch wrappers: error code checked, no try around the "
      "launch, check_no_grad (or an autograd Function), launches counted; "
      "plain versions and meta stand-ins only on their device branch")
def check_kernel_launch(modules: Sequence[ModuleSource],
                        graph: CallGraph) -> List[Finding]:
    findings: List[Finding] = []

    def emitter(fi: FuncInfo):
        def emit(node, msg, hint=_HINT):
            findings.append(Finding(
                rule="kernel-launch", path=fi.module.relpath,
                line=node.lineno, col=node.col_offset, message=msg,
                hint=hint, qualname=fi.qualname,
                code=fi.module.line_text(node.lineno)))
        return emit

    for site in graph.launch_sites:
        _check_site(graph, site, emitter(site.fi))
    for fi in graph.functions:
        path = fi.module.relpath
        if not path.startswith("src/repro_torch") or \
                path.startswith("src/repro_torch/analysis") or \
                path.endswith(("kernels/ref.py", "kernels/meta.py")):
            continue
        parents = None
        for node in _own_body(fi):
            if not isinstance(node, ast.Call):
                continue
            for target in graph.resolve_target(fi.module, node.func, fi):
                kind = _plain_kind(graph, target)
                if not kind:
                    continue
                parents = parents or _parents(fi)
                if _device_branch(parents, node) != kind:
                    emitter(fi)(
                        node, f"{target.name}() reached outside a "
                              f"device.type == '{kind}' branch: a "
                              "fallback",
                        "dispatch on the tensor's device as kernels/ops.py "
                        "does; a CUDA tensor launches the kernel or raises")
    return findings

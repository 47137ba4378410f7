"""R5 — config-drift.

A config dataclass field that nothing reads is a silent lie: benchmarks
sweep it, DESIGN.md documents it, and the runtime ignores it. A field that
is read but cannot be set from ``build_engine``/``serve.py`` argparse is
half-plumbed: the paper's ablation for that knob cannot be reproduced from
the CLI. Both drifts accumulate invisibly as PRs add knobs.

For every ``@dataclass`` whose name ends in ``Config`` or ``Spec`` this
rule checks:

* **unread** — the field name is never read as an attribute
  (``something.field``) anywhere in the scanned tree (the declaration
  itself is an annotation, not a read, so it does not count; reads inside
  the config's own methods do);
* **unplumbed** — for the serving-path configs (``EngineConfig``,
  ``OffloadConfig``, ``HWConfig``) only: the field is none of (a) an
  ``add_argument("--field")`` option (dashes/underscores normalized),
  (b) a keyword to the config's constructor or ``dataclasses.replace``
  inside a ``launch/`` module or a ``build_engine`` function, (c) a
  keyword *forwarded from a parent config* at any constructor site in
  ``src/`` (``prefetch=cfg.prefetch`` — the parent's field is then the
  one under scrutiny). Architecture preset configs (``ArchConfig`` etc.)
  are set via ``--arch`` presets, not per-field flags, so they only get
  the unread check.

Derived/internal fields that are intentionally not CLI-settable belong in
the baseline with a reason saying so.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Sequence, Set, Tuple

from repro_torch.analysis.callgraph import CallGraph, call_attr_name
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import rule
from repro_torch.analysis.source import ModuleSource


def _is_dataclass_config(node: ast.ClassDef) -> bool:
    if not (node.name.endswith("Config") or node.name.endswith("Spec")):
        return False
    for dec in node.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if call_attr_name(target) == "dataclass":
            return True
    return False


def _fields(node: ast.ClassDef) -> List[Tuple[str, int, int]]:
    out = []
    for stmt in node.body:
        if isinstance(stmt, ast.AnnAssign) and \
                isinstance(stmt.target, ast.Name) and \
                not stmt.target.id.startswith("_"):
            out.append((stmt.target.id, stmt.lineno, stmt.col_offset))
    return out


def _norm(opt: str) -> str:
    return opt.lstrip("-").replace("-", "_")


# configs that must be fully CLI-settable (paper knobs swept by the CLI).
# The *Spec dataclasses are the redesigned serving surface (DESIGN.md §11):
# every field must be reachable from serve.py argparse or a constructor in
# launch/build_engine code (their field-by-field ``from_dict`` classmethods
# satisfy the forwarded-kwarg clause, keeping JSON specs CLI-equivalent).
PLUMBED_CLASSES = frozenset({"EngineConfig", "OffloadConfig", "HWConfig",
                             "ServeSpec", "TenantSpec", "PredictorSpec"})


@rule("config-drift",
      "config dataclass fields that are never read, or not plumbed "
      "through build_engine/serve.py argparse")
def check_config_drift(modules: Sequence[ModuleSource],
                       graph: CallGraph) -> List[Finding]:
    configs: List[Tuple[ModuleSource, ast.ClassDef]] = []
    for m in modules:
        if m.tree is None:
            continue
        for node in ast.walk(m.tree):
            if isinstance(node, ast.ClassDef) and _is_dataclass_config(node):
                configs.append((m, node))
    if not configs:
        return []

    attr_reads: Set[str] = set()
    argparse_opts: Set[str] = set()
    plumbed_kwargs: Dict[str, Set[str]] = {}
    replace_kwargs: Set[str] = set()
    cfg_names = {cls.name for _, cls in configs}

    for m in modules:
        if m.tree is None:
            continue
        in_launch = "/launch/" in f"/{m.relpath}"
        in_src = m.relpath.startswith("src/") or in_launch
        build_spans = [
            (n.lineno, getattr(n, "end_lineno", n.lineno) or n.lineno)
            for n in ast.walk(m.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and "build_engine" in n.name]
        for node in ast.walk(m.tree):
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.ctx, ast.Load):
                attr_reads.add(node.attr)
            elif isinstance(node, ast.Call):
                cname = call_attr_name(node.func)
                if cname == "add_argument":
                    for a in node.args:
                        if isinstance(a, ast.Constant) and \
                                isinstance(a.value, str) and \
                                a.value.startswith("-"):
                            argparse_opts.add(_norm(a.value))
                in_build = any(a <= node.lineno <= b
                               for a, b in build_spans)
                if cname == "replace" and (in_launch or in_build):
                    replace_kwargs.update(
                        kw.arg for kw in node.keywords if kw.arg)
                if cname in cfg_names:
                    dest = plumbed_kwargs.setdefault(cname, set())
                    for kw in node.keywords:
                        if kw.arg is None:   # **kwargs forwarding
                            if in_launch or in_build:
                                dest.add("*")
                        elif in_launch or in_build:
                            dest.add(kw.arg)
                        elif in_src and any(
                                isinstance(n, ast.Attribute)
                                for n in ast.walk(kw.value)):
                            # forwarded from a parent config object
                            dest.add(kw.arg)

    findings: List[Finding] = []
    for m, cls in configs:
        kw = plumbed_kwargs.get(cls.name, set())
        forwarded = "*" in kw
        for fname, line, col in _fields(cls):
            if fname not in attr_reads:
                findings.append(Finding(
                    rule="config-drift", path=m.relpath, line=line, col=col,
                    message=f"{cls.name}.{fname} is never read outside its "
                            "definition",
                    hint="wire the field into the runtime or delete it; a "
                         "knob nobody reads silently no-ops in benchmarks",
                    qualname=cls.name, code=m.line_text(line)))
            elif cls.name in PLUMBED_CLASSES and \
                    fname not in argparse_opts and fname not in kw \
                    and fname not in replace_kwargs and not forwarded:
                findings.append(Finding(
                    rule="config-drift", path=m.relpath, line=line, col=col,
                    message=f"{cls.name}.{fname} is not settable from the "
                            "CLI (no argparse option, not passed to the "
                            "constructor in launch/build_engine)",
                    hint="add an add_argument('--"
                         f"{fname.replace('_', '-')}') or baseline with a "
                         "reason if the field is intentionally internal",
                    qualname=cls.name, code=m.line_text(line)))
    return findings

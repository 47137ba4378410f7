"""Rule registry.

A rule is a callable ``(modules, graph) -> List[Finding]`` registered under
a stable id. Rules see the whole scanned tree at once (plus the shared
device-boundary :class:`~repro_torch.analysis.callgraph.CallGraph`) so
cross-module checks (step reachability, launch sites, config plumbing) need
no per-rule re-parsing. The reference's registry; only ``_load`` differs:
it imports the port's rule modules.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

from repro_torch.analysis.callgraph import CallGraph
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.source import ModuleSource

RuleFn = Callable[[Sequence[ModuleSource], CallGraph], List[Finding]]

_REGISTRY: Dict[str, RuleFn] = {}
_DOCS: Dict[str, str] = {}


def rule(rule_id: str, doc: str) -> Callable[[RuleFn], RuleFn]:
    def deco(fn: RuleFn) -> RuleFn:
        if rule_id in _REGISTRY:
            raise ValueError(f"duplicate rule id: {rule_id}")
        _REGISTRY[rule_id] = fn
        _DOCS[rule_id] = doc
        return fn
    return deco


def all_rules() -> Dict[str, RuleFn]:
    _load()
    return dict(_REGISTRY)


def rule_docs() -> Dict[str, str]:
    _load()
    return dict(_DOCS)


def _load() -> None:
    # import for side effect: each module registers its rule(s)
    from repro_torch.analysis.rules import (  # noqa: F401
        capture, config_drift, host_sync, kernel_launch, staging)

"""CLI entry point: ``python -m repro_torch.analysis.lint [options] [paths...]``.

The reference's CLI (``repro.analysis.lint``) over the port: the
default path is ``src/repro_torch``, the default baseline is the port's
own (``src/repro_torch/analysis/baseline.json``, kept empty: every
sanctioned finding is a declared fence or step entry, or a ``torch-lint``
directive with its reason), and ``--capture-map`` writes the
device-boundary graph where the reference's ``--jit-map`` writes its
jit-boundary graph.

Pipeline: collect ``.py`` files → parse (syntax errors become findings) →
build the device-boundary call graph → run every registered rule → drop
findings covered by an inline suppression → absorb findings matched by the
committed baseline → report.

Exit codes: ``0`` clean (everything suppressed/baselined), ``1`` new
findings, ``2`` usage or environment error (unreadable baseline, no
files). ``--json`` / ``--capture-map`` write machine-readable artifacts
for CI upload regardless of exit code.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.baseline import (Baseline, BaselineError,
                                          write_baseline)
from repro_torch.analysis.callgraph import STEP_ENTRIES, CallGraph
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import all_rules, rule_docs
from repro_torch.analysis.rules.host_sync import DECLARED_FENCES
from repro_torch.analysis.source import ModuleSource, collect_py_files

DEFAULT_BASELINE = "src/repro_torch/analysis/baseline.json"
DEFAULT_PATHS = ["src/repro_torch"]


def find_repo_root(start: Optional[Path] = None) -> Path:
    cur = (start or Path.cwd()).resolve()
    for cand in [cur, *cur.parents]:
        if (cand / ".git").exists():
            return cand
    return cur


class LintResult:
    def __init__(self):
        self.new_findings: List[Finding] = []
        self.baselined: List[Dict] = []       # finding json + reason
        self.suppressed: List[Dict] = []      # finding json + reason
        self.warnings: List[str] = []
        self.exit_code = 0
        self.graph: Optional[CallGraph] = None
        self.n_files = 0

    def to_json(self) -> dict:
        return {
            "summary": {
                "files": self.n_files,
                "new": len(self.new_findings),
                "baselined": len(self.baselined),
                "suppressed": len(self.suppressed),
                "declared_fences": len(DECLARED_FENCES),
                "step_entries": len(STEP_ENTRIES),
                "exit_code": self.exit_code,
            },
            "rules": rule_docs(),
            "findings": [f.to_json() for f in self.new_findings],
            "baselined": self.baselined,
            "suppressed": self.suppressed,
            "warnings": self.warnings,
        }


def run_lint(paths: Sequence, root: Optional[Path] = None,
             baseline: Optional[Baseline] = None,
             select: Optional[Sequence[str]] = None) -> LintResult:
    res = LintResult()
    root = Path(root) if root is not None else find_repo_root()
    files = collect_py_files(paths)
    res.n_files = len(files)
    modules = [ModuleSource(p, root) for p in files]

    raw: List[Finding] = []
    for m in modules:
        if m.parse_error is not None:
            raw.append(m.parse_error)
        raw.extend(m.suppression_findings)

    graph = CallGraph(modules)
    res.graph = graph
    rules = all_rules()
    known = set(rules)
    for m in modules:
        raw.extend(m.known_rule_check(known))
    for rid, fn in sorted(rules.items()):
        if select and rid not in select:
            continue
        raw.extend(fn(modules, graph))

    by_path = {m.relpath: m for m in modules}
    raw.sort(key=lambda f: (f.rule, f.path, f.line, f.col, f.message))
    for f in raw:
        m = by_path.get(f.path)
        sup = m.suppression_for(f.line, f.rule) if m is not None else None
        if sup is not None and f.rule != "suppression":
            sup.used = True
            res.suppressed.append(f.to_json() | {"reason": sup.reason})
            continue
        if baseline is not None:
            reason = baseline.absorb(f)
            if reason is not None:
                res.baselined.append(f.to_json() | {"reason": reason})
                continue
        res.new_findings.append(f)

    for m in modules:
        for sup in m.suppressions:
            if not sup.used:
                res.warnings.append(
                    f"{m.relpath}:{sup.line}: unused suppression "
                    f"({', '.join(sorted(sup.rules))})")
    if baseline is not None:
        for e in baseline.stale_entries():
            res.warnings.append(
                f"stale baseline entry: [{e['rule']}] {e['path']}: "
                f"{e['message']} — rerun with --write-baseline to prune")
    res.exit_code = 1 if res.new_findings else 0
    return res


def _report(res: LintResult, stream=None) -> None:
    out = stream or sys.stdout
    cur = None
    for f in res.new_findings:
        if f.rule != cur:
            cur = f.rule
            print(f"\n[{cur}]", file=out)
        print("  " + f.format().replace("\n", "\n  "), file=out)
    for w in res.warnings:
        print(f"warning: {w}", file=out)
    print(f"\n{res.n_files} files: {len(res.new_findings)} new, "
          f"{len(res.baselined)} baselined, "
          f"{len(res.suppressed)} suppressed, "
          f"{len(DECLARED_FENCES)} declared fences, "
          f"{len(STEP_ENTRIES)} step entries", file=out)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="PyTorch-aware static invariant checks of the port")
    ap.add_argument("paths", nargs="*", default=DEFAULT_PATHS,
                    help="files or directories to lint (default: "
                         "src/repro_torch)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: <repo>/{DEFAULT_BASELINE} "
                         "when present)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline; report everything")
    ap.add_argument("--write-baseline", metavar="PATH", default=None,
                    help="write current unsuppressed findings as a baseline "
                         "(reasons carried over where fingerprints match)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the full report as JSON")
    ap.add_argument("--capture-map", metavar="PATH", default=None,
                    help="write the device-boundary call graph (step "
                         "entries, what they reach, kernel launch sites) "
                         "as JSON")
    ap.add_argument("--select", action="append", default=None,
                    help="run only this rule id (repeatable)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, doc in sorted(rule_docs().items()):
            print(f"{rid}: {doc}")
        return 0

    root = find_repo_root()
    baseline = None
    old_baseline = None
    if not args.no_baseline:
        bpath = Path(args.baseline) if args.baseline \
            else root / DEFAULT_BASELINE
        if bpath.exists():
            try:
                baseline = Baseline.load(bpath)
                old_baseline = Baseline.load(bpath)
            except BaselineError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
        elif args.baseline:
            print(f"error: baseline not found: {bpath}", file=sys.stderr)
            return 2

    if args.write_baseline:
        res = run_lint(args.paths, root=root, baseline=None,
                       select=args.select)
        doc = write_baseline(args.write_baseline, res.new_findings,
                             old=old_baseline)
        todo = sum(1 for e in doc["entries"]
                   if str(e["reason"]).startswith("TODO"))
        print(f"wrote {args.write_baseline}: {len(doc['entries'])} entries"
              + (f" ({todo} need reasons filled in)" if todo else ""))
        return 0

    res = run_lint(args.paths, root=root, baseline=baseline,
                   select=args.select)
    if not res.n_files:
        print("error: no .py files matched", file=sys.stderr)
        return 2
    if args.json:
        Path(args.json).write_text(
            json.dumps(res.to_json(), indent=2) + "\n", encoding="utf-8")
    if args.capture_map and res.graph is not None:
        Path(args.capture_map).write_text(
            json.dumps(res.graph.to_json(), indent=2) + "\n",
            encoding="utf-8")
    _report(res)
    return res.exit_code


if __name__ == "__main__":
    sys.exit(main())

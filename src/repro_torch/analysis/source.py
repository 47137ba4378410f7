"""Parsed source modules + the inline-suppression syntax.

Suppression syntax (the reason is mandatory — a suppression without one is
itself a finding under the ``suppression`` meta-rule)::

    hazardous_line()   # torch-lint: disable=host-sync -- why this is safe

    # torch-lint: disable=capture-hazard,host-sync -- reason text
    hazardous_line_below_a_standalone_comment()

A suppression on a code line covers that line; a standalone comment line
covers the next line. ``disable=all`` suppresses every rule on the line.

The reference's ``repro.analysis.source`` with one change: the directive
prefix is ``torch-lint``, not ``repro-lint``. The reference's linter also
lints this package and turns a ``repro-lint`` directive naming a rule it
does not know into a finding; with a prefix of its own, each linter reads
only its own directives. A line that both must silence carries one as a
standalone comment above it and the other as a trailing comment.
"""
from __future__ import annotations

import ast
import io
import re
import tokenize
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.findings import Finding

_SUPPRESS_RE = re.compile(
    r"#\s*torch-lint:\s*disable=(?P<rules>[A-Za-z0-9_\-,\s]+?)"
    r"(?:\s*--\s*(?P<reason>.+?))?\s*$")
_MARKER_RE = re.compile(r"#\s*torch-lint:")


class Suppression:
    def __init__(self, line: int, rules: Set[str], reason: str):
        self.line = line          # the line the suppression *covers*
        self.rules = rules
        self.reason = reason
        self.used = False

    def covers(self, rule: str) -> bool:
        return "all" in self.rules or rule in self.rules


class ModuleSource:
    """One parsed .py file: text, AST, and its inline suppressions."""

    def __init__(self, path: Path, root: Path):
        self.path = Path(path)
        self.relpath = self._rel(self.path, root)
        self.text = self.path.read_text(encoding="utf-8")
        self.lines = self.text.splitlines()
        self.tree: Optional[ast.Module] = None
        self.parse_error: Optional[Finding] = None
        try:
            self.tree = ast.parse(self.text, filename=str(self.path))
        except SyntaxError as e:
            self.parse_error = Finding(
                rule="parse-error", path=self.relpath, line=e.lineno or 1,
                col=(e.offset or 1) - 1, message=f"syntax error: {e.msg}")
        self.suppressions: List[Suppression] = []
        self.suppression_findings: List[Finding] = []
        self._by_line: Dict[int, List[Suppression]] = {}
        self._parse_suppressions()

    @staticmethod
    def _rel(path: Path, root: Path) -> str:
        try:
            return path.resolve().relative_to(Path(root).resolve()).as_posix()
        except ValueError:
            return path.as_posix()

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def _comment_tokens(self) -> List[Tuple[int, str, bool]]:
        """(line, comment text, is_standalone) for every real comment —
        directives inside string literals/docstrings are not suppressions."""
        out = []
        try:
            toks = list(tokenize.generate_tokens(
                io.StringIO(self.text).readline))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return out
        for t in toks:
            if t.type == tokenize.COMMENT:
                standalone = self.lines[t.start[0] - 1][:t.start[1]] \
                    .strip() == ""
                out.append((t.start[0], t.string, standalone))
        return out

    # -- suppressions --------------------------------------------------------
    def _parse_suppressions(self) -> None:
        for i, raw, standalone in self._comment_tokens():
            if "torch-lint" not in raw:
                continue
            if not _MARKER_RE.search(raw):
                continue
            m = _SUPPRESS_RE.search(raw)
            if not m:
                self.suppression_findings.append(Finding(
                    rule="suppression", path=self.relpath, line=i, col=0,
                    message="malformed torch-lint directive",
                    hint="use: # torch-lint: disable=<rule>[,<rule>] "
                         "-- <reason>", code=raw.strip()))
                continue
            rules = {r.strip() for r in m.group("rules").split(",")
                     if r.strip()}
            reason = (m.group("reason") or "").strip()
            if not reason:
                self.suppression_findings.append(Finding(
                    rule="suppression", path=self.relpath, line=i, col=0,
                    message="suppression without a reason "
                            f"(rules: {', '.join(sorted(rules))})",
                    hint="append ' -- <why this finding is acceptable>'",
                    code=raw.strip()))
                continue
            # a standalone comment line covers the next line
            covers = i + 1 if standalone else i
            sup = Suppression(covers, rules, reason)
            self.suppressions.append(sup)
            self._by_line.setdefault(covers, []).append(sup)

    def suppression_for(self, line: int, rule: str) -> Optional[Suppression]:
        for sup in self._by_line.get(line, ()):
            if sup.covers(rule):
                return sup
        return None

    def known_rule_check(self, known: Set[str]) -> List[Finding]:
        out = []
        for sup in self.suppressions:
            bad = sup.rules - known - {"all"}
            if bad:
                out.append(Finding(
                    rule="suppression", path=self.relpath, line=sup.line,
                    col=0,
                    message="suppression names unknown rule(s): "
                            f"{', '.join(sorted(bad))}",
                    hint=f"known rules: {', '.join(sorted(known))}",
                    code=self.line_text(sup.line)))
        return out


def collect_py_files(paths) -> List[Path]:
    """Expand files/directories into a sorted, deduplicated .py file list
    (``__pycache__`` and hidden dirs skipped)."""
    seen, out = set(), []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            cands: Tuple[Path, ...] = tuple(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            cands = (p,)
        else:
            continue
        for c in cands:
            parts = c.parts
            if "__pycache__" in parts or any(
                    s.startswith(".") and len(s) > 1 for s in parts):
                continue
            r = c.resolve()
            if r not in seen:
                seen.add(r)
                out.append(c)
    return out

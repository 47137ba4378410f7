"""Findings: what a rule reports, and how a finding is identified.

A finding's *fingerprint* deliberately excludes the line number: baselines
key on ``(rule, path, source line text, message)`` so grandfathered
findings survive unrelated edits above them, while any change to the
flagged line itself (or to the message the rule derives from it)
invalidates the baseline entry and resurfaces the finding.
"""
from __future__ import annotations

import dataclasses
import hashlib


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str            # rule id, e.g. "recompile-hazard"
    path: str            # repo-relative posix path
    line: int            # 1-based
    col: int             # 0-based
    message: str         # one line, no embedded line numbers
    hint: str = ""       # how to fix it
    qualname: str = ""   # enclosing function/class qualname, "" = module
    code: str = ""       # stripped source line the finding anchors to

    def key(self) -> tuple:
        return (self.rule, self.path, self.code, self.message)

    def fingerprint(self) -> str:
        blob = "\x1f".join(self.key()).encode("utf-8")
        return hashlib.sha1(blob).hexdigest()[:16]

    def format(self) -> str:
        where = f"{self.path}:{self.line}:{self.col + 1}"
        out = f"{where}: [{self.rule}] {self.message}"
        if self.qualname:
            out += f" (in {self.qualname})"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint()
        return d

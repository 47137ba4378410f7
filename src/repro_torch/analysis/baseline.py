"""Committed baseline for grandfathered findings.

A baseline entry matches findings by fingerprint — ``(rule, path, flagged
source line text, message)`` — with a ``count`` bounding how many identical
findings it absorbs. Every entry MUST carry a human-readable ``reason``;
the loader rejects empty or placeholder reasons, so nobody can grandfather
a finding without writing down why it is acceptable.

``--write-baseline`` regenerates the file from the current findings,
preserving the reasons of entries that still match and stamping new
entries with ``"TODO -- justify or fix"`` — which the loader rejects, so a
freshly written baseline fails the lint until a human fills the reasons in.
Stale entries (no longer matching any finding) are dropped on rewrite and
reported as warnings on normal runs.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.analysis.findings import Finding

TODO_REASON = "TODO -- justify or fix"


class BaselineError(ValueError):
    pass


class Baseline:
    def __init__(self, entries: Optional[List[dict]] = None,
                 path: Optional[Path] = None):
        self.path = path
        self.entries = entries or []
        self._budget: Dict[str, int] = {}
        self._reasons: Dict[str, str] = {}
        for i, e in enumerate(self.entries):
            missing = {"rule", "path", "code", "message", "reason"} - set(e)
            if missing:
                raise BaselineError(
                    f"baseline entry {i} missing fields: {sorted(missing)}")
            reason = str(e["reason"]).strip()
            if not reason or reason.startswith("TODO"):
                raise BaselineError(
                    f"baseline entry {i} ({e['rule']} @ {e['path']}) has no "
                    "real reason — every grandfathered finding must say why "
                    "it is acceptable")
            fp = Finding(rule=e["rule"], path=e["path"], line=0, col=0,
                         message=e["message"], code=e["code"]).fingerprint()
            self._budget[fp] = self._budget.get(fp, 0) + int(e.get("count", 1))
            self._reasons[fp] = reason

    @classmethod
    def load(cls, path) -> "Baseline":
        path = Path(path)
        try:
            doc = json.loads(path.read_text(encoding="utf-8"))
        except json.JSONDecodeError as e:
            raise BaselineError(f"{path}: invalid JSON: {e}") from e
        if not isinstance(doc, dict) or "entries" not in doc:
            raise BaselineError(f"{path}: expected {{'entries': [...]}}")
        return cls(doc["entries"], path=path)

    def absorb(self, finding: Finding) -> Optional[str]:
        """Consume one unit of budget for a matching entry; returns the
        entry's reason, or None if the finding is not baselined."""
        fp = finding.fingerprint()
        if self._budget.get(fp, 0) > 0:
            self._budget[fp] -= 1
            return self._reasons[fp]
        return None

    def stale_entries(self) -> List[dict]:
        """Entries with unconsumed budget after a full run — the findings
        they grandfathered no longer exist (warn; prune via rewrite)."""
        out = []
        for e in self.entries:
            fp = Finding(rule=e["rule"], path=e["path"], line=0, col=0,
                         message=e["message"], code=e["code"]).fingerprint()
            if self._budget.get(fp, 0) > 0:
                out.append(e)
                self._budget[fp] = 0   # report each stale entry once
        return out


def write_baseline(path, findings: List[Finding],
                   old: Optional[Baseline] = None) -> dict:
    """Serialize ``findings`` as a baseline document, carrying over reasons
    from ``old`` where the fingerprint still matches."""
    reasons = dict(old._reasons) if old is not None else {}
    grouped: Dict[tuple, dict] = {}
    for f in findings:
        k = f.key()
        if k in grouped:
            grouped[k]["count"] += 1
        else:
            grouped[k] = {
                "rule": f.rule, "path": f.path, "code": f.code,
                "message": f.message, "count": 1,
                "reason": reasons.get(f.fingerprint(), TODO_REASON)}
    doc = {"comment": "grandfathered repro_torch.analysis findings — every entry "
                      "needs a real reason (loader rejects TODO)",
           "entries": sorted(grouped.values(),
                             key=lambda e: (e["rule"], e["path"],
                                            e["message"]))}
    Path(path).write_text(json.dumps(doc, indent=2) + "\n", encoding="utf-8")
    return doc

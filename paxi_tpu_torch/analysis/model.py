"""Shared violation/reporting model for the port's paxi-lint
(``paxi_tpu_torch/analysis``; a copy of the JAX package's ``model.py``,
so one tool reads both reports).

Every rule family emits :class:`Violation` records; the engine
(``__init__.run_lint``) filters them through two suppression layers:

- **inline**: a ``# paxi-lint: disable=CODE[,CODE...]`` comment on the
  flagged line (or ``disable-all``) silences that line only;
- **baseline**: ``analysis/baseline.toml`` records *intentional*
  exceptions — places where a rule is right in general but wrong about
  one specific construct — so the repo-wide lint can be kept at zero
  without weakening any rule.  Each entry must carry a ``reason``.

The baseline format is a TOML subset (``[[suppress]]`` tables of
string/int scalars) parsed by :func:`load_baseline`, with no ``tomllib``
and no third-party dependency.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Violation:
    """One finding: ``path:line:col CODE message`` (path repo-relative)."""

    rule: str      # family name, e.g. "kernel-purity"
    code: str      # stable id, e.g. "PXK102"
    path: str      # repo-relative, '/'-separated
    line: int
    col: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col} {self.code} {self.message}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "code": self.code, "path": self.path,
                "line": self.line, "col": self.col, "message": self.message}


@dataclass
class Suppression:
    """One baseline entry.  ``code`` matches the violation code exactly
    (or a whole family via its ``PXK``-style prefix); ``path`` matches
    the repo-relative path exactly; ``match``, when set, must be a
    substring of the violation message.  ``used`` tracks whether any
    violation consumed the entry, so stale baseline rows surface."""

    code: str
    path: str
    match: str = ""
    reason: str = ""
    used: bool = field(default=False, compare=False)

    def matches(self, v: Violation) -> bool:
        if v.path != self.path:
            return False
        if not (v.code == self.code or v.code.startswith(self.code)):
            return False
        return self.match in v.message


@dataclass
class LintReport:
    violations: List[Violation]          # unsuppressed, the lint's verdict
    suppressed: List[Tuple[Violation, str]]   # (violation, why)
    unused_baseline: List[Suppression]
    checked_files: int = 0
    # per-family wall time in seconds, insertion-ordered by run order
    timings: Dict[str, float] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def render(self, verbose: bool = False) -> str:
        lines = [v.render() for v in
                 sorted(self.violations, key=lambda v: (v.path, v.line,
                                                        v.col, v.code))]
        if verbose:
            for v, why in self.suppressed:
                lines.append(f"# suppressed ({why}): {v.render()}")
        for s in self.unused_baseline:
            lines.append(f"# warning: unused baseline entry "
                         f"{s.code} {s.path} match={s.match!r}")
        tail = (f"{len(self.violations)} violation(s), "
                f"{len(self.suppressed)} suppressed, "
                f"{self.checked_files} file(s) checked")
        return "\n".join(lines + [tail])

    def to_json(self) -> str:
        return json.dumps({
            "ok": self.ok,
            "violations": [v.to_json() for v in self.violations],
            "suppressed": [dict(v.to_json(), suppressed_by=why)
                           for v, why in self.suppressed],
            "unused_baseline": [
                {"code": s.code, "path": s.path, "match": s.match}
                for s in self.unused_baseline],
            "checked_files": self.checked_files,
            "timings": {k: round(t, 4)
                        for k, t in self.timings.items()},
        }, indent=2)

    def to_sarif(self) -> str:
        """SARIF 2.1.0 export, one run: kept findings as ``error``
        results, suppressed ones as ``note`` results carrying a
        ``suppressions`` record — the shape CI annotators ingest."""
        def _result(v: Violation, level: str,
                    why: Optional[str] = None) -> dict:
            out = {
                "ruleId": v.code,
                "level": level,
                "message": {"text": f"[{v.rule}] {v.message}"},
                "locations": [{
                    "physicalLocation": {
                        "artifactLocation": {"uri": v.path},
                        "region": {"startLine": v.line,
                                   "startColumn": v.col + 1},
                    },
                }],
            }
            if why is not None:
                out["suppressions"] = [{"kind": "inSource"
                                        if why == "inline"
                                        else "external",
                                        "justification": why}]
            return out

        everything = ([(v, "error", None) for v in self.violations]
                      + [(v, "note", why)
                         for v, why in self.suppressed])
        rules = sorted({(v.code, v.rule) for v, _, _ in everything})
        return json.dumps({
            "$schema": ("https://json.schemastore.org/"
                        "sarif-2.1.0.json"),
            "version": "2.1.0",
            "runs": [{
                "tool": {"driver": {
                    "name": "paxi-lint",
                    "informationUri":
                        "https://example.invalid/paxi_tpu_torch/analysis",
                    "rules": [{"id": code,
                               "shortDescription": {"text": family}}
                              for code, family in rules],
                }},
                "results": [_result(v, level, why)
                            for v, level, why in everything],
            }],
        }, indent=2)


# ---- baseline (mini-TOML) -----------------------------------------------
_KV_RE = re.compile(r"^([A-Za-z_][A-Za-z0-9_-]*)\s*=\s*(.+?)\s*$")


def _parse_scalar(raw: str, path: Path, lineno: int):
    if raw[:1] in ('"', "'"):
        quote = raw[0]
        end = raw.find(quote, 1)
        tail = raw[end + 1:].strip() if end != -1 else None
        # a trailing `# comment` after the closing quote is valid TOML
        if end != -1 and (not tail or tail.startswith("#")):
            return raw[1:end]
        raise ValueError(f"{path}:{lineno}: malformed string {raw!r}")
    if re.fullmatch(r"-?[0-9]+", raw):
        return int(raw)
    if raw in ("true", "false"):
        return raw == "true"
    raise ValueError(f"{path}:{lineno}: unsupported TOML value {raw!r} "
                     "(baseline.toml uses quoted strings only)")


def load_baseline(path: Path) -> List[Suppression]:
    """Parse the ``[[suppress]]`` tables of a baseline file.  Subset
    grammar: comments, blank lines, ``[[suppress]]`` headers, and
    ``key = "value"`` scalar pairs — enough for a suppression list."""
    if not path.exists():
        return []
    entries: List[Dict] = []
    current: Optional[Dict] = None
    for lineno, line in enumerate(path.read_text().splitlines(), 1):
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if stripped == "[[suppress]]":
            current = {}
            entries.append(current)
            continue
        if stripped.startswith("["):
            raise ValueError(f"{path}:{lineno}: unsupported table "
                             f"{stripped!r} (only [[suppress]] is known)")
        m = _KV_RE.match(stripped)
        if m is None:
            raise ValueError(f"{path}:{lineno}: cannot parse {stripped!r}")
        if current is None:
            raise ValueError(f"{path}:{lineno}: key outside [[suppress]]")
        # strip trailing comments outside quotes
        raw = m.group(2)
        if "#" in raw and not (raw.startswith('"') or raw.startswith("'")):
            raw = raw.split("#", 1)[0].strip()
        current[m.group(1)] = _parse_scalar(raw, path, lineno)
    out = []
    for e in entries:
        if "code" not in e or "path" not in e:
            raise ValueError(f"{path}: [[suppress]] entry needs at least "
                             f"'code' and 'path': {e}")
        if not str(e.get("reason", "")).strip():
            raise ValueError(f"{path}: [[suppress]] entry for {e['code']} "
                             f"{e['path']} must carry a 'reason'")
        out.append(Suppression(code=str(e["code"]), path=str(e["path"]),
                               match=str(e.get("match", "")),
                               reason=str(e.get("reason", ""))))
    return out


# ---- inline suppressions -------------------------------------------------
_INLINE_RE = re.compile(r"#\s*paxi-lint:\s*disable=([A-Za-z0-9_,\- ]+)")


def inline_disables(source: str) -> Dict[int, set]:
    """``line -> {codes}`` for ``# paxi-lint: disable=PXK102[,...]``
    comments; the special token ``all`` silences every rule on the
    line."""
    out: Dict[int, set] = {}
    for i, line in enumerate(source.splitlines(), 1):
        m = _INLINE_RE.search(line)
        if m:
            out[i] = {c.strip() for c in m.group(1).split(",") if c.strip()}
    return out


def apply_suppressions(
        violations: Iterable[Violation],
        baseline: Sequence[Suppression],
        inline: Dict[str, Dict[int, set]],
) -> Tuple[List[Violation], List[Tuple[Violation, str]]]:
    """Split raw findings into (kept, suppressed-with-reason).
    ``inline`` maps repo-relative path -> line -> codes."""
    kept: List[Violation] = []
    dropped: List[Tuple[Violation, str]] = []
    for v in violations:
        codes = inline.get(v.path, {}).get(v.line, set())
        if "all" in codes or v.code in codes:
            dropped.append((v, "inline"))
            continue
        hit = next((s for s in baseline if s.matches(v)), None)
        if hit is not None:
            hit.used = True
            dropped.append((v, f"baseline: {hit.reason}"))
            continue
        kept.append(v)
    return kept, dropped

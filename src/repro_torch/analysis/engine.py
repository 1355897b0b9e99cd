"""Rule engine: file walker, Finding records, suppressions, baseline.

The reference's ``repro/analysis/engine.py`` semantics, on the standard
library alone (``ast``, ``json``, ``re``, ``pathlib``): no torch, so the
lint loads wherever the repo's Python does.

Pieces:

- :class:`ParsedModule` — one parsed source file (text, lines, AST), cached
  so every rule shares one parse per file.
- :class:`Rule` — the interface a rule implements: a ``name``, the repo
  ``roots`` it applies to, and ``check_module``.  A root is a directory
  (every ``*.py`` under it) or a single ``.py`` file.
- :class:`Finding` — one structured diagnostic.  Its identity for baseline
  matching is ``(rule, path, snippet)`` — the *stripped source line*, not
  the line number, so unrelated edits above a grandfathered finding don't
  un-grandfather it.
- suppressions — a trailing ``# reprolint: disable=<rule>[,<rule>...]`` (or
  ``disable=all``) on the offending line silences findings on that line;
  the comment is the reference lint's, so one line reads the same to both.
- :class:`Baseline` — a checked-in JSON file of grandfathered findings;
  every entry carries a human ``justification``.  ``run_analysis`` reports
  only findings *not* in the baseline.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import re
from typing import Iterable, Optional, Sequence

SUPPRESS_RE = re.compile(r"#\s*reprolint:\s*disable=([A-Za-z0-9_,\- ]+)")

#: directories never scanned (caches, venvs, checkouts inside the tree),
#: matched on the path below the scanned root
SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules", ".eggs",
             "build", "dist"}

#: repo-relative roots scanned when a rule doesn't narrow them
DEFAULT_ROOTS = ("src/repro_torch",)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: where, which rule, and what went wrong."""

    rule: str
    path: str          # repo-root-relative, posix separators
    line: int          # 1-based
    col: int           # 0-based
    message: str
    snippet: str       # stripped source line — the baseline identity

    @property
    def fingerprint(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.snippet)

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ParsedModule:
    """A parsed source file, shared by every rule that looks at it."""

    path: pathlib.Path     # absolute
    rel: str               # repo-root-relative, posix
    text: str
    lines: list[str]
    tree: ast.Module

    @classmethod
    def parse(cls, path: pathlib.Path, root: pathlib.Path) -> "ParsedModule":
        text = path.read_text()
        rel = path.resolve().relative_to(root.resolve()).as_posix()
        return cls(path=path, rel=rel, text=text,
                   lines=text.splitlines(), tree=ast.parse(text))

    @property
    def root(self) -> pathlib.Path:
        """The repo root this module's ``rel`` is relative to."""
        path = self.path.resolve()
        for _ in self.rel.split("/"):
            path = path.parent
        return path

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        snippet = self.lines[line - 1].strip() if line <= len(self.lines) else ""
        return Finding(rule=rule, path=self.rel, line=line, col=col,
                       message=message, snippet=snippet)

    def suppressed_rules(self, line: int) -> frozenset[str]:
        """Rules disabled on ``line`` via a reprolint comment."""
        if not 1 <= line <= len(self.lines):
            return frozenset()
        m = SUPPRESS_RE.search(self.lines[line - 1])
        if not m:
            return frozenset()
        return frozenset(p.strip() for p in m.group(1).split(",") if p.strip())


class Rule:
    """Base class; subclasses set ``name``/``description`` and override
    :meth:`check_module`.  ``roots`` are the repo-relative directories or
    files the rule scans; ``exclude`` are repo-relative path prefixes it
    skips (the files that *define* the guarded surface)."""

    name: str = ""
    description: str = ""
    roots: tuple[str, ...] = DEFAULT_ROOTS
    exclude: tuple[str, ...] = ()

    def applies_to(self, rel: str) -> bool:
        return not any(rel == e or rel.startswith(e.rstrip("/") + "/")
                       for e in self.exclude)

    def check_module(self, mod: ParsedModule) -> list[Finding]:
        raise NotImplementedError


@dataclasses.dataclass
class Baseline:
    """Grandfathered findings.  JSON shape::

        {"findings": [{"rule": ..., "path": ..., "snippet": ...,
                       "justification": "<why this is allowed to stand>"}]}

    Matching is by fingerprint (rule, path, snippet).  ``load`` rejects
    entries with an empty justification: debt must be documented.
    """

    entries: dict[tuple[str, str, str], str] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def load(cls, path: pathlib.Path) -> "Baseline":
        data = json.loads(path.read_text())
        entries = {}
        for e in data.get("findings", []):
            just = e.get("justification", "").strip()
            if not just:
                raise ValueError(
                    f"baseline entry without justification: {e!r} "
                    f"(every grandfathered finding needs a reason)")
            entries[(e["rule"], e["path"], e["snippet"])] = just
        return cls(entries=entries)

    def contains(self, finding: Finding) -> bool:
        return finding.fingerprint in self.entries

    @staticmethod
    def write(path: pathlib.Path, findings: Sequence[Finding],
              old: Optional["Baseline"] = None) -> None:
        """Serialize ``findings`` as the new baseline, carrying forward the
        justification of entries that were already grandfathered (new ones
        get a TODO for a human to replace with the reason)."""
        out = []
        for f in findings:
            just = (old.entries.get(f.fingerprint, "") if old else "")
            out.append({"rule": f.rule, "path": f.path, "snippet": f.snippet,
                        "justification": just or
                        "TODO: justify or fix (loader rejects empty)"})
        path.write_text(json.dumps({"findings": out}, indent=2) + "\n")


def iter_python_files(root: pathlib.Path,
                      roots: Sequence[str]) -> Iterable[pathlib.Path]:
    """Every ``*.py`` under ``root/<r>`` for each repo-relative ``r`` (or
    ``root/<r>`` itself when it is a ``.py`` file), sorted, once each;
    ``r == "."`` scans the root itself."""
    seen = set()
    for r in roots:
        base = root if r in (".", "") else root / r
        if base.is_file():
            paths = [base] if base.suffix == ".py" else []
        elif base.is_dir():
            paths = [p for p in sorted(base.rglob("*.py"))
                     if not SKIP_DIRS.intersection(p.relative_to(base).parts)]
        else:
            continue
        for path in paths:
            if path not in seen:
                seen.add(path)
                yield path


@dataclasses.dataclass
class AnalysisConfig:
    root: pathlib.Path                       # repo root all paths are relative to
    rules: Sequence[Rule] = ()
    baseline: Optional[Baseline] = None
    paths: Optional[Sequence[pathlib.Path]] = None   # explicit file list


def run_analysis(cfg: AnalysisConfig) -> tuple[list[Finding], list[Finding]]:
    """Run every rule over its files.

    Returns ``(new, grandfathered)``: findings not in / in the baseline.
    Suppressed findings are dropped entirely.  A file that fails to parse
    yields a single ``parse-error`` finding (attributed to every rule run
    would be noise; one record is enough to fail the lint).
    """
    cache: dict[pathlib.Path, ParsedModule] = {}
    parse_failures: dict[pathlib.Path, Finding] = {}
    root = cfg.root

    def parsed(path: pathlib.Path) -> Optional[ParsedModule]:
        if path in parse_failures:
            return None
        if path not in cache:
            try:
                cache[path] = ParsedModule.parse(path, root)
            except SyntaxError as e:
                rel = path.resolve().relative_to(root.resolve()).as_posix()
                parse_failures[path] = Finding(
                    rule="parse-error", path=rel, line=e.lineno or 1,
                    col=e.offset or 0, message=f"syntax error: {e.msg}",
                    snippet=(e.text or "").strip())
                return None
        return cache[path]

    findings: list[Finding] = []
    for rule in cfg.rules:
        if cfg.paths is not None:
            files = list(cfg.paths)
        else:
            files = list(iter_python_files(root, rule.roots))
        for path in files:
            mod = parsed(path)
            if mod is None or not rule.applies_to(mod.rel):
                continue
            for f in rule.check_module(mod):
                sup = mod.suppressed_rules(f.line)
                if "all" in sup or f.rule in sup:
                    continue
                findings.append(f)
    findings.extend(parse_failures.values())
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))

    if cfg.baseline is None:
        return findings, []
    new = [f for f in findings if not cfg.baseline.contains(f)]
    old = [f for f in findings if cfg.baseline.contains(f)]
    return new, old


# ---------------------------------------------------------------------------
# Shared AST helpers (used by several rules)
# ---------------------------------------------------------------------------

def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted_name(call.func)


def keyword_arg(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None

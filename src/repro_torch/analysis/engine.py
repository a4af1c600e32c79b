"""The port's symlint core: findings, rule registry, suppressions, baseline.

A copy of ``repro.analysis.engine``; only the comment prefix
(``symlint-torch:``), the default sweep and the baseline's name differ.  The
prefix is the port's own because the reference's tool sweeps all of
``src/``: a port function carrying ``# symlint: ...`` markers would be read
by it (its jit registry resolves names across the sweep, and its ``--deep``
would trace the function with JAX).

The analyzer parses every swept file once into a ``Project`` (source text,
AST, comment channel) and hands the whole project to each registered rule --
rules are free to be per-file (SL001) or cross-file (SL005 pairs sender
encoders in one module with receiver decoders in another).

Contracts enforced at this layer, shared by every rule:

  * **suppression** -- a ``# symlint-torch: disable=SL004`` (or bare
    ``# symlint-torch: disable``) comment on the finding's line silences it;
  * **baseline** -- grandfathered findings live in a committed JSON file
    (``.symlint-torch-baseline.json``), keyed by a line-number-free fingerprint so
    unrelated edits don't invalidate entries; every entry carries a written
    justification, and entries that no longer match anything are reported as
    stale so the baseline can only shrink.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import re
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.astutil import line_comments

__all__ = [
    "Finding", "Rule", "RULES", "register", "SourceFile", "Project",
    "Baseline", "AnalysisResult", "analyze", "load_project",
    "DEFAULT_SWEEP", "BASELINE_NAME", "TODO_JUSTIFICATION", "PREFIX",
    "default_paths", "NO_COUNTERPART",
]

#: the comment prefix of every annotation this tool reads
PREFIX = "symlint-torch:"
#: repo-relative paths (globs allowed) ``python -m repro_torch.analysis``
#: sweeps by default
DEFAULT_SWEEP = ("src/repro_torch", "examples/torch_*.py", "chip_smoke.py")
BASELINE_NAME = ".symlint-torch-baseline.json"
#: placeholder stamped on new baseline entries; entries still carrying it
#: are reported by ``--update-baseline`` (exit 1) so they cannot land
TODO_JUSTIFICATION = "TODO: justify or fix"

_DISABLE_RE = re.compile(
    re.escape(PREFIX) + r"\s*disable(?:=([A-Za-z0-9_,\s]+))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location.

    ``message`` must be stable under unrelated edits (rules never embed line
    numbers in it) -- the baseline fingerprint hashes ``rule|path|message``.
    """

    rule: str
    path: str        # repo-relative, posix separators
    line: int
    col: int
    message: str
    context: str = ""    # enclosing function qualname, if any

    @property
    def fingerprint(self) -> str:
        key = f"{self.rule}|{self.path}|{self.message}"
        return hashlib.sha256(key.encode("utf-8")).hexdigest()[:16]

    def to_json(self) -> dict:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "col": self.col, "message": self.message,
            "context": self.context, "fingerprint": self.fingerprint,
        }


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    doc: str
    check: Callable[["Project"], Iterable[Finding]]
    tier: str = "ast"    # "ast": pure-interpreter; "deep": needs torch (SL006+)


RULES: Dict[str, Rule] = {}

#: the reference's rules that the port has no counterpart of, and why
NO_COUNTERPART: Dict[str, Tuple[str, str]] = {
    "SL001": ("compat-policy", "the port has no compat shim: it steers no "
              "version-sensitive JAX API"),
    "SL002": ("retrace-hazard", "the port traces and compiles nothing at run "
              "time (no torch.compile, no CUDA graph, no jit); its kernels "
              "are built once by kernels/_build.py"),
    "SL003": ("donation-aliasing", "PyTorch has no buffer donation"),
    "SL008": ("donation-effect", "PyTorch has no buffer donation"),
}


def register(rule_id: str, name: str, doc: str, tier: str = "ast"):
    """Decorator: register ``check(project) -> Iterable[Finding]`` as a rule."""

    def wrap(fn):
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id}")
        RULES[rule_id] = Rule(id=rule_id, name=name, doc=doc, check=fn,
                              tier=tier)
        return fn

    return wrap


class SourceFile:
    """One parsed source file: text, AST, and the comment-channel markers."""

    def __init__(self, relpath: str, text: str):
        self.relpath = relpath
        self.text = text
        self.tree = ast.parse(text, filename=relpath)
        self.comments = line_comments(text)

    def disabled_rules(self, line: int) -> Optional[frozenset]:
        """Rules suppressed on ``line``; empty frozenset means *all* rules."""
        comment = self.comments.get(line)
        if comment is None:
            return None
        m = _DISABLE_RE.search(comment)
        if m is None:
            return None
        if m.group(1) is None:
            return frozenset()  # bare "symlint-torch: disable": everything
        return frozenset(
            r.strip().upper() for r in m.group(1).split(",") if r.strip())

    def has_marker(self, line: int, marker: str) -> bool:
        """True when ``line`` carries the given comment annotation."""
        return marker in self.comments.get(line, "")


def default_paths(root: Path) -> List[Path]:
    """``DEFAULT_SWEEP`` under ``root``, globs expanded, missing ones left
    out."""
    out: List[Path] = []
    for pattern in DEFAULT_SWEEP:
        out.extend(sorted(root.glob(pattern)))
    return out


class Project:
    """The whole sweep, parsed once and shared by every rule."""

    def __init__(self, root: Path, files: Dict[str, SourceFile]):
        self.root = root
        self.files = files
        self._caches: Dict[str, object] = {}

    def cache(self, key: str, build: Callable[[], object]) -> object:
        """Memoize cross-rule shared passes (e.g. the jit registry)."""
        if key not in self._caches:
            self._caches[key] = build()
        return self._caches[key]

    def find_file(self, suffix: str) -> Optional[SourceFile]:
        """First file whose relpath ends with ``suffix`` (posix)."""
        for rel, sf in sorted(self.files.items()):
            if rel.endswith(suffix):
                return sf
        return None


def load_project(root: Path, paths: Sequence[Path]) -> Project:
    """Parse every ``.py`` under ``paths`` into a ``Project``.

    Files that fail to parse surface as a synthetic ``SL000`` finding from
    ``analyze`` rather than crashing the run (a syntax error in one file must
    not hide findings in the rest).
    """
    files: Dict[str, SourceFile] = {}
    errors: List[Tuple[str, str]] = []
    seen = set()
    for p in paths:
        candidates = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in candidates:
            f = f.resolve()
            if f in seen:
                continue
            seen.add(f)
            try:
                rel = f.relative_to(root).as_posix()
            except ValueError:
                rel = f.as_posix()
            try:
                files[rel] = SourceFile(rel, f.read_text())
            except SyntaxError as e:
                errors.append((rel, f"line {e.lineno}: {e.msg}"))
    proj = Project(root, files)
    proj.parse_errors = errors  # type: ignore[attr-defined]
    return proj


class Baseline:
    """The committed grandfather file: fingerprint -> justification."""

    def __init__(self, path: Optional[Path]):
        self.path = path
        self.entries: Dict[str, dict] = {}
        if path is not None and path.exists():
            doc = json.loads(path.read_text())
            for e in doc.get("entries", []):
                self.entries[e["fingerprint"]] = e

    def __contains__(self, finding: Finding) -> bool:
        return finding.fingerprint in self.entries

    def stale(self, findings: Iterable[Finding]) -> List[dict]:
        live = {f.fingerprint for f in findings}
        return [e for fp, e in sorted(self.entries.items()) if fp not in live]

    @staticmethod
    def write(path: Path, findings: Sequence[Finding],
              keep: Dict[str, dict]) -> int:
        """Write ``findings`` as the new baseline, carrying over any existing
        justification (new entries get an explicit TODO placeholder --
        a baseline entry without a reason is itself a review finding)."""
        entries = []
        seen = set()
        for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
            if f.fingerprint in seen:  # one entry covers every same-message site
                continue
            seen.add(f.fingerprint)
            prev = keep.get(f.fingerprint, {})
            entries.append({
                "fingerprint": f.fingerprint,
                "rule": f.rule,
                "file": f.path,
                "line": f.line,  # informational only; matching is by hash
                "message": f.message,
                "justification": prev.get(
                    "justification", TODO_JUSTIFICATION),
            })
        path.write_text(json.dumps(
            {"version": 1, "entries": entries}, indent=2) + "\n")
        return len(entries)

    @staticmethod
    def unjustified(path: Path) -> List[dict]:
        """Entries in the written baseline whose justification is still the
        TODO placeholder.  ``--update-baseline`` refuses (exit 1) while any
        exist: a grandfathered finding without a written reason is exactly
        the review debt the baseline exists to prevent.  Reading an old
        baseline stays lenient -- only (re)writing one enforces this."""
        if not path.exists():
            return []
        doc = json.loads(path.read_text())
        return [e for e in doc.get("entries", [])
                if e.get("justification", TODO_JUSTIFICATION).strip()
                == TODO_JUSTIFICATION]


@dataclasses.dataclass
class AnalysisResult:
    findings: List[Finding]              # actionable (not suppressed/baselined)
    baselined: List[Finding]
    suppressed: List[Finding]
    stale_baseline: List[dict]
    parse_errors: List[Tuple[str, str]]

    @property
    def exit_code(self) -> int:
        return 1 if (self.findings or self.parse_errors
                     or self.stale_baseline) else 0


def analyze(
    project: Project,
    rule_ids: Optional[Sequence[str]] = None,
    baseline: Optional[Baseline] = None,
    *,
    include_deep: bool = False,
) -> AnalysisResult:
    """Run the selected rules over ``project`` and partition the findings.

    By default only the pure-AST tier runs; ``include_deep=True`` adds the
    torch-importing rules (the caller must have run ``deep.prepare(project)``
    first -- deep rules read the prepared context off the project cache and
    report nothing when it is absent).  An explicit ``rule_ids`` overrides
    the tier filter either way.
    """
    import repro_torch.analysis.rules  # noqa: F401  -- populates RULES

    if rule_ids is None:
        ids = [r for r in sorted(RULES)
               if include_deep or RULES[r].tier == "ast"]
    else:
        ids = list(rule_ids)
    unknown = [r for r in ids if r not in RULES]
    if unknown:
        raise ValueError(
            f"unknown rule ids {unknown}; known: {sorted(RULES)}")
    raw: List[Finding] = []
    for rid in ids:
        raw.extend(RULES[rid].check(project))
    raw.sort(key=lambda f: (f.path, f.line, f.col, f.rule))

    actionable, baselined, suppressed = [], [], []
    for f in raw:
        sf = project.files.get(f.path)
        disabled = sf.disabled_rules(f.line) if sf is not None else None
        if disabled is not None and (not disabled or f.rule in disabled):
            suppressed.append(f)
        elif baseline is not None and f in baseline:
            baselined.append(f)
        else:
            actionable.append(f)
    stale = baseline.stale(raw) if baseline is not None else []
    return AnalysisResult(
        findings=actionable, baselined=baselined, suppressed=suppressed,
        stale_baseline=stale,
        parse_errors=list(getattr(project, "parse_errors", [])),
    )

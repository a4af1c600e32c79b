"""The port's symlint command line: ``python -m repro_torch.analysis`` /
``symlint-torch``.

The reference's flags and exit codes: 0 clean, 1 findings (or stale
baseline entries / parse errors), 2 usage error.  ``--format=github`` emits
workflow annotation commands.  ``--deep`` imports torch and runs the deep
tier on ``--device``: the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from typing import List, Optional, Sequence, Set

from repro_torch.analysis.engine import (
    BASELINE_NAME, DEFAULT_SWEEP, NO_COUNTERPART, RULES, AnalysisResult,
    Baseline, analyze, default_paths, load_project,
)


def find_root(start: Optional[Path] = None) -> Path:
    """Walk up from ``start`` to the directory holding pyproject.toml."""
    cur = (start or Path.cwd()).resolve()
    for cand in [cur, *cur.parents]:
        if (cand / "pyproject.toml").exists():
            return cand
    return cur


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="symlint-torch",
        description="Static analysis for the PyTorch port of SymED: "
                    "hot-path host syncs (SL004), wire-protocol consistency "
                    "(SL005); with --deep also sync budgets (SL006) and "
                    "dtype discipline (SL007), measured by running the "
                    "registered entries.")
    p.add_argument("paths", nargs="*", type=Path,
                   help=f"files/directories to sweep (default: "
                        f"{', '.join(DEFAULT_SWEEP)} under the repo root)")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--format", dest="fmt", default="text",
                   choices=("text", "json", "github"))
    p.add_argument("--baseline", type=Path, default=None,
                   help=f"baseline file (default: <root>/{BASELINE_NAME})")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline: report grandfathered findings")
    p.add_argument("--write-baseline", "--update-baseline",
                   action="store_true",
                   help="rewrite the baseline from the current findings "
                        "(keeps existing justifications); exits 1 listing "
                        "any entry whose justification is still the TODO "
                        "placeholder, so unjustified baselines cannot land")
    p.add_argument("--deep", action="store_true",
                   help="also run the torch-importing deep tier (SL006, "
                        "SL007): probes every `# symlint-torch: entry(...)` "
                        "registration and runs the scripted drives under the "
                        "sync counter")
    p.add_argument("--device", default=None, choices=("cpu", "cuda"),
                   help="where --deep runs the probes and drives (default: "
                        "cuda; each entry is held to its `budget=` there, "
                        "to its `cpu_budget=` on the CPU)")
    p.add_argument("--changed", action="store_true",
                   help="report findings only for files that differ from the "
                        "merge-base with origin/main (plus uncommitted and "
                        "untracked files); the whole sweep is still parsed "
                        "so cross-file rules keep their context")
    p.add_argument("--list-rules", action="store_true")
    p.add_argument("--show-baselined", action="store_true",
                   help="also print baselined/suppressed findings (text)")
    return p


def _emit_text(result: AnalysisResult, show_baselined: bool) -> None:
    for rel, err in result.parse_errors:
        print(f"{rel}: SL000 parse error: {err}")
    for f in result.findings:
        where = f" [{f.context}]" if f.context else ""
        print(f"{f.path}:{f.line}:{f.col}: {f.rule}{where}: {f.message}")
    if show_baselined:
        for f in result.baselined:
            print(f"{f.path}:{f.line}:{f.col}: {f.rule} (baselined): "
                  f"{f.message}")
        for f in result.suppressed:
            print(f"{f.path}:{f.line}:{f.col}: {f.rule} (suppressed): "
                  f"{f.message}")
    for e in result.stale_baseline:
        print(f"{e['file']}: stale baseline entry {e['fingerprint']} "
              f"({e['rule']}): finding no longer exists -- remove it")
    n = len(result.findings)
    print(f"symlint: {n} finding{'s' if n != 1 else ''}"
          f" ({len(result.baselined)} baselined,"
          f" {len(result.suppressed)} suppressed,"
          f" {len(result.stale_baseline)} stale baseline entries)")


def _emit_github(result: AnalysisResult) -> None:
    for rel, err in result.parse_errors:
        print(f"::error file={rel},title=SL000 parse error::{err}")
    for f in result.findings:
        print(f"::error file={f.path},line={f.line},col={f.col + 1},"
              f"title={f.rule} {RULES[f.rule].name}::{f.message}")
    for e in result.stale_baseline:
        print(f"::error file={e['file']},title=stale baseline::"
              f"entry {e['fingerprint']} ({e['rule']}) no longer matches "
              f"any finding -- remove it from {BASELINE_NAME}")


def _emit_json(result: AnalysisResult, deep_ctx=None) -> None:
    extra = {} if deep_ctx is None else {
        "deep_device": deep_ctx.device, "sync_counts": deep_ctx.drives}
    print(json.dumps({
        "findings": [f.to_json() for f in result.findings],
        "baselined": [f.to_json() for f in result.baselined],
        "suppressed": [f.to_json() for f in result.suppressed],
        "stale_baseline": result.stale_baseline,
        "parse_errors": [
            {"path": p, "error": e} for p, e in result.parse_errors],
        "exit_code": result.exit_code,
        **extra,
    }, indent=2))


def _changed_files(root: Path) -> Optional[Set[str]]:
    """Repo-relative posix paths differing from the merge-base (committed,
    uncommitted, and untracked); None when git/merge-base is unavailable."""

    def git(*cmd):
        try:
            r = subprocess.run(["git", *cmd], cwd=root, capture_output=True,
                               text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return None
        return r.stdout.strip() if r.returncode == 0 else None

    base = None
    for ref in ("origin/main", "main", "HEAD"):
        base = git("merge-base", ref, "HEAD")
        if base is not None:
            break
    if base is None:
        return None
    diff = git("diff", "--name-only", base, "--")
    if diff is None:
        return None
    changed = {p for p in diff.splitlines() if p}
    untracked = git("ls-files", "--others", "--exclude-standard")
    if untracked:
        changed |= {p for p in untracked.splitlines() if p}
    return changed


def main(argv: Optional[Sequence[str]] = None) -> int:
    import repro_torch.analysis.rules  # noqa: F401 -- populate the registry

    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rid in sorted(RULES):
            r = RULES[rid]
            print(f"{r.id}  {r.name} [{r.tier}]: {r.doc}")
        for rid, (name, why) in sorted(NO_COUNTERPART.items()):
            print(f"{rid}  {name} [no counterpart]: {why}")
        return 0

    root = find_root()
    if args.paths:
        paths: List[Path] = [p if p.is_absolute() else Path.cwd() / p
                             for p in args.paths]
        missing = [p for p in paths if not p.exists()]
        if missing:
            print(f"symlint: no such path: "
                  f"{', '.join(str(p) for p in missing)}", file=sys.stderr)
            return 2
    else:
        paths = default_paths(root)

    rule_ids = None
    if args.rules:
        rule_ids = [r.strip().upper() for r in args.rules.split(",")
                    if r.strip()]
        unknown = [r for r in rule_ids if r not in RULES]
        if unknown:
            print(f"symlint: unknown rule(s) {', '.join(unknown)}; "
                  f"known: {', '.join(sorted(RULES))}", file=sys.stderr)
            return 2

    baseline_path = args.baseline or (root / BASELINE_NAME)
    baseline = None if args.no_baseline else Baseline(baseline_path)

    project = load_project(root, paths)
    if args.deep:
        from repro_torch import resolve_device
        from repro_torch.analysis import deep
        try:
            device = resolve_device(args.device)
        except RuntimeError:
            print("symlint: --deep runs on the card unless --device cpu is "
                  "given, and CUDA is not available", file=sys.stderr)
            return 2
        deep.prepare(project, device=device)
    result = analyze(project, rule_ids, baseline, include_deep=args.deep)

    if args.changed:
        changed = _changed_files(root)
        if changed is None:
            print("symlint: --changed needs a git checkout with a resolvable "
                  "merge-base", file=sys.stderr)
            return 2
        result = dataclasses.replace(
            result,
            findings=[f for f in result.findings if f.path in changed],
            baselined=[f for f in result.baselined if f.path in changed],
            suppressed=[f for f in result.suppressed if f.path in changed],
            # a stale entry is an attribute of the whole baseline, not of
            # any changed file -- full sweeps own that failure mode
            stale_baseline=[],
            parse_errors=[(p, e) for p, e in result.parse_errors
                          if p in changed],
        )

    if args.write_baseline:
        grandfather = result.findings + result.baselined
        n = Baseline.write(baseline_path, grandfather,
                           baseline.entries if baseline is not None else {})
        print(f"symlint: wrote {n} entr{'y' if n == 1 else 'ies'} to "
              f"{baseline_path}")
        todo = Baseline.unjustified(baseline_path)
        if todo:
            for e in todo:
                print(f"{e['file']}: baseline entry {e['fingerprint']} "
                      f"({e['rule']}) still carries the placeholder "
                      f"justification -- write a real reason or fix it")
            print(f"symlint: {len(todo)} unjustified baseline "
                  f"entr{'y' if len(todo) == 1 else 'ies'}", file=sys.stderr)
            return 1
        return 0

    if args.fmt == "json":
        _emit_json(result, deep.context(project) if args.deep else None)
    elif args.fmt == "github":
        _emit_github(result)
        n = len(result.findings)
        print(f"symlint: {n} finding{'s' if n != 1 else ''}")
    else:
        _emit_text(result, args.show_baselined)
    return result.exit_code

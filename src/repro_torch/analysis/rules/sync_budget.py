"""SL006 sync-budget: entries must not sync past their declared budget.

The counterpart of ``repro.analysis.rules.retrace_budget``.  Eager PyTorch
traces and compiles nothing at run time; what a steady-state retrace is in
JAX -- a hidden stall of the host -- is a host sync here.  Every
``# symlint-torch: entry(drive=..., budget=N, cpu_budget=M)`` function is
exercised by its scripted drive after a warm-up, under
``synccount.SyncCounter``, and the syncs it made in the measured window
(each counted to the innermost entry of that drive on the stack) must be
<= the budget of the device the drive ran on: ``budget`` on the card (the
path that serves), ``cpu_budget`` on the CPU (the tests).  Each is that
device's count at the drives' seeded data: a new sync fails, and a change
that removes syncs lowers the budget.

Deep tier -- requires ``deep.prepare(project)`` to have run; silent when it
has not.  Preparation failures that make the budget unmeasurable
(unresolvable entry, crashed drive, malformed annotation) are findings, not
passes.
"""
from __future__ import annotations

import collections
from typing import Dict, Iterable, List

from repro_torch.analysis import deep
from repro_torch.analysis.engine import Finding, Project, register

RULE = "SL006"

_OWNED_STAGES = ("registry", "resolve", "drive")


@register(
    RULE, "sync-budget",
    "A registered entry point made more host syncs during its scripted "
    "drive's measured window than its declared sync budget allows.",
    tier="deep",
)
def check(project: Project) -> Iterable[Finding]:
    ctx = deep.context(project)
    if ctx is None:
        return []
    findings: List[Finding] = []
    for stage, entry, msg in ctx.errors:
        if stage not in _OWNED_STAGES:
            continue
        findings.append(Finding(
            rule=RULE, path=entry.relpath, line=entry.line or 1, col=0,
            context=entry.qualname,
            message=f"deep-tier {stage} failed for this entry: {msg}"))
    for e in ctx.entries:
        if e.drive is None or e.drive not in ctx.drives:
            continue
        n = ctx.drives[e.drive].get(e.qualname, 0)
        budget = deep.budget_on(e, ctx.device)
        if n <= budget:
            continue
        by_site: Dict[str, int] = collections.Counter()
        for (entry, site, _), c in ctx.drive_reports[
                e.drive].counter.counts.items():
            if entry == e.qualname:
                by_site[site] += c
        top = sorted(((c, site) for site, c in by_site.items()),
                     reverse=True)[:3]
        shown = ", ".join(f"{site} x{c}" for c, site in top)
        findings.append(Finding(
            rule=RULE, path=e.relpath, line=e.line, col=0,
            context=e.qualname,
            message=(f"`{e.qualname}` made {n} host sync(s) during the "
                     f"`{e.drive}` drive's measured window on "
                     f"{ctx.device}, over its declared budget of {budget} "
                     f"(sites: {shown}): a "
                     f"new sync in the serving loop -- remove it, or lower "
                     f"the budget where syncs went away")))
    return findings

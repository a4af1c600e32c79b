"""SL007 dtype-discipline: no 64-bit leaks, no slot/table dtype asymmetry.

The counterpart of ``repro.analysis.rules.dtype_discipline``, two checks
on every entry registered with ``shapes=``, run at its probes:

  * **64-bit leak** -- no output leaf is ``float64`` or ``complex128``, and
    no op makes one except inside a function marked
    ``# symlint-torch: f64-ok <reason>`` (the port's deliberate emulations
    of f32 rounding in f64, such as ``normalize.fma32``);
  * **pair asymmetry** -- entries registered as ``pair=<label>/slot`` and
    ``pair=<label>/table`` give leaf-for-leaf equal dtypes.  PyTorch has no
    weak types, so dtypes alone are compared.  Integer widths are left to
    the parity tests (PyTorch's index ops return int64).

Deep tier -- silent when ``deep.prepare(project)`` has not run; probe and
pair failures are findings (an unverifiable contract is not a pass).
"""
from __future__ import annotations

from typing import Iterable, List

from repro_torch.analysis import deep
from repro_torch.analysis.engine import Finding, Project, register

RULE = "SL007"

_OWNED_STAGES = ("operands", "trace", "pair")


@register(
    RULE, "dtype-discipline",
    "A registered entry's output or op was 64-bit outside f64-ok code, or "
    "a registered slot/table pair's output trees disagree on dtype.",
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
    for t in ctx.traces:
        if t.out_64:
            findings.append(Finding(
                rule=RULE, path=t.entry.relpath, line=t.entry.line, col=0,
                context=t.entry.qualname,
                message=(f"`{t.entry.qualname}` [{t.tag}] returns 64-bit "
                         f"leaves: {', '.join(t.out_64)}")))
        if t.ops_64:
            findings.append(Finding(
                rule=RULE, path=t.entry.relpath, line=t.entry.line, col=0,
                context=t.entry.qualname,
                message=(f"`{t.entry.qualname}` [{t.tag}] made 64-bit values "
                         f"outside f64-ok code: {'; '.join(t.ops_64[:4])}")))
    for p in ctx.pairs:
        if not p.mismatches:
            continue
        shown = "; ".join(p.mismatches[:4])
        findings.append(Finding(
            rule=RULE, path=p.table.relpath, line=p.table.line, col=0,
            context=p.table.qualname,
            message=(f"pair `{p.label}` [{p.tag}]: per-slot and table "
                     f"output trees disagree on dtype -- {shown}")))
    return findings

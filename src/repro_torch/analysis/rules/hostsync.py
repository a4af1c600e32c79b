"""SL004 host-sync: no hidden device->host transfers in designated hot paths.

The counterpart of ``repro.analysis.rules.hostsync``.  A ``.item()``,
``.cpu()`` or implicit ``bool()`` on a CUDA tensor blocks the host until the
card catches up: one stray sync in the service's round loop serializes it.

Hot paths are designated in source: a ``# symlint-torch: hot-path`` comment
on (or directly under) a ``def`` line marks that function.  Inside it,
values from ``torch.`` calls, ``.to(<device>)``, registered entries and
methods of such values are device-resident (``torchinfo``), as are
parameters annotated ``torch.Tensor``; flowing one into a concretization
(``.item()``, ``.tolist()``, ``.numpy()``, ``.cpu()``, ``.to(<cpu>)``,
``bool``/``int``/``float``, ``np.asarray``/``np.array``) or into an ``if``,
``while``, ternary or ``assert`` test is a finding unless the line carries
``# sync: ok`` -- the reviewed place where a round's one copy happens.
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from repro_torch.analysis.astutil import iter_functions
from repro_torch.analysis.dataflow import TaintWalker
from repro_torch.analysis.engine import (
    PREFIX, Finding, Project, SourceFile, register,
)
from repro_torch.analysis.torchinfo import (
    device_call_predicate, tensor_params,
)

RULE = "SL004"
HOT_PATH_MARKER = f"{PREFIX} hot-path"
SYNC_OK_MARKER = "sync: ok"


def _is_hot_path(sf: SourceFile, node: ast.AST) -> bool:
    """Marker on the decorator/def lines or the first body line."""
    first_body = node.body[0].lineno if getattr(node, "body", None) else \
        node.lineno
    start = min([node.lineno] + [d.lineno for d in
                                 getattr(node, "decorator_list", [])])
    return any(sf.has_marker(ln, HOT_PATH_MARKER)
               for ln in range(start, first_body + 1))


def hot_paths(project: Project):
    """``(relpath, qualname, node)`` of every marked function (cached)."""

    def build():
        out = []
        for rel, sf in sorted(project.files.items()):
            for qual, node in iter_functions(sf.tree):
                if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and _is_hot_path(sf, node)):
                    out.append((rel, qual, node))
        return out

    return project.cache("hot_paths", build)


@register(
    RULE, "host-sync",
    "Functions marked `# symlint-torch: hot-path` must not copy a device "
    "value to the host or branch on one except on lines annotated "
    "`# sync: ok`.",
)
def check(project: Project) -> Iterable[Finding]:
    from repro_torch.analysis.deep import entry_registry

    entries, _ = entry_registry(project)
    is_device_call = device_call_predicate(
        frozenset(e.qualname.split(".")[-1] for e in entries))
    findings: List[Finding] = []

    for rel, qual, node in hot_paths(project):
        sf = project.files[rel]

        def on_sink(n: ast.AST, kind: str, detail: str,
                    qual=qual, rel=rel, sf=sf) -> None:
            line = n.lineno
            if sf.has_marker(line, SYNC_OK_MARKER):
                return
            if kind == "branch":
                msg = (f"{detail} tests a device value in hot path "
                       f"`{qual}`: the implicit bool() blocks on the device "
                       f"-- copy the round's outputs to the host once "
                       f"(annotated `# sync: ok`) and branch on the host "
                       f"copy")
            else:
                msg = (f"{detail} on a device value in hot path `{qual}`: "
                       f"hidden device->host sync -- batch the round's "
                       f"transfers into one copy and annotate it "
                       f"`# sync: ok`")
            findings.append(Finding(
                rule=RULE, path=rel, line=line, col=n.col_offset,
                message=msg, context=qual))

        TaintWalker(tensor_params(node), is_device_call,
                    on_sink).walk(node.body)
    return findings

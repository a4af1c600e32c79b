"""The port's symlint deep tier: run the registered entries and check the
perf contracts on what they do.

The counterpart of ``repro.analysis.deep``.  The AST tier (SL004, SL005)
reads source text; this tier runs it.  Hot functions opt in with a
registry annotation on their ``def`` (or decorator) line:

    # symlint-torch: entry(drive=stream, budget=0, shapes=table-step)
    # symlint-torch: entry(pair=chunk/table, shapes=pair-chunk-table)

Annotation keys (any subset; comma-separated, order-free):

  * ``drive=<name>`` -- the scripted workload that exercises this entry
    (``stream``: the reference's resident ``StreamServer`` grow/shrink
    cycle, raw in and compressed in; ``chunked``: windowed encode/receive/
    finish passes; ``digitize``: repeated ``digitize_pieces`` calls;
    ``fleet``: repeated ``run_fleet`` slabs), at the reference's sizes.
    SL006 counts the host syncs (``synccount.SyncCounter``) each entry
    makes during the drive's *measured* window (everything after the
    warm-up); a sync counts to the innermost entry of that drive on the
    stack.
  * ``budget=<int>`` -- the entry's sync budget over that window on the
    card: the count measured on an H100 at the drive's seeded data when the
    budget was set.  ``cpu_budget=<int>`` is the same window's count on the
    CPU, where other code runs (no kernel branches, no copies across, the
    CPU-only per-cluster sums): it is what ``--device cpu`` (the tests)
    holds the drive to.  Every ``drive=`` entry declares both.  A ratchet:
    a new sync fails SL006, and a change that removes syncs lowers the
    budget.  Eager PyTorch compiles nothing at run time, so the reference's
    retrace budget becomes a sync budget: a host sync is the port's hidden
    host stall.
  * ``shapes=<builder>`` -- the operand builder (a name from ``OPERANDS``):
    the entry is called at small representative configurations (cadences
    k in {1, 2}, raw and pieces) for SL007's dtype scan.
  * ``pair=<label>/<role>`` -- bitwise-contract pair registration, role
    ``slot`` or ``table``; SL007 compares the two members' outputs leaf for
    leaf (dtype only: PyTorch has no weak types).

Entries are module-level functions or methods of module-level classes
(``StreamServer._step_blocks``).  ``# symlint-torch: f64-ok <reason>`` on a
``def`` marks a function whose float64 ops are deliberate (the port's
emulations of f32 rounding in f64); SL007 allows f64 ops only inside them.

``entry_registry`` is pure AST (importable without torch); everything else
lives behind ``prepare``, which imports torch lazily, resolves each entry to
its live module attribute, runs the probes and drives once on ``device``
(the card unless the caller asks for the CPU), and caches a
``DeepContext`` on the project for SL006 and SL007.  Failures are recorded as errors and surfaced as findings by the
owning rule -- a contract that cannot be verified is a finding, not a pass.
``drive_attributor`` hands the stream drive's entries to the check on the
card (``chip_smoke.py`` phase 13).
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import importlib
import importlib.util
import re
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.astutil import iter_functions
from repro_torch.analysis.engine import (
    PREFIX, Project, default_paths, load_project,
)
from repro_torch.analysis.synccount import Attributor, SyncCounter

__all__ = [
    "Entry", "DeepContext", "entry_registry", "f64_ok_registry", "prepare",
    "context", "OPERANDS", "DRIVES", "REFERENCE_ENTRIES",
    "REFERENCE_HOT_PATHS", "drive_attributor",
]

_ENTRY_RE = re.compile(re.escape(PREFIX) + r"\s*entry\(([^)]*)\)")
_F64_OK_RE = re.compile(re.escape(PREFIX) + r"\s*f64-ok\b(.*)")

#: the reference's 13 entries (``repro.analysis.deep``'s registry, by
#: relpath and qualname) and the port's functions that stand for each
REFERENCE_ENTRIES: Dict[str, Tuple[str, ...]] = {
    "src/repro/core/symed.py:_encode_chunk": ("symed_encode_chunk",),
    "src/repro/core/symed.py:_receive_chunk": ("symed_receive_chunk",),
    # the reference's one jitted finish serves both closes; the port's
    # two closes are two functions
    "src/repro/core/symed.py:_receive_finish": (
        "symed_finish", "symed_receive_finish"),
    "src/repro/core/symed.py:symed_receive_masked_chunk": (
        "symed_receive_masked_chunk",),
    "src/repro/core/symed.py:symed_receive_masked_chunk_table": (
        "symed_receive_masked_chunk_table",),
    "src/repro/core/symed.py:symed_receive_masked_pieces": (
        "symed_receive_masked_pieces",),
    "src/repro/core/symed.py:symed_receive_masked_pieces_table": (
        "symed_receive_masked_pieces_table",),
    "src/repro/core/digitize.py:digitize_span": ("digitize_span",),
    "src/repro/core/digitize.py:digitize_span_table": (
        "digitize_span_table",),
    "src/repro/core/digitize.py:digitize_pieces": ("digitize_pieces",),
    # merged: one method stages and steps either mode's table step
    "src/repro/launch/stream.py:_table_step": ("StreamServer._step_blocks",),
    "src/repro/launch/stream.py:_table_step_pieces": (
        "StreamServer._step_blocks",),
    # the reference's shard_map runner; the port runs the shard body
    # once per shard from Python
    "src/repro/launch/fleet.py:_mapped_runner": ("_encode_slab",),
}
#: the reference's four hot paths and the port's counterparts
REFERENCE_HOT_PATHS: Dict[str, str] = {
    "src/repro/launch/stream.py:StreamServer.ingest_many":
        "StreamServer.ingest_many",
    "src/repro/launch/stream.py:StreamServer.ingest_pieces_many":
        "StreamServer.ingest_pieces_many",
    "src/repro/launch/transport.py:TransportServer._flush":
        "TransportServer._flush",
    "src/repro/launch/fleet.py:_encode_slab": "_encode_slab",
}


def _split_args(argstr: str) -> List[str]:
    """Split on top-level commas."""
    parts, depth, cur = [], 0, []
    for ch in argstr:
        if ch in "[(":
            depth += 1
        elif ch in "])":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


@dataclasses.dataclass
class Entry:
    """One ``# symlint-torch: entry(...)`` registration."""

    relpath: str
    qualname: str
    line: int
    drive: Optional[str] = None
    budget: Optional[int] = None       # on the card
    cpu_budget: Optional[int] = None   # on the CPU
    shapes: Optional[str] = None
    pair_label: Optional[str] = None
    pair_role: Optional[str] = None
    # resolved by prepare():
    module: object = None
    fn: object = None


def _parse_entry(relpath: str, qualname: str, line: int,
                 argstr: str) -> Tuple[Optional[Entry], Optional[str]]:
    e = Entry(relpath=relpath, qualname=qualname, line=line)
    for part in _split_args(argstr):
        if "=" not in part:
            return None, f"entry() arg {part!r} is not key=value"
        key, _, val = part.partition("=")
        key, val = key.strip(), val.strip()
        if key == "drive":
            e.drive = val
        elif key in ("budget", "cpu_budget"):
            try:
                setattr(e, key, int(val))
            except ValueError:
                return None, f"entry() {key} {val!r} is not an int"
        elif key == "shapes":
            e.shapes = val
        elif key == "pair":
            label, sep, role = val.partition("/")
            if not sep or role not in ("slot", "table"):
                return None, (f"entry() pair {val!r} must be "
                              f"<label>/slot or <label>/table")
            e.pair_label, e.pair_role = label, role
        else:
            return None, f"entry() key {key!r} unknown"
    if e.drive is None and e.shapes is None:
        return None, "entry() needs at least drive= or shapes="
    if e.drive is not None and (e.budget is None or e.cpu_budget is None):
        return None, "entry() with drive= needs budget= and cpu_budget="
    return e, None


def budget_on(entry: Entry, device_type: str) -> Optional[int]:
    """The budget ``entry`` declares for a drive run on ``device_type``."""
    return entry.cpu_budget if device_type == "cpu" else entry.budget


def _module_level(tree: ast.AST) -> Dict[str, bool]:
    """Qualname -> True for every def that is module-level or a method of
    a module-level class (the defs an entry may sit on)."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = True
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{item.name}"] = True
    return out


def _def_lines(node) -> List[int]:
    return [node.lineno] + [d.lineno for d in node.decorator_list]


def entry_registry(project: Project) -> Tuple[List[Entry],
                                              List[Tuple[str, int, str]]]:
    """All entry annotations in the sweep (pure AST; no torch import).

    Returns ``(entries, errors)`` where each error is ``(relpath, line,
    message)`` -- malformed annotations and annotations on nested defs are
    errors, not silent skips.
    """

    def build():
        entries: List[Entry] = []
        errors: List[Tuple[str, int, str]] = []
        for rel, sf in sorted(project.files.items()):
            claimed = set()
            top = _module_level(sf.tree)
            for qual, node in iter_functions(sf.tree):
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                for ln in _def_lines(node):
                    m = _ENTRY_RE.search(sf.comments.get(ln, ""))
                    if m is None:
                        continue
                    claimed.add(ln)
                    if qual not in top:
                        errors.append(
                            (rel, ln, f"entry() on nested def {qual!r}: "
                             "entries must be module-level functions or "
                             "methods of module-level classes"))
                        continue
                    e, err = _parse_entry(rel, qual, node.lineno, m.group(1))
                    if err is not None:
                        errors.append((rel, ln, err))
                    else:
                        entries.append(e)
                    break
            for ln, comment in sf.comments.items():
                if ln not in claimed and _ENTRY_RE.search(comment):
                    errors.append(
                        (rel, ln, "entry() annotation not attached to any "
                         "function def/decorator line"))
        return entries, errors

    return project.cache("deep_entries", build)


def f64_ok_registry(project: Project) -> Tuple[List[Tuple[str, str]],
                                               List[Tuple[str, int, str]]]:
    """``(relpath, qualname)`` of every ``# symlint-torch: f64-ok <reason>``
    def, and the errors (a marker with no reason, or on no def)."""

    def build():
        marked, errors = [], []
        for rel, sf in sorted(project.files.items()):
            claimed = set()
            for qual, node in iter_functions(sf.tree):
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                for ln in _def_lines(node):
                    m = _F64_OK_RE.search(sf.comments.get(ln, ""))
                    if m is None:
                        continue
                    claimed.add(ln)
                    if not m.group(1).strip(" :-"):
                        errors.append((rel, ln, "f64-ok needs a one-line "
                                       "reason after the marker"))
                    else:
                        marked.append((rel, qual))
                    break
            for ln, comment in sf.comments.items():
                if ln not in claimed and _F64_OK_RE.search(comment):
                    errors.append((rel, ln, "f64-ok annotation not attached "
                                   "to any function def line"))
        return marked, errors

    return project.cache("deep_f64_ok", build)


# --------------------------------------------------------------------------
# runtime context

@dataclasses.dataclass
class Probe:
    """One call configuration of an entry."""

    tag: str            # pair-matching key ("k=1", "span", ...)
    fn: object
    args: tuple
    kwargs: dict


@dataclasses.dataclass
class TraceReport:
    entry: Entry
    tag: str
    out_64: List[str]            # output leaves of a 64-bit float dtype
    ops_64: List[str]            # ops that made one outside f64-ok code
    leaves: List[Tuple[str, str]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PairReport:
    label: str
    tag: str
    slot: Entry
    table: Entry
    mismatches: List[str]        # "leaf: slot=float32 table=float64"


@dataclasses.dataclass
class DriveReport:
    counter: SyncCounter         # the measured window's syncs
    notes: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DeepContext:
    device: str                         # the device type the tier ran on
    entries: List[Entry]
    traces: List[TraceReport]
    pairs: List[PairReport]
    drives: Dict[str, Dict[str, int]]   # drive -> qualname -> syncs
    drive_reports: Dict[str, DriveReport]
    errors: List[Tuple[str, Optional[Entry], str]]  # (stage, entry, message)


class _Rt:
    """Lazy torch namespace handed to builders and drives."""

    def __init__(self, device: str = "cpu"):
        import numpy as np
        import torch

        self.torch, self.np = torch, np
        self.device = torch.device(device)

    def small_cfg(self, mod):
        """Representative config, sized so a probe runs in well under a
        second on the CPU."""
        return mod.SymEDConfig(tol=0.5, alpha=0.02, scl=1.0, k_min=3,
                               k_max=8, len_max=16, n_max=32, lloyd_iters=2)

    def key(self, mod, seed: int = 0):
        return mod.prng.key(seed, device=self.device)

    def f32(self, x):
        return self.torch.as_tensor(self.np.asarray(x, self.np.float32),
                                    device=self.device)

    def i32(self, x):
        return self.torch.as_tensor(self.np.asarray(x, self.np.int32),
                                    device=self.device)


# --------------------------------------------------------------------------
# operand builders
#
# Each builder returns the probe list for one entry: tiny-but-representative
# shapes, cadences k in {1, 2} where the cadence is part of the contract,
# seeded non-zero data so the clustering runs.  Builders pull constructors
# off the *entry's own module*, so a test sweeping a mutated copy of a repo
# file probes the copy, not the installed module.

_S, _C, _P, _NMAX = 2, 8, 4, 32
_SPAN_KW = dict(tol=0.5, scl=1.0, k_min=3, k_max_active=8, lloyd_iters=2)


def _windows(rt):
    rng = rt.np.random.default_rng(0)
    return (rng.normal(size=(_S, _C)).astype(rt.np.float32),
            rt.np.full((_S,), _C, rt.np.int32))


def _pieces_host(rt):
    rng = rt.np.random.default_rng(1)
    pe = rt.np.zeros((_S, _C), rt.np.float32)
    ps = rt.np.zeros((_S, _C), rt.np.int32)
    pe[:, :_P] = rng.normal(size=(_S, _P))
    ps[:, :_P] = [1, 3, 5, 7]
    return (pe, ps, rt.np.full((_S,), _P, rt.np.int32),
            rng.normal(size=_S).astype(rt.np.float32),
            rt.np.full((_S,), _C, rt.np.int32))


def _b_table_step(rt, mod, fn):
    cfg = rt.small_cfg(mod)
    probes = []
    for k in (1, 2):
        for tag, step, host in (
                ("raw", mod.symed_receive_masked_chunk_table, _windows(rt)),
                ("pieces", mod.symed_receive_masked_pieces_table,
                 _pieces_host(rt))):
            srv = mod.StreamServer(cfg, max_sessions=_S, window_cap=_C,
                                   digitize_every_k=k, device=rt.device,
                                   obs=False)
            for s in range(_S):
                srv.open(f"s{s}")
            probes.append(Probe(f"{tag} k={k}", fn, (srv, step, host), {}))
    return probes


def _table(rt, mod, cfg):
    return mod.receiver_init(cfg, mod.prng.split(rt.key(mod), _S))


def _b_pair_chunk_slot(rt, mod, fn):
    cfg = rt.small_cfg(mod)
    w, nv = _windows(rt)
    state = mod.receiver_init(cfg, rt.key(mod))
    return [Probe(f"k={k}", fn, (rt.f32(w[0]), rt.i32(nv[0]), cfg, state),
                  dict(digitize_every_k=k)) for k in (1, 2)]


def _b_pair_chunk_table(rt, mod, fn):
    cfg = rt.small_cfg(mod)
    w, nv = _windows(rt)
    return [Probe(f"k={k}", fn, (rt.f32(w), rt.i32(nv), cfg,
                                 _table(rt, mod, cfg)),
                  dict(digitize_every_k=k)) for k in (1, 2)]


def _b_pair_pieces_slot(rt, mod, fn):
    cfg = rt.small_cfg(mod)
    pe, ps, nv, hello, tsn = _pieces_host(rt)
    state = mod.receiver_init(cfg, rt.key(mod))
    return [Probe(f"k={k}", fn, (rt.f32(pe[0]), rt.i32(ps[0]), int(nv[0]),
                                 float(hello[0]), int(tsn[0]), cfg, state),
                  dict(digitize_every_k=k)) for k in (1, 2)]


def _b_pair_pieces_table(rt, mod, fn):
    cfg = rt.small_cfg(mod)
    pe, ps, nv, hello, tsn = _pieces_host(rt)
    return [Probe(f"k={k}", fn, (rt.f32(pe), rt.i32(ps), rt.i32(nv),
                                 rt.f32(hello), rt.i32(tsn), cfg,
                                 _table(rt, mod, cfg)),
                  dict(digitize_every_k=k)) for k in (1, 2)]


def _span_operands(rt):
    rng = rt.np.random.default_rng(2)
    lens = rt.np.zeros((_S, _NMAX), rt.np.float32)
    incs = rt.np.zeros((_S, _NMAX), rt.np.float32)
    lens[:, :6] = rng.integers(1, 9, size=(_S, 6))
    incs[:, :6] = rng.normal(size=(_S, 6))
    return lens, incs, rt.np.zeros((_S,), rt.np.int32), rt.np.full(
        (_S,), 6, rt.np.int32)


def _b_pair_span_slot(rt, mod, fn):
    lens, incs, lo, hi = _span_operands(rt)
    state = mod.digitizer_init(_NMAX, 8, rt.key(mod))
    return [Probe("span", fn, (state, rt.f32(lens[0]), rt.f32(incs[0]),
                               int(lo[0]), int(hi[0])), dict(_SPAN_KW))]


def _b_pair_span_table(rt, mod, fn):
    lens, incs, lo, hi = _span_operands(rt)
    state = mod.digitizer_init(_NMAX, 8, mod.prng.split(rt.key(mod), _S))
    return [Probe("span", fn, (state, rt.f32(lens), rt.f32(incs),
                               rt.i32(lo), rt.i32(hi)), dict(_SPAN_KW))]


def _b_digitize_pieces(rt, mod, fn):
    lens, incs, _, _ = _span_operands(rt)
    return [Probe("pieces", fn, (rt.f32(lens[0]), rt.f32(incs[0]),
                                 rt.i32(6), rt.key(mod)),
                  dict(k_cap=8, **_SPAN_KW))]


def _stream(rt, n):
    rng = rt.np.random.default_rng(3)
    return rt.np.cumsum(rng.normal(size=n)).astype(rt.np.float32)


def _b_encode_chunk(rt, mod, fn):
    cfg = rt.small_cfg(mod)
    return [Probe("first", fn, (rt.f32(_stream(rt, _C)), cfg, None),
                  dict(device=rt.device))]


def _b_receive_chunk(rt, mod, fn):
    cfg = rt.small_cfg(mod)
    return [Probe(f"k={k}", fn, (rt.f32(_stream(rt, _C)), cfg, None,
                                 rt.key(mod)),
                  dict(digitize_every_k=k, device=rt.device))
            for k in (1, 2)]


def _b_receive_finish(rt, mod, fn):
    cfg = rt.small_cfg(mod)
    ts = _stream(rt, 2 * _C)
    state, _ = mod.symed_receive_chunk(ts, cfg, None, rt.key(mod),
                                       device=rt.device)
    return [Probe("finish", fn, (state, cfg, rt.f32(ts), True),
                  dict(with_delta=True))]


def _b_finish(rt, mod, fn):
    cfg = rt.small_cfg(mod)
    ts = _stream(rt, 2 * _C)
    state, events = mod.symed_encode_chunk(ts, cfg, None, device=rt.device)
    return [Probe("finish", fn, (events, state, cfg, rt.key(mod), ts),
                  dict(reconstruct=True, device=rt.device))]


def _b_encode_slab(rt, mod, fn):
    cfg = rt.small_cfg(mod)
    rng = rt.np.random.default_rng(4)
    slab = rt.f32(rng.normal(size=(_S, 4 * _C)).cumsum(-1))
    keys = mod.prng.split(rt.key(mod), _S)
    return [Probe("whole", fn, (slab, keys, cfg, None, None, True), {}),
            Probe("k=1", fn, (slab, keys, cfg, _C, 1, False), {})]


OPERANDS: Dict[str, Callable] = {
    "table-step": _b_table_step,
    "pair-chunk-slot": _b_pair_chunk_slot,
    "pair-chunk-table": _b_pair_chunk_table,
    "pair-pieces-slot": _b_pair_pieces_slot,
    "pair-pieces-table": _b_pair_pieces_table,
    "pair-span-slot": _b_pair_span_slot,
    "pair-span-table": _b_pair_span_table,
    "digitize-pieces": _b_digitize_pieces,
    "encode-chunk": _b_encode_chunk,
    "receive-chunk": _b_receive_chunk,
    "receive-finish": _b_receive_finish,
    "finish": _b_finish,
    "encode-slab": _b_encode_slab,
}


# --------------------------------------------------------------------------
# the dtype scan (SL007)

def _leaves(obj, path: str = "") -> List[Tuple[str, object]]:
    """``(path, tensor)`` of every tensor in a nest of NamedTuples, tuples,
    lists and dicts."""
    import torch

    if isinstance(obj, torch.Tensor):
        return [(path or "<out>", obj)]
    if isinstance(obj, dict):
        return [x for k, v in obj.items() for x in _leaves(v, f"{path}[{k!r}]")]
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return [x for k in obj._fields
                for x in _leaves(getattr(obj, k), f"{path}.{k}")]
    if isinstance(obj, (tuple, list)):
        return [x for i, v in enumerate(obj) for x in _leaves(v, f"{path}[{i}]")]
    return []


def _wide(dtype) -> bool:
    import torch

    return dtype in (torch.float64, torch.complex128)


def _f64_watch(allowed: Dict[object, str], attributor: Attributor):
    """A dispatch mode recording every op whose output is f64/c128 with no
    f64-ok function on the stack, as ``"op at site"``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Watch(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.hits: List[str] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(_wide(t.dtype) for _, t in _leaves(out)):
                frame = sys._getframe(1)
                ok = False
                while frame is not None and not ok:
                    ok = frame.f_code in allowed
                    frame = frame.f_back
                if not ok:
                    site = attributor.locate(sys._getframe(1))[1]
                    self.hits.append(f"{func} at {site}")
            return out

    return _Watch()


# --------------------------------------------------------------------------
# drives (SL006): warm up, then count the measured window's syncs

def _module_defining(entries: Sequence[Entry], qual_prefix: str):
    """The module of the first entry whose qualname starts with
    ``qual_prefix`` (a drive's entries may span modules)."""
    for e in entries:
        if e.qualname.startswith(qual_prefix):
            return e.module
    raise LookupError(f"no entry of this drive is {qual_prefix}*")


def _drive_stream(rt, entries, attributor) -> DriveReport:
    """The reference's cache-flatness script: a pretrace-warmed autoscaled
    server (capacity ladder 1 -> 2) serves two grow/shrink cycles of a raw
    and a compressed-in session; the measured window starts after
    construction."""
    mod = _module_defining(entries, "StreamServer.")
    np = rt.np
    cfg = rt.small_cfg(mod)
    srv = mod.StreamServer(cfg, max_sessions=2, window_cap=_C,
                           autoscale=True, min_slots=1, shrink_patience=1,
                           pretrace=True, device=rt.device)
    rng = np.random.default_rng(0)
    with SyncCounter(rt.device, attributor) as counter:
        for cycle in range(2):
            raw, pcs = f"r{cycle}", f"p{cycle}"
            srv.open(raw)
            srv.open(pcs)  # 1 -> 2 slots: grow
            srv.ingest(raw, rng.normal(size=_C).astype(np.float32))
            srv.ingest_pieces_many({pcs: {
                "endpoints": rng.normal(size=3).astype(np.float32),
                "steps": np.array([2, 5, 7], np.int32),
                "t_seen": _C, "t0": 0.0,
            }})
            srv.close(raw)
            srv.close(pcs)  # back to 1 slot: shrink
    return DriveReport(counter)


def _drive_chunked(rt, entries, attributor) -> DriveReport:
    """Windowed encode -> finish and receive -> finish passes at cadences
    k in {1, 2}; warm-up is one full pass, the measured window a second
    pass over different data at the same shapes."""
    mod = _module_defining(entries, "symed_")
    torch, np = rt.torch, rt.np
    cfg = rt.small_cfg(mod)
    key = rt.key(mod)

    def one_pass(seed):
        rng = np.random.default_rng(seed)
        ts = rng.normal(size=4 * _C).astype(np.float32)
        for k in (1, 2):
            st, evs = None, []
            for i in range(0, len(ts), _C):
                st, ev = mod.symed_encode_chunk(ts[i:i + _C], cfg, st,
                                                device=rt.device)
                evs.append(ev)
            events = {name: torch.cat([e[name] for e in evs], dim=-1)
                      for name in evs[0]}
            mod.symed_finish(events, st, cfg, key, ts, device=rt.device)
            rs = None
            for i in range(0, len(ts), _C):
                rs, _ = mod.symed_receive_chunk(ts[i:i + _C], cfg, rs, key,
                                                digitize_every_k=k,
                                                device=rt.device)
            mod.symed_receive_finish(rs, cfg, None, False, with_delta=True)

    one_pass(0)
    with SyncCounter(rt.device, attributor) as counter:
        one_pass(1)
    return DriveReport(counter)


def _drive_digitize(rt, entries, attributor) -> DriveReport:
    """Two ``digitize_pieces`` calls at one shape: the first warms up, the
    second is measured (``notes["host_syncs"]``: its rise of
    ``digitize.host_syncs``, the loop predicates' own count)."""
    mod = _module_defining(entries, "digitize_pieces")
    np = rt.np
    key = rt.key(mod)

    def call(seed):
        rng = np.random.default_rng(seed)
        lens = rt.f32(np.abs(rng.normal(size=_NMAX)))
        incs = rt.f32(rng.normal(size=_NMAX))
        mod.digitize_pieces(lens, incs, rt.i32(6), key, k_cap=8,
                            **_SPAN_KW)

    call(0)
    before = mod.host_syncs
    with SyncCounter(rt.device, attributor) as counter:
        call(1)
    return DriveReport(counter, {"host_syncs": mod.host_syncs - before})


def _drive_fleet(rt, entries, attributor) -> DriveReport:
    """Two same-shape streaming ``run_fleet`` slabs on one shard; the
    second is measured."""
    mod = _module_defining(entries, "_encode_slab")
    cfg = rt.small_cfg(mod)
    mesh = mod.fleet_data_mesh(1, device=rt.device)
    rng = rt.np.random.default_rng(0)

    def run(seed):
        data = rng.normal(size=(_S, 4 * _C)).astype(rt.np.float32)
        mod.run_fleet(data, cfg, rt.key(mod, seed), mesh, chunk_len=_C,
                      digitize_every_k=1, reconstruct=False, axis="data")

    run(0)
    with SyncCounter(rt.device, attributor) as counter:
        run(1)
    return DriveReport(counter)


DRIVES: Dict[str, Callable] = {
    "stream": _drive_stream,
    "chunked": _drive_chunked,
    "digitize": _drive_digitize,
    "fleet": _drive_fleet,
}


def _code_of(fn):
    import inspect

    return inspect.unwrap(fn).__code__


def _attributor(project: Project, group: Sequence[Entry]) -> Attributor:
    return Attributor({_code_of(e.fn): e.qualname for e in group},
                      project.root,
                      [project.root / rel for rel in project.files])


# --------------------------------------------------------------------------
# module resolution

def _load_module(root, relpath: str):
    """Repo files import as ``repro_torch.*`` (the live modules); anything
    else (test fixtures) loads from its file path under a content-hashed
    synthetic name."""
    if relpath.startswith("src/") and relpath.endswith(".py"):
        mod_name = relpath[len("src/"):-len(".py")].replace("/", ".")
        if mod_name.endswith(".__init__"):
            mod_name = mod_name[:-len(".__init__")]
        return importlib.import_module(mod_name)
    path = Path(root) / relpath
    digest = hashlib.sha1(path.read_bytes()).hexdigest()[:12]
    name = f"_symlint_torch_deep_{digest}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    # registered before exec: dataclass/typing machinery in the loaded file
    # looks itself up through sys.modules
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        sys.modules.pop(name, None)
        raise
    return mod


def _resolve(mod, qualname: str):
    obj = mod
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


# --------------------------------------------------------------------------
# prepare

def prepare(project: Project, device=None) -> DeepContext:
    """Resolve, probe and drive every registered entry on ``device`` (the
    card unless ``"cpu"`` is given; cached).  Must run before
    ``analyze(..., include_deep=True)``."""
    from repro_torch import resolve_device

    device = resolve_device(device)

    def build() -> DeepContext:
        entries, reg_errors = entry_registry(project)
        ok_defs, ok_errors = f64_ok_registry(project)
        errors: List[Tuple[str, Optional[Entry], str]] = [
            ("registry", Entry(relpath=rel, qualname="", line=ln), msg)
            for rel, ln, msg in reg_errors + ok_errors]
        rt = _Rt(device)

        resolved: List[Entry] = []
        for e in entries:
            try:
                e.module = _load_module(project.root, e.relpath)
                e.fn = _resolve(e.module, e.qualname)
            except Exception as exc:  # noqa: BLE001 -- surfaced as finding
                errors.append(("resolve", e, f"{type(exc).__name__}: {exc}"))
                continue
            resolved.append(e)
        allowed: Dict[object, str] = {}
        for rel, qual in ok_defs:
            try:
                fn = _resolve(_load_module(project.root, rel), qual)
                allowed[_code_of(fn)] = qual
            except Exception as exc:  # noqa: BLE001
                errors.append(("trace", Entry(relpath=rel, qualname=qual,
                                              line=1),
                               f"f64-ok def does not resolve: "
                               f"{type(exc).__name__}: {exc}"))
        scan_sites = _attributor(project, [])

        # -- probes: call + dtype scan --------------------------------------
        traces: List[TraceReport] = []
        for e in resolved:
            if e.shapes is None:
                continue
            try:
                build_probes = OPERANDS[e.shapes]
                probes = build_probes(rt, e.module, e.fn)
            except Exception as exc:  # noqa: BLE001
                errors.append(("operands", e,
                               f"{type(exc).__name__}: {exc}"))
                continue
            for probe in probes:
                watch = _f64_watch(allowed, scan_sites)
                try:
                    with watch:
                        out = probe.fn(*probe.args, **probe.kwargs)
                except Exception as exc:  # noqa: BLE001
                    errors.append(("trace", e, f"[{probe.tag}] "
                                   f"{type(exc).__name__}: {exc}"))
                    continue
                leaves = [(p, str(t.dtype).replace("torch.", ""))
                          for p, t in _leaves(out)]
                traces.append(TraceReport(
                    entry=e, tag=probe.tag,
                    out_64=[p for p, t in _leaves(out) if _wide(t.dtype)],
                    ops_64=sorted(set(watch.hits)), leaves=leaves))

        # -- pairs: leaf-for-leaf dtype comparison --------------------------
        pairs: List[PairReport] = []
        by_label: Dict[str, Dict[str, Entry]] = {}
        for e in resolved:
            if e.pair_label is not None:
                by_label.setdefault(e.pair_label, {})[e.pair_role] = e
        leaves_of = {(t.entry.relpath, t.entry.qualname, t.tag): t.leaves
                     for t in traces}
        for label, roles in sorted(by_label.items()):
            if set(roles) != {"slot", "table"}:
                only = next(iter(roles.values()))
                errors.append(("pair", only,
                               f"pair {label!r} is missing its "
                               f"{'table' if 'slot' in roles else 'slot'} "
                               "member"))
                continue
            slot, table = roles["slot"], roles["table"]
            tags = [t.tag for t in traces if t.entry is slot]
            for tag in tags:
                a = leaves_of.get((slot.relpath, slot.qualname, tag))
                b = leaves_of.get((table.relpath, table.qualname, tag))
                if a is None or b is None:
                    continue  # the probe failed; error recorded above
                if [x[0] for x in a] != [x[0] for x in b]:
                    mism = ["output tree structures differ"]
                else:
                    mism = [f"{pa}: slot={da} table={db}"
                            for (pa, da), (_, db) in zip(a, b) if da != db]
                pairs.append(PairReport(label=label, tag=tag, slot=slot,
                                        table=table, mismatches=mism))

        # -- drives: warm-up, then the measured window's syncs --------------
        drives: Dict[str, Dict[str, int]] = {}
        reports: Dict[str, DriveReport] = {}
        by_drive: Dict[str, List[Entry]] = {}
        for e in resolved:
            if e.drive is not None:
                by_drive.setdefault(e.drive, []).append(e)
        for name, group in sorted(by_drive.items()):
            fn = DRIVES.get(name)
            if fn is None:
                for e in group:
                    errors.append(("drive", e, f"unknown drive {name!r}"))
                continue
            try:
                rep = fn(rt, group, _attributor(project, group))
            except Exception as exc:  # noqa: BLE001
                for e in group:
                    errors.append(("drive", e,
                                   f"{type(exc).__name__}: {exc}"))
                continue
            reports[name] = rep
            drives[name] = rep.counter.by_entry()
        return DeepContext(device=device.type, entries=resolved,
                           traces=traces, pairs=pairs,
                           drives=drives, drive_reports=reports,
                           errors=errors)

    return project.cache("deep", build)


def context(project: Project) -> Optional[DeepContext]:
    """The prepared context, or None when ``prepare`` has not run."""
    return project._caches.get("deep")


# --------------------------------------------------------------------------
# the stream drive's entries, for the check on the card (phase 13)

def drive_attributor(root: Path, drive: str = "stream"):
    """The entries of ``drive`` in the default sweep under ``root``,
    resolved, and an ``Attributor`` for them."""
    project = load_project(root, default_paths(root))
    entries, errors = entry_registry(project)
    if errors:
        raise ValueError(f"entry registry errors: {errors}")
    group = [e for e in entries if e.drive == drive]
    for e in group:
        e.module = _load_module(root, e.relpath)
        e.fn = _resolve(e.module, e.qualname)
    return group, _attributor(project, group)


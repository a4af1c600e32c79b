"""CFG + fixpoint taint propagation over one function body.

A copy of ``repro.analysis.dataflow`` (the CFG and the may-taint fixpoint
are the reference's, unchanged), with PyTorch's sinks and three additions
that eager PyTorch code needs, where values flow through methods rather
than through ``jnp.`` calls:

  * a method called on a device value gives a device value (``t.sum()``,
    ``t.to(torch.int32)``), unless it reads static metadata
    (``t.size()``, ``t.dim()``, ``t.numel()``, ...) or is a sink;
  * the sinks are ``float``/``int``/``bool``/``np.asarray``/``np.array``
    of a device value and the tensor methods ``.item()``, ``.tolist()``,
    ``.numpy()``, ``.cpu()`` and ``.to(<cpu>)``;
  * a comprehension carries the taint of its iterable into its targets,
    and its result is a device value when its element is.

In the reference, SL002 (tracers inside jit) and SL004 (device values in
host hot paths) ask the same shape of question: *does this expression
carry a value of suspect origin, and is it flowing into a sink that would
concretize it?*  The port asks only SL004's.

The original walker was a single forward pass over the statements in source
order -- predictable, but blind to two whole families of flows: taint that
only reaches a use through a loop back edge (``prev`` assigned a device
value at the bottom of the loop, read at the top of the next iteration) and
taint that survives a branch because only *one* arm rebinds to a host value
(the straight-line pass saw the rebind and cleansed unconditionally).  This
version builds an explicit control-flow graph per function body -- branch,
loop, and try/except edges -- and solves may-taint reaching definitions
with a worklist fixpoint (union join at merge points), then replays each
block under its fixed-point entry environment to report sinks.  A flagged
line therefore means: *there exists a path through this function on which
the value at this sink is still device-resident*.

Taint model (unchanged from the single-pass walker):

  * seeds: taint the given dotted paths (traced parameters / device tables);
  * calls: a call whose callee matches ``source_call`` taints its result;
    conversion sinks (``float``/``int``/``bool``/``np.asarray``/``np.array``/
    ``jax.device_get``/``.item()``/``.tolist()``) *un*-taint theirs (they are
    the concretization point -- flagged once, then the value is host-side);
    ``len()`` and static metadata (``.shape``/``.dtype``/``.ndim``/``.size``)
    are never tainted (host-known without a sync);
  * propagation: assignment targets inherit the RHS taint (and are cleansed
    when the RHS is clean -- rebinding to a host value ends the taint *on
    paths through that rebind*; the union join keeps the taint alive when
    another path skips it);
  * joins: union (may-taint) -- at an ``if``/``else`` merge, a loop header,
    or an ``except`` entry, a name is tainted if it is tainted on *any*
    inbound edge.  ``except`` entries join the environments after every
    statement of the ``try`` body (the raise may happen anywhere).

Sinks are reported through a callback, each source location at most once;
nested ``def``s are skipped (they get their own analysis if jitted), nested
lambdas are walked with their parameters tainted (vmap bodies).
"""
from __future__ import annotations

import ast
from typing import Callable, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.astutil import dotted

__all__ = ["STATIC_ATTRS", "CONVERTER_CALLS", "TaintWalker", "assigned_names",
           "host_transfer"]

STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout"}

#: callee paths that concretize their (tainted) argument on the host
CONVERTER_CALLS = {
    "float", "int", "bool",
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
}
_CONVERTER_METHODS = {"item", "tolist", "numpy", "cpu"}
#: tensor methods that read host-known metadata: never device values
_HOST_METHODS = {"size", "dim", "numel", "nelement", "element_size",
                 "stride", "is_contiguous", "is_floating_point", "data_ptr",
                 "get_device"}


def _cpu_target(node: ast.expr) -> bool:
    """``"cpu"``, ``torch.device("cpu")`` or ``"cpu:N"`` spelled out."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] == "cpu"
    if (isinstance(node, ast.Call) and dotted(node.func) == "torch.device"
            and node.args):
        return _cpu_target(node.args[0])
    return False


def host_transfer(call: ast.Call) -> str:
    """The sink label of a tensor method that copies to the host
    (``".item()"``, ``".to(<cpu>)"``, ...), or ``""``."""
    if not isinstance(call.func, ast.Attribute):
        return ""
    method = call.func.attr
    if method in _CONVERTER_METHODS:
        return f".{method}()"
    if method == "to":
        target = call.args[0] if call.args else next(
            (k.value for k in call.keywords if k.arg == "device"), None)
        if target is not None and _cpu_target(target):
            return ".to(<cpu>)"
    return ""
_NEVER_TAINTED_CALLS = {"len", "isinstance", "range", "enumerate", "max",
                        "min", "print", "sorted", "list", "tuple", "dict",
                        "set", "repr", "str"}


def assigned_names(node: ast.AST) -> Set[str]:
    """Every simple name bound by assignments / for-targets under ``node``."""
    out: Set[str] = set()

    def targets(t):
        if isinstance(t, ast.Name):
            out.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                targets(e)
        elif isinstance(t, ast.Starred):
            targets(t.value)

    for n in ast.walk(node):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                targets(t)
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
            targets(n.target)
        elif isinstance(n, (ast.For, ast.AsyncFor)):
            targets(n.target)
        elif isinstance(n, (ast.withitem,)) and n.optional_vars is not None:
            targets(n.optional_vars)
        elif isinstance(n, ast.NamedExpr):
            targets(n.target)
        elif isinstance(n, ast.comprehension):
            targets(n.target)
    return out


# --------------------------------------------------------------------------
# control-flow graph
#
# Blocks hold a list of *ops* -- (kind, payload...) tuples mirroring exactly
# the statement effects the single-pass walker modeled -- so the fixpoint
# transfer function and the sink-reporting replay interpret one shared
# representation.

class _Block:
    __slots__ = ("ops", "succs", "index")

    def __init__(self, index: int):
        self.ops: List[tuple] = []
        self.succs: List["_Block"] = []
        self.index = index

    def link(self, other: "_Block") -> None:
        if other is not None and other not in self.succs:
            self.succs.append(other)


class _Ctx:
    """Builder context: where ``break``/``continue``/``raise`` edges go."""

    __slots__ = ("break_to", "continue_to", "handlers")

    def __init__(self, break_to=None, continue_to=None, handlers=()):
        self.break_to = break_to
        self.continue_to = continue_to
        self.handlers = tuple(handlers)


class _CFG:
    def __init__(self):
        self.blocks: List[_Block] = []
        self.entry = self.new_block()
        self.exit = self.new_block()

    def new_block(self) -> _Block:
        b = _Block(len(self.blocks))
        self.blocks.append(b)
        return b

    # -- construction ------------------------------------------------------

    def build(self, body: Iterable[ast.stmt]) -> None:
        end = self._stmts(list(body), self.entry, _Ctx())
        if end is not None:
            end.link(self.exit)

    def _emit(self, cur: _Block, op: tuple, ctx: _Ctx) -> _Block:
        """Append ``op``; under a live ``try`` every op gets its own block
        with an exception edge to each handler (the raise may interrupt
        anywhere, so handlers join the environment after every statement)."""
        cur.ops.append(op)
        if ctx.handlers:
            nxt = self.new_block()
            cur.link(nxt)
            for h in ctx.handlers:
                cur.link(h)
            return nxt
        return cur

    def _stmts(self, body: List[ast.stmt], cur: Optional[_Block],
               ctx: _Ctx) -> Optional[_Block]:
        """Lower ``body`` starting at ``cur``; return the fall-through block
        (``None`` when every path terminated via return/break/continue)."""
        for stmt in body:
            if cur is None:  # unreachable tail: park it in a fresh island
                cur = self.new_block()
            cur = self._stmt(stmt, cur, ctx)
        return cur

    def _stmt(self, stmt: ast.stmt, cur: _Block,
              ctx: _Ctx) -> Optional[_Block]:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return cur  # nested defs get their own analysis
        if isinstance(stmt, ast.If):
            cur = self._emit(cur, ("test", stmt.test, "`if` statement",
                                   stmt), ctx)
            then_b, else_b, after = (self.new_block(), self.new_block(),
                                     self.new_block())
            cur.link(then_b)
            cur.link(else_b)
            t_end = self._stmts(stmt.body, then_b, ctx)
            e_end = self._stmts(stmt.orelse, else_b, ctx)
            if t_end is not None:
                t_end.link(after)
            if e_end is not None:
                e_end.link(after)
            return after
        if isinstance(stmt, ast.While):
            header, body_b, after = (self.new_block(), self.new_block(),
                                     self.new_block())
            cur.link(header)
            header = self._emit(header, ("test", stmt.test,
                                         "`while` statement", stmt), ctx)
            header.link(body_b)
            loop_ctx = _Ctx(after, header, ctx.handlers)
            b_end = self._stmts(stmt.body, body_b, loop_ctx)
            if b_end is not None:
                b_end.link(header)
            if stmt.orelse:
                else_b = self.new_block()
                header.link(else_b)
                e_end = self._stmts(stmt.orelse, else_b, ctx)
                if e_end is not None:
                    e_end.link(after)
            else:
                header.link(after)
            return after
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            header, body_b, after = (self.new_block(), self.new_block(),
                                     self.new_block())
            cur.link(header)
            # the bind runs once per iteration: placing it in the header
            # lets taint computed at the bottom of the body flow back into
            # the next iteration's environment
            header = self._emit(header, ("forbind", stmt.target, stmt.iter,
                                         stmt), ctx)
            header.link(body_b)
            loop_ctx = _Ctx(after, header, ctx.handlers)
            b_end = self._stmts(stmt.body, body_b, loop_ctx)
            if b_end is not None:
                b_end.link(header)
            if stmt.orelse:
                else_b = self.new_block()
                header.link(else_b)
                e_end = self._stmts(stmt.orelse, else_b, ctx)
                if e_end is not None:
                    e_end.link(after)
            else:
                header.link(after)
            return after
        if isinstance(stmt, ast.Try):
            h_entries = [self.new_block() for _ in stmt.handlers]
            after = self.new_block()
            for h in h_entries:
                cur.link(h)  # the very first statement may raise
            body_ctx = _Ctx(ctx.break_to, ctx.continue_to,
                            tuple(h_entries) + ctx.handlers)
            b_end = self._stmts(stmt.body, cur, body_ctx)
            ends = []
            if b_end is not None:
                if stmt.orelse:
                    ends.append(self._stmts(stmt.orelse, b_end, ctx))
                else:
                    ends.append(b_end)
            for h, entry in zip(stmt.handlers, h_entries):
                ends.append(self._stmts(h.body, entry, ctx))
            if stmt.finalbody:
                fin = self.new_block()
                for e in ends:
                    if e is not None:
                        e.link(fin)
                f_end = self._stmts(stmt.finalbody, fin, ctx)
                if f_end is not None:
                    f_end.link(after)
            else:
                for e in ends:
                    if e is not None:
                        e.link(after)
            return after
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                cur = self._emit(cur, ("withbind", item.optional_vars,
                                       item.context_expr, stmt), ctx)
            return self._stmts(stmt.body, cur, ctx)
        if isinstance(stmt, ast.Assert):
            return self._emit(cur, ("test", stmt.test, "`assert` statement",
                                    stmt), ctx)
        if isinstance(stmt, ast.Assign):
            return self._emit(cur, ("assign", stmt.targets, stmt.value,
                                    stmt), ctx)
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is None:
                return cur
            return self._emit(cur, ("assign", [stmt.target], stmt.value,
                                    stmt), ctx)
        if isinstance(stmt, ast.AugAssign):
            return self._emit(cur, ("augassign", stmt.target, stmt.value,
                                    stmt), ctx)
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                cur = self._emit(cur, ("expr", stmt.value, stmt), ctx)
            cur.link(self.exit)
            return None
        if isinstance(stmt, ast.Raise):
            for v in (stmt.exc, stmt.cause):
                if v is not None:
                    cur = self._emit(cur, ("expr", v, stmt), ctx)
            for h in ctx.handlers:
                cur.link(h)
            cur.link(self.exit)
            return None
        if isinstance(stmt, ast.Break):
            if ctx.break_to is not None:
                cur.link(ctx.break_to)
            return None
        if isinstance(stmt, ast.Continue):
            if ctx.continue_to is not None:
                cur.link(ctx.continue_to)
            return None
        if isinstance(stmt, ast.Expr):
            return self._emit(cur, ("expr", stmt.value, stmt), ctx)
        # anything else (Import, Pass, Delete, Global, ...): scan child
        # expressions conservatively, no environment effect
        return self._emit(cur, ("other", stmt), ctx)


class TaintWalker:
    """Analyze one function body, reporting ``(node, kind, detail)`` sinks.

    ``kind`` is one of ``"convert"`` (explicit concretization call),
    ``"branch"`` (if/while/ternary/assert on a tainted test).

    ``walk(body)`` builds the body's CFG, solves the may-taint fixpoint,
    and replays every reachable block under its fixed-point entry
    environment.  ``expr_tainted``/``_scan_expr`` evaluate against the
    walker's *current* environment (``self.tainted``) -- before ``walk``
    that is the seed set, which is what lambda-body scans rely on.
    """

    def __init__(
        self,
        seeds: Iterable[str],
        source_call: Callable[[ast.Call], bool],
        on_sink: Callable[[ast.AST, str, str], None],
        branch_sinks: bool = True,
    ):
        self.tainted: Set[str] = set(seeds)
        self.seeds = frozenset(self.tainted)
        self.source_call = source_call
        self.on_sink = on_sink
        self.branch_sinks = branch_sinks
        self._reported: Set[Tuple[int, str]] = set()

    # -- expression taint --------------------------------------------------

    def expr_tainted(self, node: Optional[ast.AST]) -> bool:
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                return False
            path = dotted(node)
            if path is not None and path in self.tainted:
                return True
            return self.expr_tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self.expr_tainted(node.value)
        if isinstance(node, ast.Call):
            callee = dotted(node.func) or ""
            method = (node.func.attr
                      if isinstance(node.func, ast.Attribute) else "")
            if (callee in CONVERTER_CALLS
                    or host_transfer(node)
                    or method in _HOST_METHODS
                    or callee in _NEVER_TAINTED_CALLS):
                return False  # result is host-side by construction
            if self.source_call(node):
                return True
            if method and self.expr_tainted(node.func.value):
                return True  # a method of a device value
            return (any(self.expr_tainted(a) for a in node.args)
                    or any(self.expr_tainted(k.value) for k in node.keywords))
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            sub = self._comprehension_walker(node.generators)
            if isinstance(node, ast.DictComp):
                return sub.expr_tainted(node.value)
            return sub.expr_tainted(node.elt)
        if isinstance(node, (ast.BinOp,)):
            return self.expr_tainted(node.left) or self.expr_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.expr_tainted(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.expr_tainted(v) for v in node.values)
        if isinstance(node, ast.Compare):
            return (self.expr_tainted(node.left)
                    or any(self.expr_tainted(c) for c in node.comparators))
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.expr_tainted(e) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return self.expr_tainted(node.body) or self.expr_tainted(node.orelse)
        if isinstance(node, ast.Starred):
            return self.expr_tainted(node.value)
        return False

    def _comprehension_walker(self, generators) -> "TaintWalker":
        """A walker whose environment binds each generator's targets with
        the taint of its iterable (in order: a later iterable may read an
        earlier target)."""
        sub = TaintWalker(self.tainted, self.source_call, self.on_sink,
                          self.branch_sinks)
        sub._reported = self._reported
        for gen in generators:
            sub._assign(gen.target, sub.expr_tainted(gen.iter))
        return sub

    # -- sink scan ---------------------------------------------------------

    def _report(self, node: ast.AST, kind: str, detail: str) -> None:
        key = (getattr(node, "lineno", -1), getattr(node, "col_offset", -1),
               kind, detail)
        if key in self._reported:
            return  # a loop header replays; each sink fires once
        self._reported.add(key)
        self.on_sink(node, kind, detail)

    def _scan_expr(self, node: ast.AST) -> None:
        """Find sinks inside one expression (ordered, lambda-aware)."""
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested defs get their own analysis
        if isinstance(node, ast.Lambda):
            sub = TaintWalker(
                self.tainted | {a.arg for a in node.args.args},
                self.source_call, self.on_sink, self.branch_sinks)
            sub._reported = self._reported
            sub._scan_expr(node.body)
            return
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            for i, gen in enumerate(node.generators):
                self._comprehension_walker(node.generators[:i])._scan_expr(
                    gen.iter)
            sub = self._comprehension_walker(node.generators)
            for gen in node.generators:
                for cond in gen.ifs:
                    sub._scan_expr(cond)
            for part in ((node.key, node.value)
                         if isinstance(node, ast.DictComp) else (node.elt,)):
                sub._scan_expr(part)
            return
        if isinstance(node, ast.Call):
            callee = dotted(node.func) or ""
            sink = host_transfer(node)
            args_tainted = (
                any(self.expr_tainted(a) for a in node.args)
                or any(self.expr_tainted(k.value) for k in node.keywords))
            if callee in CONVERTER_CALLS and args_tainted:
                self._report(node, "convert", f"{callee}()")
            elif sink and self.expr_tainted(node.func.value):
                self._report(node, "convert", sink)
        if isinstance(node, ast.IfExp) and self.branch_sinks:
            if self.expr_tainted(node.test):
                self._report(node, "branch", "conditional expression")
        for child in ast.iter_child_nodes(node):
            self._scan_expr(child)

    # -- environment effects -----------------------------------------------

    def _assign(self, target: ast.AST, value_tainted: bool) -> None:
        path = dotted(target)
        if path is not None:
            if value_tainted:
                self.tainted.add(path)
            else:
                self.tainted.discard(path)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._assign(e, value_tainted)
        elif isinstance(target, ast.Starred):
            self._assign(target.value, value_tainted)

    def _apply(self, op: tuple) -> None:
        """Mutate ``self.tainted`` with one op's binding effect."""
        kind = op[0]
        if kind == "assign":
            _, targets, value, _ = op
            t = self.expr_tainted(value)
            for target in targets:
                self._assign(target, t)
        elif kind == "augassign":
            _, target, value, _ = op
            if self.expr_tainted(value):
                self._assign(target, True)
        elif kind == "forbind":
            _, target, it, _ = op
            self._assign(target, self.expr_tainted(it))
        elif kind == "withbind":
            _, var, ctx_expr, _ = op
            if var is not None:
                self._assign(var, self.expr_tainted(ctx_expr))

    def _scan_op(self, op: tuple) -> None:
        """Report the sinks one op can reach (run *before* its effect)."""
        kind = op[0]
        if kind == "assign":
            self._scan_expr(op[2])
        elif kind == "augassign":
            self._scan_expr(op[2])
        elif kind == "forbind":
            self._scan_expr(op[2])
        elif kind == "withbind":
            self._scan_expr(op[2])
        elif kind == "test":
            _, expr, label, stmt = op
            self._scan_expr(expr)
            if self.branch_sinks and self.expr_tainted(expr):
                self._report(stmt, "branch", label)
        elif kind == "expr":
            self._scan_expr(op[1])
        elif kind == "other":
            for child in ast.iter_child_nodes(op[1]):
                if isinstance(child, ast.expr):
                    self._scan_expr(child)

    # -- fixpoint ----------------------------------------------------------

    def walk(self, body: Iterable[ast.stmt]) -> None:
        cfg = _CFG()
        cfg.build(body)

        # worklist may-taint: in[b] = union(out[p] for p in preds(b)),
        # out[b] = transfer(b, in[b]); monotone (union join, effects applied
        # under growing environments only ever grow the union), so it
        # terminates in O(blocks * names) rounds
        in_env = {cfg.entry.index: frozenset(self.seeds)}
        work = [cfg.entry]
        while work:
            b = work.pop()
            env = in_env.get(b.index)
            if env is None:
                continue
            self.tainted = set(env)
            for op in b.ops:
                self._apply(op)
            out = frozenset(self.tainted)
            for s in b.succs:
                prev = in_env.get(s.index)
                merged = out if prev is None else (prev | out)
                if prev is None or merged != prev:
                    in_env[s.index] = merged
                    work.append(s)

        # replay reachable blocks in source order under their fixed-point
        # entry environments, reporting sinks as the single-pass walker did
        def first_line(b: _Block) -> int:
            for op in b.ops:  # every op carries its statement node last
                ln = getattr(op[-1], "lineno", None)
                if ln is not None:
                    return ln
            return 1 << 30

        for b in sorted(cfg.blocks, key=lambda b: (first_line(b), b.index)):
            env = in_env.get(b.index)
            if env is None or not b.ops:
                continue  # unreachable
            self.tainted = set(env)
            for op in b.ops:
                self._scan_op(op)
                self._apply(op)

        self.tainted = set(self.seeds)

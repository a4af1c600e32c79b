"""Collective inventory of a sharded program: the counterpart of
``repro.utils.hlo``'s inventory half (``parse_collectives``,
``collective_wire_bytes``; its roofline half is ``utils.roofline``).

The reference compiles a cell for its mesh and reads the collectives that
GSPMD inserted from the optimized HLO text.  The port has no partitioner of
its own: it runs the step on ``DTensor`` parameters and inputs inside
``fake_world`` -- a fake process group of the mesh's size, this process its
rank 0 -- and ``DTensor``'s sharding propagation issues, op by op, the
``_c10d_functional`` collectives that rank would run.  ``CollectiveCounter``
records them as they are dispatched; ``sharding.ctx.constrain`` redistributes
a ``DTensor`` to its site's spec, where the reference's
``with_sharding_constraint`` has GSPMD insert its collectives.

Records carry the reference's keys: ``op`` under the reference's names
(``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
``collective-permute``), ``result_bytes`` in its convention (the gathered
result of an all-gather, the scattered shard of a reduce-scatter, the
tensor itself of an all-reduce, the result of an all-to-all), ``group``
(the process group's size) and ``count``.  The reference multiplies a
collective inside a while loop by the loop's trip count, because XLA's text
holds the body once; the port's trace is eager and runs every iteration of
every loop, so ``count`` is the number of times the collective was issued
and needs no multiplier.

``collective_wire_bytes`` is the reference's, formula for formula and in
its order of arithmetic (wire bytes per device, ring algorithms, group g):

    all-reduce       2 * R * (g-1)/g
    all-gather           R * (g-1)/g      (R = gathered result)
    reduce-scatter       R * (g-1)        (R = scattered shard)
    all-to-all           R * (g-1)/g
    collective-permute   R

``torch.distributed`` and ``DTensor`` are imported inside the functions that
use them, so that importing this module (or ``repro_torch``) stays light.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.sharding.partition import P

__all__ = ["CollectiveCounter", "InventoryError", "collective_wire_bytes",
           "per_op",
           "fake_world", "placements", "to_dtensor", "distribute_params",
           "count_collectives", "reference_op"]

# the port's collective ops -> the reference's names.  ``shard_dim_alltoall``
# is DTensor's own op for a shard-to-shard move on one mesh dim (an
# ``all_to_all_single`` on the card's NCCL groups).
_OPS = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "c10d_functional", "c10d")
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")


class InventoryError(RuntimeError):
    """A collective the inventory cannot record: it fails the cell, as an
    unsupported collective does in the reference's."""


def reference_op(func) -> str | None:
    """The reference's name of the collective ``func`` (an op overload or
    packet), ``None`` if it is no collective.  A collective this module
    cannot name raises: the inventory would be wrong without it."""
    packet = getattr(func, "_overloadpacket", func)
    ns, name = packet._qualified_op_name.split("::")
    if ns == "_dtensor":
        return _OPS.get(name) if name == "shard_dim_alltoall" else None
    if ns not in _COLLECTIVE_NAMESPACES or name in _NOT_COLLECTIVES:
        return None
    if name not in _OPS:
        raise InventoryError(f"collective {ns}::{name} has no counterpart "
                             "in the reference's inventory")
    return _OPS[name]


def _group_size(func, args, kwargs) -> int:
    """The size of the process group a collective runs over (its last
    argument, a group name or a process group)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    schema = func._schema
    bound = dict(zip((a.name for a in schema.arguments), args))
    bound.update(kwargs or {})
    for key in ("group_name", "group", "tag"):
        g = bound.get(key)
        if g is None:
            continue
        if isinstance(g, str):
            g = _resolve_process_group(g)
        return int(g.size())
    raise InventoryError(f"{func}: no process group in its arguments")


def _nbytes(out: torch.Tensor) -> int:
    return out.numel() * out.element_size()


class CollectiveCounter(TorchDispatchMode):
    """Records every collective dispatched under it (``wait_tensor`` is not
    one).  ``records`` lists one dict per distinct ``(op, result_bytes,
    group)`` in the order first seen, ``count`` the times it was issued.

    Ops on ``DTensor``s return ``NotImplemented`` here, so that ``DTensor``
    runs first and its collectives on the local tensors reach this mode, as
    ``torch.distributed.tensor.debug.CommDebugMode`` does."""

    def __init__(self):
        super().__init__()
        self._index: Dict[tuple, dict] = {}
        self.records: List[dict] = []
        # count_collectives fills these two (``_NoPlan``)
        self.replicated: Dict[str, int] = {}
        self.gathered: Dict[str, int] = {}
        # collectives of attempts that failed (``_NoPlan``), per op
        self.withdrawn: Dict[str, int] = {}

    def mark(self):
        """The counts as they stand, for ``rewind``."""
        return [(rec, rec["count"]) for rec in self.records]

    def rewind(self, mark) -> None:
        """Back to the counts of ``mark``: what was issued since moves to
        ``withdrawn`` (per op), out of the inventory."""
        kept = {id(rec): n for rec, n in mark}
        for rec in self.records:
            n, op = rec["count"] - kept.get(id(rec), 0), rec["op"]
            if n:
                self.withdrawn[op] = self.withdrawn.get(op, 0) + n
        self.records = [rec for rec, _ in mark]
        for rec, n in mark:
            rec["count"] = n
        self._index = {(r["op"], r["result_bytes"], r["group"]): r
                       for r in self.records}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(t is DTensor for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        op = reference_op(func)
        if op is not None:
            key = (op, _nbytes(out), _group_size(func, args, kwargs))
            rec = self._index.get(key)
            if rec is None:
                rec = self._index[key] = {"op": key[0], "result_bytes": key[1],
                                          "group": key[2], "count": 0}
                self.records.append(rec)
            rec["count"] += 1
        return out


def collective_wire_bytes(colls: Sequence[dict]) -> float:
    """Wire bytes per device of an inventory: the reference's formulas in
    its order of arithmetic (so equal to its result bit for bit)."""
    total = 0.0
    for c in colls:
        r, g = c["result_bytes"], max(c["group"], 1)
        n = c.get("count", 1.0)
        if c["op"] == "all-reduce":
            total += n * 2.0 * r * (g - 1) / g
        elif c["op"] == "all-gather":
            total += n * r * (g - 1) / g
        elif c["op"] == "reduce-scatter":
            total += n * r * (g - 1)
        elif c["op"] == "all-to-all":
            total += n * r * (g - 1) / g
        elif c["op"] == "collective-permute":
            total += n * r
    return total


def per_op(colls: Sequence[dict]) -> Dict[str, dict]:
    """The dry run's ``collectives`` field, as the reference shapes it: per
    op, ``count`` and ``weighted_result_bytes`` (bytes times count)."""
    out: Dict[str, dict] = {}
    for c in colls:
        out.setdefault(c["op"], {"count": 0.0, "weighted_result_bytes": 0.0})
        out[c["op"]]["count"] += c.get("count", 1.0)
        out[c["op"]]["weighted_result_bytes"] += (
            c["result_bytes"] * c.get("count", 1.0))
    return out


@contextlib.contextmanager
def fake_world(mesh, device_type: str = "cuda") -> Iterator:
    """A fake process group of ``mesh``'s size with this process its rank 0,
    and the ``DeviceMesh`` over it whose dims are ``mesh.axis_names``
    (yielded).  Nothing is communicated.  ``device_type`` picks the
    collectives ``DTensor`` chooses: ``cuda``, the card's (NCCL's
    all-to-all), or ``cpu``, a gloo world's (``DTensor`` gathers and chunks
    there in place of an all-to-all); the tensors may live anywhere, the
    ``meta`` device included.  The group is destroyed on the way out,
    whatever the body raised."""
    import torch.distributed as dist
    # registers the ``fake`` backend and its store
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import DeviceMesh

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialized in this process")
    shape = tuple(np.asarray(mesh.devices).shape)
    n = math.prod(shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield DeviceMesh(device_type, torch.arange(n).reshape(shape),
                         mesh_dim_names=tuple(mesh.axis_names))
    finally:
        dist.destroy_process_group()


def placements(spec, axis_names: Sequence[str]) -> list:
    """``spec`` (a ``P``) as ``DTensor`` placements over a mesh with dims
    ``axis_names``.  A dim that a tuple of axes shards jointly is split in
    mesh-dim order by ``DTensor``; ``P`` puts the first axis major, so the
    tuple must list its axes in mesh order.  A spec that placements cannot
    represent raises (an axis is never dropped)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(P(*spec)):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        at = [names.index(a) if a in names else -1 for a in axes]
        if -1 in at:
            raise ValueError(f"spec {spec!r}: axis not in the mesh "
                             f"{tuple(names)}")
        if at != sorted(at):
            raise ValueError(f"spec {spec!r}: dim {dim} shards over {axes} "
                             f"major first, which DTensor (mesh order "
                             f"{tuple(names)}) cannot represent")
        for i in at:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec!r}: mesh axis {names[i]!r} "
                                 "shards two dims")
            out[i] = Shard(dim)
    return out


def to_dtensor(t: torch.Tensor, dm, spec):
    """``t`` laid out by ``spec`` on the ``DeviceMesh`` ``dm`` as a
    ``DTensor``.  A ``meta`` tensor stands for its global shape: the local
    piece is a new ``meta`` tensor of the shard's shape, so nothing is
    allocated (``FakeTensorMode`` is not used: torch 2.13's DTensor reads
    a strided shard's offsets with ``.tolist()``, which a fake tensor
    refuses).  A real tensor is the same global value on every rank: each
    rank keeps its own block, with no communication."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    pl = placements(spec, dm.mesh_dim_names)
    if not t.is_meta:
        return distribute_tensor(t, dm, pl, src_data_rank=None)
    local = list(t.shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            if local[p.dim] % dm.size(i):
                raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does not "
                                 f"divide over {dm.size(i)} shards")
            local[p.dim] //= dm.size(i)
    piece = torch.empty(local, dtype=t.dtype, device="meta")
    return DTensor.from_local(piece, dm, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute_params(params, dm, mesh):
    """A copy of the model ``params`` (a ``ParamTree``) whose parameters are
    ``DTensor``s laid out by ``sharding.partition.spec_for_path``: a
    superblock's leaf takes the trailing entries of its stacked leaf's
    spec (the logical axes right-align)."""
    from torch import nn

    from repro_torch.models.layers import ParamTree
    from repro_torch.sharding.partition import spec_for_path

    def rebuild(module, prefix):
        if isinstance(module, nn.ModuleList):
            return nn.ModuleList(rebuild(m, f"{prefix}{i}.")
                                 for i, m in enumerate(module))
        kids = {}
        for name, p in module._parameters.items():
            spec = spec_for_path(prefix + name, tuple(p.shape), mesh)
            kids[name] = to_dtensor(p.detach(), dm, spec)
        for name, m in module._modules.items():
            kids[name] = rebuild(m, f"{prefix}{name}.")
        return ParamTree(**kids)

    with torch.no_grad():
        return rebuild(params, "")


class _NoPlan(TorchDispatchMode):
    """The inventory's policy where ``DTensor`` has no plan a ``P`` can
    say, in two rules that read nothing from an error's text:

    1. An op ``DTensor`` cannot run on its inputs' placements (it has no
       rule for the op, or its rule or redistribution raises) runs on
       whole values, as a partitioner without a rule for it would: every
       ``DTensor`` input is gathered whole (``Replicate`` on every mesh
       dim: a partial sum reduced, shards gathered; counted), the op runs
       on the whole local tensors and its outputs are replicated
       ``DTensor``s; an in-place op writes its whole result back into its
       buffer's own shards (a local chunk, no collective).  The failed
       attempt's collectives leave the inventory (for the counter's
       ``withdrawn``).  If the op fails on whole values too, the step is
       at fault and the first error is raised; an ``InventoryError`` (a
       collective the counter cannot record) is never retried.
       ``replicated`` counts these ops by name.
    2. An op whose result ``DTensor`` lays out in a way no ``P`` can say
       (a ``_StridedShard``: see ``_plain``; torch 2.11 refuses such a
       view, and rule 1 takes it) has that result gathered over those
       mesh dims only
       (counted).  On a 3-d mesh torch 2.13 takes minutes to plan each op
       on a ``_StridedShard``; the reference's program never holds such a
       layout.  ``gathered`` counts these ops by name.

    A cell with either is not a partitioner's plan (``launch.dryrun``
    marks it so).  An in-place op's sources are first laid out as its
    buffer (a partial sum reduced into the buffer's shards), as a
    partitioner writes an update in the layout of the buffer it updates;
    its buffer must keep its placements.  A view that runs on whole values
    returns a copy, no view: the steps traced never write through such a
    view."""

    def __init__(self, counter: CollectiveCounter):
        super().__init__()
        self.counter = counter
        self.replicated: Dict[str, int] = {}
        self.gathered: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if not any(t is DTensor for t in types):
            return func(*args, **kwargs)
        schema = func._schema.arguments
        in_place = (bool(schema) and schema[0].alias_info is not None
                    and schema[0].alias_info.is_write
                    and isinstance(args[0], DTensor))
        if in_place:
            args, kwargs = _laid_out_as(args[0], args, kwargs)
            before = args[0].placements
        mark = self.counter.mark()
        try:
            out = func(*args, **kwargs)
        except Exception as error:  # noqa: BLE001 (judged by the retry)
            _raise_inventory_error(error)
            self.counter.rewind(mark)
            try:
                out = _on_whole_values(func, args, kwargs, in_place)
            except Exception as again:  # noqa: BLE001
                _raise_inventory_error(again)
                raise error
            return _count(self.replicated, func, out)
        if in_place:
            if args[0].placements != before:
                raise RuntimeError(f"{func}: the buffer's placements changed "
                                   f"from {before} to {args[0].placements}")
        elif not _expressible(out):
            return _count(self.gathered, func, _expressed(out))
        return out


def _raise_inventory_error(error: BaseException) -> None:
    """Raise the ``InventoryError`` behind ``error`` (``DTensor`` may wrap
    it), if there is one."""
    seen = set()
    while error is not None and id(error) not in seen:
        if isinstance(error, InventoryError):
            raise error
        seen.add(id(error))
        error = error.__cause__ or error.__context__


def _count(table: Dict[str, int], func, out):
    name = func._schema.name
    table[name] = table.get(name, 0) + 1
    return out


def _plain(p) -> bool:
    """Whether a ``P`` can say the placement ``p`` of one mesh dim:
    ``Shard``, ``Replicate`` or a partial sum.  Not ``DTensor``'s
    ``_StridedShard``: a view put a sharded dim under an outer factor of
    the dim it made, so each shard holds a strided set of its indices."""
    from torch.distributed.tensor import Replicate, Shard

    return type(p) in (Shard, Replicate) or p.is_partial()


def _expressible(out) -> bool:
    """Whether every ``DTensor`` in ``out`` has ``_plain`` placements."""
    from torch.distributed.tensor import DTensor

    if isinstance(out, (list, tuple)):
        return all(_expressible(o) for o in out)
    return not isinstance(out, DTensor) or all(map(_plain, out.placements))


def _expressed(out):
    """``out`` with each ``DTensor`` gathered over the mesh dims whose
    placement is not ``_plain``."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(out, (list, tuple)):
        return type(out)(_expressed(o) for o in out)
    if not isinstance(out, DTensor):
        return out
    return out.redistribute(out.device_mesh, [
        p if _plain(p) else Replicate() for p in out.placements])


def _laid_out_as(buf, args, kwargs):
    """An in-place op's arguments with each ``DTensor`` source of the
    buffer's rank laid out as ``buf``, any other partial source reduced."""
    from torch.distributed.tensor import DTensor, Replicate

    def laid_out(a):
        if not isinstance(a, DTensor) or a is buf:
            return a
        if a.ndim == buf.ndim:
            target = list(buf.placements)
        elif any(p.is_partial() for p in a.placements):
            target = [Replicate() if p.is_partial() else p
                      for p in a.placements]
        else:
            return a
        return a.redistribute(a.device_mesh, target)

    return ([laid_out(a) for a in args],
            {k: laid_out(v) for k, v in kwargs.items()})


def _on_whole_values(func, args, kwargs, in_place: bool):
    """``func`` on the whole values of its ``DTensor`` arguments (see
    ``_NoPlan``)."""
    from torch.distributed.tensor import DTensor, Replicate

    meshes = []

    def whole(a):
        if isinstance(a, (list, tuple)):
            return type(a)(whole(b) for b in a)
        if not isinstance(a, DTensor):
            return a
        meshes.append(a.device_mesh)
        return a.redistribute(a.device_mesh,
                              [Replicate()] * a.device_mesh.ndim).to_local()

    wargs = [whole(a) for a in args]
    out = func(*wargs, **{k: whole(v) for k, v in kwargs.items()})
    dm = meshes[0]
    everywhere = [Replicate()] * dm.ndim
    if in_place:
        buf = args[0]
        piece = DTensor.from_local(wargs[0], dm, everywhere, run_check=False)
        buf.to_local().copy_(
            piece.redistribute(dm, buf.placements).to_local())
        return None if out is None else buf

    def wrap(t):
        if isinstance(t, (list, tuple)):
            return type(t)(wrap(u) for u in t)
        if not isinstance(t, torch.Tensor):
            return t
        return DTensor.from_local(t, dm, everywhere, run_check=False)

    return wrap(out)


def count_collectives(fn, args, mesh, exclude=(), disable=()):
    """``fn(*args)`` once on ``DTensor`` arguments under the mesh rules
    (``sharding.ctx.use_mesh_rules(mesh, exclude, disable)``), with
    ``implicit_replication`` (a plain tensor that meets a ``DTensor`` -- a
    constant, a mask, a fresh buffer -- counts as replicated), a
    ``CollectiveCounter`` and, above it, ``_NoPlan``: ``(fn's result,
    the counter)``; the counter's ``replicated`` names the ops that ran on
    whole values, its ``gathered`` those whose result was gathered where
    no ``P`` could say its layout."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.sharding.ctx import use_mesh_rules

    counter = CollectiveCounter()
    policy = _NoPlan(counter)
    with use_mesh_rules(mesh, exclude, disable), implicit_replication(), \
            counter, policy:
        out = fn(*args)
    counter.replicated = policy.replicated
    counter.gathered = policy.gathered
    return out, counter

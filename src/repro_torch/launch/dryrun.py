"""Multi-pod dry run on the ``meta`` device: every (arch x shape x mesh) cell.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell for 512 forced host devices and reads XLA's memory and cost analyses;
the port has no partitioner, so for each cell it:

  1. builds the production mesh on ``meta`` (16 x 16 single pod, 2 x 16 x 16
     multi-pod: 256 or 512 shard devices that hold nothing);
  2. assembles the abstract inputs (``launch.specs.input_specs``: ``meta``
     tensors from the real constructors) and their shardings, from which
     the arguments' and outputs' bytes per device are exact;
  3. under ``sharding.use_mesh_rules`` traces the cell's step (the train
     step with the reference's accumulation and remat, the compressed step
     under ``--grad-compress``, ``prefill`` or ``decode_step``) on ``meta``
     tensors at one batch shard -- the global batch divided over the axes
     the batch rule resolves to, every width full -- inside
     ``FlopCounterMode`` and a dispatch mode that tracks the high-water mark
     of live tensor bytes;
  4. for a serving cell (prefill, decode), traces the step once more for
     its collective inventory (``utils.collectives``, the counterpart of
     the reference's ``utils/hlo`` parser): at the global shapes, its
     parameters, inputs and decode state ``DTensor``s on ``meta`` laid out
     by the same specs, inside a fake process group of the mesh's size
     (``fake_world``), under the mesh rules, where ``constrain``
     redistributes as the reference's sharding constraints do;
  5. costs the cell with the analytic model (``utils.flopcount``, the
     reference's numbers) and the card's roofline (``utils.roofline``),
     the wire bytes included.

What the fields hold:
  * ``memory.argument_bytes_per_dev`` / ``output_bytes_per_dev``: exact, from
    the specs' shard shapes (outputs: the state's shardings, the logits as
    ``("batch", "seq", "vocab")``, the train metrics as 4 f32 scalars);
  * ``temp_bytes_per_dev``: the trace's high-water mark of live bytes
    beyond the arguments, less the outputs made anew (as XLA's temp, which
    holds no output).  The trace is one batch shard at full width, so
    wherever the model axis would split activations this is an upper
    bound;
  * ``alias_bytes_per_dev``: the caches ``decode_step`` updates in place,
    or the whole train state, which the caller drops for the new one (the
    reference donates it); ``peak_bytes_per_dev`` = arguments + outputs +
    temp - alias, as in the reference;
  * ``cost.flops_per_dev`` / ``hbm_bytes_per_dev``: the analytic model;
    ``cost.torch_flops_per_dev_raw``: ``FlopCounterMode``'s count of the
    trace (forward, backward and, under remat, the recomputed forward of
    every superblock) divided by the model axis' size (and by the pods the
    compressed step runs in turn) -- in place of the reference's
    ``xla_*_raw``, which are ``null``;
  * ``constraints``: how many ``constrain`` calls the trace resolved at
    each site's logical names (one batch shard, so the specs themselves
    are not kept: a batch dim resolves differently at the global shape);
  * ``collectives``: per op (the reference's names), ``count`` and
    ``weighted_result_bytes``, from the second trace; it runs every loop
    iteration, so no trip-count multiplier is needed, and it allocates
    nothing.  ``cost.wire_bytes_per_dev`` is ``collective_wire_bytes`` of
    it, and ``roofline.collective_s`` those bytes over NVLink.  A train
    cell (with or without ``--grad-compress``) keeps ``null`` in these
    three: the training loss's backward does not trace on ``DTensor``s yet
    (``models/transformer.py``'s ``chunked_xent`` gathers the target logit
    from vocab-sharded logits).  ``xla_*_raw`` stay ``null``: there is no
    XLA and no compiled program to read;
  * ``inventory_replicated``: the ops ``DTensor`` could not run on their
    inputs' placements, which the inventory ran on whole values (their
    inputs gathered, counted), and ``inventory_gathered`` the ops whose
    result ``DTensor`` laid out in a way no ``P`` can say, gathered over
    those mesh dims (counted), by op (``utils.collectives._NoPlan``);
  * ``inventory_caveats``: why the inventory is not a partitioner's plan,
    empty where it is: the two above, and an MoE cell's groups run one by
    one (ROADMAP C25);
  * ``torch_version``: the torch that traced the cell.  The inventory is
    ``DTensor``'s plan, and ``DTensor``'s rules change between releases:
    compare inventories of one version only;
  * ``compile_seconds``: the first trace's seconds; ``inventory_seconds``
    the second's (``null`` where there is none).

The dry run allocates nothing on any device: a tensor of more than one
element made anywhere but ``meta`` during the trace fails the cell.  Any
spec that does not divide its dim, or a trace that raises (the inventory's
included: a collective it cannot name, a layout ``DTensor`` cannot hold),
fails the cell; no field is quietly left ``null``.  The inventory needs
no card: ``--mesh multipod`` runs it on the CPU.

Usage (from the repository root, ``PYTHONPATH=src``):
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --mesh multipod
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import threading
import time
import traceback
import weakref
from collections import Counter
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["Cell", "build_cell", "measure_cell", "run_cell", "iter_cells",
           "main"]

_METRICS = ("loss", "grad_norm", "xent", "aux")  # the train step's scalars


class _LiveBytes(TorchDispatchMode):
    """The high-water mark of the bytes of the storages that ops make under
    it while they live (views share their base's storage; storages of
    ``known`` tensors, the arguments, never count).  A tensor of more than
    one element made on a device other than ``device`` is recorded in
    ``foreign``."""

    def __init__(self, known, device: torch.device):
        super().__init__()
        self.device = device
        self.live = self.peak = 0
        self.foreign = []
        self._seen = {t.untyped_storage()._cdata for t in known}
        self._lock = threading.Lock()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(func, t)
        return out

    def _track(self, func, t):
        if t.device.type != self.device.type and t.numel() > 1:
            self.foreign.append(f"{func} on {t.device}")
        st = t.untyped_storage()
        key, n = st._cdata, st.nbytes()
        with self._lock:
            if key in self._seen:
                return
            self._seen.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n):
        with self._lock:
            self._seen.discard(key)
            self.live -= n


def _tensors(tree):
    """The tensors of a state, batch or model (parameters), in order."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _layout_bytes(shardings, leaves: Dict[str, torch.Tensor]) -> int:
    """Bytes per device of ``leaves`` laid out by ``shardings`` (both by
    name): each leaf's shard shape times its element size."""
    return sum(int(np.prod(shardings[k].shard_shape(tuple(t.shape)),
                           dtype=np.int64)) * t.element_size()
               for k, t in leaves.items())


@dataclasses.dataclass
class Cell:
    """One cell ready to trace: ``fn(*args)`` is the step at one batch
    shard on ``device``; the bytes are per device of the global cell."""

    cfg: Any
    shape_name: str
    mesh: Any
    kind: str
    device: torch.device
    fn: Callable
    args: Tuple
    rules: Dict[str, tuple]          # use_mesh_rules' exclude / disable
    local_batch: int
    shards_traced: int               # batch shards the trace runs in turn
    argument_bytes: int
    output_bytes: int
    alias: Callable                  # (args, out) -> alias bytes per device
    accum_steps: int = 1
    grad_compress: bool = False
    # (DeviceMesh) -> the step's arguments at the global shapes as DTensors
    # on ``meta`` (the collective inventory); None for a train cell
    dtensor_args: Optional[Callable] = None

    def tensors(self):
        """The tensors of the trace's arguments (a model's parameters)."""
        return _tensors(self.args)


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, np.asarray(mesh.devices).shape))


def _local(tree, b_local: int, device, gen, vocab: int):
    """``tree``'s batch-major tensors at ``b_local`` rows on ``device``: an
    abstract batch on ``meta``, random tokens below ``vocab`` and normal
    embeddings from ``gen`` elsewhere."""
    def one(t):
        shape = (b_local,) + tuple(t.shape[1:])
        if device.type == "meta":
            return torch.empty(shape, dtype=t.dtype, device=device)
        if t.dtype == torch.int32:
            return torch.randint(0, vocab, shape, generator=gen,
                                 dtype=torch.int32, device=device)
        return torch.randn(shape, generator=gen, device=device).to(t.dtype)

    if isinstance(tree, dict):
        return {k: one(v) for k, v in tree.items()}
    return one(tree)


def build_cell(cfg, shape_name: str, mesh, *, device="meta",
               grad_compress: bool = False,
               accum_steps: Optional[int] = None,
               no_sp: bool = False) -> Cell:
    """The cell of ``cfg`` x ``shape_name`` on ``mesh``, its trace's inputs
    on ``device``: ``meta`` for the dry run, or a real device, where the
    parameters come from seed 0 and the states start at zero (the token
    ids are drawn below the vocab's size)."""
    from repro_torch import resolve_device
    from repro_torch.ckpt.checkpoint import named_leaves
    from repro_torch.configs import SHAPES
    from repro_torch.launch import specs
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models.params import param_shapes
    from repro_torch.sharding.layout import NamedSharding
    from repro_torch.sharding.partition import P, logical_to_spec
    from repro_torch.train.steps import (init_error_fb, init_train_state,
                                         make_compressed_train_step,
                                         make_train_step)
    from repro_torch.utils.collectives import distribute_params, to_dtensor

    dev = resolve_device(device)
    shape = SHAPES[shape_name]
    spec = specs.input_specs(cfg, shape_name)
    oc = spec["opt_config"]
    exclude = ("pod",) if grad_compress else ()
    rules = {"exclude": exclude,
             "disable": ("seq_block",) if no_sp else ()}
    sizes = _sizes(mesh)
    # one batch shard: the global batch over the axes its rule resolves to
    (axes,) = logical_to_spec(("batch",), (shape.global_batch,), mesh,
                              exclude=exclude)
    axes = (axes,) if isinstance(axes, str) else axes or ()
    b_local = shape.global_batch // int(np.prod([sizes[a] for a in axes],
                                                dtype=np.int64))
    gen = None if dev.type == "meta" else torch.Generator(dev).manual_seed(0)
    in_sh = spec["shardings"](mesh)

    def params_on_device():
        if dev.type == "meta":
            return param_shapes(cfg)
        return init_params(gen, cfg, device=dev)

    if spec["kind"] == "train":
        state_abs, batch_abs = spec["args"]
        accum = (accum_steps if accum_steps is not None
                 else spec["accum_steps"])
        shards = 1
        if grad_compress:
            state_abs = dict(state_abs,
                             error_fb=init_error_fb(state_abs["params"]))
            in_sh = (specs.state_shardings(state_abs, mesh), in_sh[1])
            fn = make_compressed_train_step(cfg, oc, mesh)
            shards = sizes.get("pod", 1)
        else:
            fn = make_train_step(cfg, oc, accum_steps=accum)
        state = state_abs
        if dev.type != "meta":
            state = init_train_state(gen, cfg, oc, device=dev)
            if grad_compress:
                state["error_fb"] = init_error_fb(state["params"])
        batch = _local(batch_abs, b_local, dev, gen, cfg.vocab)
        state_leaves = dict(named_leaves(state_abs))
        arg_b = (_layout_bytes(in_sh[0], state_leaves)
                 + _layout_bytes(in_sh[1], batch_abs))
        out_b = _layout_bytes(in_sh[0], state_leaves) + 4 * len(_METRICS)
        alias_b = _layout_bytes(in_sh[0], state_leaves)
        return Cell(cfg, shape_name, mesh, "train", dev, fn, (state, batch),
                    rules, b_local,
                    shards, arg_b, out_b, lambda args, out: alias_b,
                    accum_steps=accum, grad_compress=grad_compress)

    params_abs = param_shapes(cfg)
    p_sh = specs.state_shardings({"params": params_abs}, mesh)
    param_b = _layout_bytes(p_sh, dict(named_leaves({"params": params_abs})))
    logits_abs = torch.empty((shape.global_batch, 1, cfg.vocab),
                             dtype=torch.float32, device="meta")
    logits_spec = logical_to_spec(("batch", "seq", "vocab"),
                                  tuple(logits_abs.shape), mesh)
    logits_b = _layout_bytes({"l": NamedSharding(mesh, logits_spec)},
                             {"l": logits_abs})

    if spec["kind"] == "prefill":
        tokens_abs, extras_abs = spec["args"]
        s_total = shape.seq_len + (cfg.num_prefix_embeds
                                   if cfg.frontend == "patches" else 0)
        out_state = specs.abstract_decode_state(cfg, shape.global_batch,
                                                s_total)
        out_b = logits_b + _layout_bytes(
            specs.decode_state_specs(out_state, mesh),
            specs.decode_state_leaves(out_state))
        arg_b = (param_b + _layout_bytes({"t": in_sh[0]}, {"t": tokens_abs})
                 + _layout_bytes(in_sh[1], extras_abs))
        tokens = _local(tokens_abs, b_local, dev, gen, cfg.vocab)

        def prefill_fn(params, tokens, extras):
            with torch.no_grad():
                return prefill(params, cfg, tokens,
                               prefix_embeds=extras.get("prefix_embeds"),
                               enc_frames=extras.get("enc_frames"))

        def dtensor_args(dm):
            return (distribute_params(params_abs, dm, mesh),
                    to_dtensor(tokens_abs, dm, in_sh[0].spec),
                    {k: to_dtensor(v, dm, in_sh[1][k].spec)
                     for k, v in extras_abs.items()})

        return Cell(cfg, shape_name, mesh, "prefill", dev, prefill_fn,
                    (params_on_device(), tokens,
                     _local(extras_abs, b_local, dev, gen, cfg.vocab)),
                    rules, b_local, 1,
                    arg_b, out_b, lambda args, out: 0,
                    dtensor_args=dtensor_args)

    state_abs, token_abs = spec["args"]
    state_sh, state_leaves = in_sh[0], specs.decode_state_leaves(state_abs)
    state_b = _layout_bytes(state_sh, state_leaves)
    arg_b = param_b + state_b + _layout_bytes({"t": in_sh[1]},
                                              {"t": token_abs})
    state = specs.abstract_decode_state(cfg, b_local, shape.seq_len)
    if dev.type != "meta":
        from repro_torch.models import init_decode_state

        state = init_decode_state(cfg, b_local, shape.seq_len, device=dev)
    token = _local(token_abs, b_local, dev, gen, cfg.vocab)

    def decode_fn(params, state, token):
        with torch.no_grad():
            return decode_step(params, cfg, state, token)

    def in_place(args, out):
        """Per-device bytes of the leaves every piece of which the step
        updated in place (the same tensor in and out)."""
        before = specs.decode_state_groups(args[1])
        after = specs.decode_state_groups(out[1])
        kept = {k for k, ts in before.items()
                if all(a is b for a, b in zip(ts, after[k]))}
        return _layout_bytes({k: state_sh[k] for k in kept},
                             {k: state_leaves[k] for k in kept})

    def dtensor_args(dm):
        def leaf(name, t, block):
            # a superblock's piece of a stacked leaf: the spec less its
            # stacked dim.  Where the rules shard that dim (a stacked sLSTM
            # ``c`` takes the mLSTM's rank-4 rule, so "batch" lands on the
            # stack when the data axis divides n_blocks: ROADMAP C26, no
            # production cell), each piece is whole over those axes
            spec = state_sh[name].spec
            return to_dtensor(t, dm, spec if block is None else P(*spec[1:]))

        return (distribute_params(params_abs, dm, mesh),
                specs.map_decode_state(state_abs, leaf),
                to_dtensor(token_abs, dm, in_sh[1].spec))

    return Cell(cfg, shape_name, mesh, "decode", dev, decode_fn,
                (params_on_device(), state, token),
                rules, b_local, 1,
                arg_b, logits_b + state_b, in_place,
                dtensor_args=dtensor_args)


def collective_inventory(cell: Cell, device_type: str = "cuda"):
    """The ``utils.collectives.CollectiveCounter`` of ``cell``'s step on
    its mesh (``None`` for a train cell): the step at the global shapes,
    its parameters, inputs and decode state ``DTensor``s on ``meta`` laid
    out by the dry run's specs, run once inside ``fake_world(cell.mesh)``
    under the mesh rules.  ``.records`` are the collectives,
    ``.replicated`` the ops run on whole values, ``.gathered`` those whose
    result was gathered where no ``P`` says its layout.  A mesh of one
    device issues no collective: its inventory is empty, and nothing is
    traced."""
    from repro_torch.utils.collectives import (CollectiveCounter,
                                               count_collectives, fake_world)

    if cell.dtensor_args is None:
        return None
    if np.asarray(cell.mesh.devices).size == 1:
        return CollectiveCounter()
    with fake_world(cell.mesh, device_type) as dm:
        return count_collectives(cell.fn, cell.dtensor_args(dm), cell.mesh,
                                 **cell.rules)[1]


def measure_cell(cell: Cell) -> Dict[str, Any]:
    """Trace ``cell`` once under its mesh's rules, then (a serving cell)
    once more for its collectives; the result record."""
    from repro_torch.models import count_params
    from repro_torch.sharding.ctx import recording, use_mesh_rules
    from repro_torch.utils.collectives import collective_wire_bytes, per_op
    from repro_torch.utils.flopcount import analytic_cell
    from repro_torch.utils.roofline import roofline_terms

    cfg, mesh = cell.cfg, cell.mesh
    t0 = time.perf_counter()
    live = _LiveBytes(cell.tensors(), cell.device)
    with use_mesh_rules(mesh, **cell.rules), recording() as sites:
        with FlopCounterMode(display=False) as flops, live:
            out = cell.fn(*cell.args)
        if cell.device.type == "cuda":
            torch.cuda.synchronize(cell.device)
    seconds = time.perf_counter() - t0
    if live.foreign:
        raise RuntimeError(f"the trace on {cell.device} made tensors "
                           f"elsewhere: {sorted(set(live.foreign))[:5]}")
    alias = cell.alias(cell.args, out)
    known = {t.untyped_storage()._cdata for t in cell.tensors()}
    made = {st._cdata: st.nbytes() for st in (
        t.untyped_storage() for t in _tensors(out)) if st._cdata not in known}
    del out

    t1 = time.perf_counter()
    counter = collective_inventory(cell)
    inventory_seconds = time.perf_counter() - t1
    colls = None if counter is None else counter.records
    wire = None if colls is None else collective_wire_bytes(colls)
    caveats = None
    if counter is not None:
        caveats = [f"run on whole values: {op} x {n}"
                   for op, n in sorted(counter.replicated.items())]
        caveats += [f"result gathered where no P says its layout: {op} x {n}"
                    for op, n in sorted(counter.gathered.items())]
        if cfg.n_experts and cell.kind == "prefill":
            caveats.append("C25: the MoE groups run one by one, each "
                           "group's slice and combine buffer gathered")

    n_chips = int(np.asarray(mesh.devices).size)
    model_shards = _sizes(mesh).get("model", 1)
    ana = analytic_cell(cfg, cell.shape_name, n_chips, model_shards)
    terms = roofline_terms(ana["flops_per_dev"], ana["hbm_bytes_per_dev"],
                           wire)
    model_flops = ana["model_flops"]
    temp = live.peak - sum(made.values())
    return {
        "shape": cell.shape_name,
        "kind": cell.kind,
        "grad_compress": cell.grad_compress,
        "seq_parallel": "seq_block" not in cell.rules["disable"],
        "n_chips": n_chips,
        "n_params": count_params(cfg),
        "n_active_params": count_params(cfg, active_only=True),
        "batch_per_shard": cell.local_batch,
        "accum_steps": cell.accum_steps,
        "device": str(cell.device),
        "compile_seconds": round(seconds, 1),
        "inventory_seconds": (None if colls is None
                              else round(inventory_seconds, 1)),
        "memory": {
            "argument_bytes_per_dev": cell.argument_bytes,
            "output_bytes_per_dev": cell.output_bytes,
            "temp_bytes_per_dev": temp,
            "alias_bytes_per_dev": alias,
            "peak_bytes_per_dev": (cell.argument_bytes + cell.output_bytes
                                   + temp - alias),
        },
        "cost": {
            "flops_per_dev": ana["flops_per_dev"],
            "hbm_bytes_per_dev": ana["hbm_bytes_per_dev"],
            "wire_bytes_per_dev": wire,
            "torch_flops_per_dev_raw": (flops.get_total_flops()
                                        / (model_shards * cell.shards_traced)),
            "xla_flops_per_dev_raw": None,
            "xla_bytes_per_dev_raw": None,
        },
        "constraints": dict(sorted(Counter(
            " ".join(str(n) for n in site[0]) for site in sites).items())),
        "collectives": None if colls is None else per_op(colls),
        "inventory_replicated": (
            None if counter is None else dict(sorted(
                counter.replicated.items()))),
        "inventory_gathered": (
            None if counter is None else dict(sorted(
                counter.gathered.items()))),
        "inventory_caveats": caveats,
        "torch_version": torch.__version__,
        "roofline": terms,
        "model_flops": model_flops,
        "useful_flops_ratio": (
            model_flops / (ana["flops_per_dev"] * n_chips)
            if ana["flops_per_dev"] else None
        ),
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             grad_compress: bool = False, accum_steps: int | None = None,
             no_sp: bool = False, kv_int8: bool = False) -> dict:
    """One cell of the dry run on the production mesh on ``meta``."""
    from repro_torch.configs import get_config, shapes_for
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    if shape_name not in shapes_for(cfg):
        raise ValueError(f"{arch} skips {shape_name}: {cfg.long_ctx_note}")
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"),
                                device="meta")
    cell = build_cell(cfg, shape_name, mesh, device="meta",
                      grad_compress=grad_compress, accum_steps=accum_steps,
                      no_sp=no_sp)
    return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
            **measure_cell(cell)}


def iter_cells(mesh_kind: str):
    from repro_torch.configs import ARCHS, shapes_for

    for arch, cfg in ARCHS.items():
        for shape in shapes_for(cfg):
            yield arch, shape, mesh_kind


def _ms(seconds) -> str:
    return "n/a" if seconds is None else f"{seconds * 1e3:.2f}ms"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["pod", "multipod"], default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--accum", type=int, default=None,
                    help="override gradient-accumulation steps (train cells)")
    ap.add_argument("--no-sp", action="store_true",
                    help="disable sequence-parallel block boundaries")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8-quantized KV caches (decode cells)")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--tag", default="", help="suffix for output filenames")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        cells = list(iter_cells(args.mesh))
    elif args.arch and not args.shape:
        from repro_torch.configs import get_config, shapes_for

        cells = [(args.arch, s, args.mesh)
                 for s in shapes_for(get_config(args.arch))]
    else:
        cells = [(args.arch, args.shape, args.mesh)]
    failures = 0
    for arch, shape, mesh_kind in cells:
        tag = (f"{arch}_{shape}_{mesh_kind}"
               + ("_i8" if args.grad_compress else "")
               + (f"_{args.tag}" if args.tag else ""))
        try:
            res = run_cell(arch, shape, mesh_kind,
                           grad_compress=args.grad_compress,
                           accum_steps=args.accum, no_sp=args.no_sp,
                           kv_int8=args.kv_int8)
            (out_dir / f"{tag}.json").write_text(json.dumps(res, indent=2))
            m, r = res["memory"], res["roofline"]
            caveats = "; ".join(res["inventory_caveats"] or ())
            print(
                f"OK   {tag}: peak/dev={m['peak_bytes_per_dev']/2**30:.2f}GiB "
                f"compute={_ms(r['compute_s'])} memory={_ms(r['memory_s'])} "
                f"collective={_ms(r['collective_s'])} "
                f"dominant={r['dominant']} "
                f"(traced in {res['compile_seconds']}s)"
                + (f"; inventory not a plan: {caveats}" if caveats else ""),
                flush=True)
        except Exception as e:  # noqa: BLE001 -- report and continue the sweep
            failures += 1
            (out_dir / f"{tag}.FAILED.txt").write_text(traceback.format_exc())
            print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()

"""``repro_torch.utils.collectives``: the collective inventory of a sharded
program, against ``repro.utils.hlo``.

* ``collective_wire_bytes`` equals the reference's bit for bit, on the
  inventory the reference's parser reads from its own test's HLO text and on
  random inventories;
* five primitive programs on a (2, 2) mesh: the reference compiled on 4
  forced host devices in a child process (``_torch_collectives_ref.py``),
  the port as ``DTensor``s on a fake world of 4.  Three are equal in op,
  bytes, group and count; the other two are pinned on both sides (ROADMAP
  C21, C22, and the reference's group of 1 for a collective-permute, C23);
* the inventory's policy where ``DTensor`` has no plan a ``P`` can say
  (``_NoPlan``): an op without a rule, in place or not, runs on whole
  values; a ``_StridedShard`` result is gathered over its mesh dim; an op
  that fails on whole values too raises its own error;
* a dense and an MoE reduced prefill cell (``CELL_SHAPE``) on both sides,
  pinned per op (C24, C25; the port's side per torch release); a
  difference without a Queue C entry fails;
* ``CollectiveCounter`` and ``CommDebugMode`` agree key for key on a small
  prefill and decode cell of every reduced config;
* the sharded program computes the model: reduced codeqwen and olmoe
  prefill in f32 on 4 gloo processes over loopback, the gathered logits
  within ``GLOO_REL x max(max|logits|, 1)`` of the unsharded port (the sums
  over shards add in another order), each rank's counter equal to the fake
  world's records;
* ``placements`` against ``sharding.layout.NamedSharding`` for every spec
  the rules produce, ``constrain`` on a plain tensor, and no process group
  left behind by a cell that passed or raised.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_collectives_ref as ref_side
from _hypothesis_compat import given, settings, st
from repro.utils import hlo as ref_hlo
from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.sharding.partition import P
from repro_torch.utils import collectives as coll

REPO = Path(__file__).resolve().parents[1]
GLOO_REL = 1e-5
OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute")

# tests/test_system.py's HLO text: an all-reduce in a 9-trip while body and
# an all-gather in the entry
HLO = """
HloModule test
%body.1 (p: (s32[], f32[64])) -> (s32[], f32[64]) {
  %ar = f32[64]{0} all-reduce(%x), replica_groups=[2,4]<=[8], to_apply=%sum
  ROOT %t = tuple(%i, %ar)
}
%cond.1 (p: (s32[], f32[64])) -> pred[] {
  %c = s32[] constant(9)
  ROOT %cmp = pred[] compare(%i, %c), direction=LT
}
ENTRY %main (a: f32[64]) -> f32[64] {
  %ag = f32[128]{0} all-gather(%a), replica_groups=[4,2]<=[8], dimensions={0}
  %w = (s32[], f32[64]) while(%init), condition=%cond.1, body=%body.1
  ROOT %done = f32[64] get-tuple-element(%w), index=1
}
"""

# the primitive programs whose inventories the two sides share
EXACT = ("row_to_replicated", "shard_to_replicate", "column_row_mlp")
# the others, both sides pinned: (reference's records, port's records)
PINNED = {
    # C21: the reference all-reduces, then moves the half it keeps
    "row_to_sharded": (
        [{"op": "all-reduce", "result_bytes": 1024, "group": 2,
          "count": 1.0},
         {"op": "collective-permute", "result_bytes": 1024, "group": 1,
          "count": 1.0}],
        [{"op": "reduce-scatter", "result_bytes": 1024, "group": 2,
          "count": 1}]),
    # C22: the reference permutes the pieces; DTensor gathers over one axis
    # and moves the other with an all-to-all
    "transpose_layout": (
        [{"op": "collective-permute", "result_bytes": 2048, "group": 1,
          "count": 1.0}],
        [{"op": "all-gather", "result_bytes": 4096, "group": 2, "count": 1},
         {"op": "all-to-all", "result_bytes": 4096, "group": 2,
          "count": 1}]),
}
# per-op totals of the two prefill cells: {op: (count, weighted bytes)}.
# The port's side is DTensor's plan, and DTensor's rules change between
# torch releases: its totals, and the ops the inventory ran on whole values
# and gathered (``utils.collectives._NoPlan``), are pinned per torch release
# (major.minor); a release without pins fails
CELL_TOTALS = {
    "codeqwen1.5-7b": {
        "queue_c": "C24",
        "ref": {"all-gather": (37.0, 428928.0), "all-reduce": (6.0, 27136.0),
                "all-to-all": (3.0, 36864.0),
                "collective-permute": (2.0, 4608.0)},
        "port": {
            "2.13": ({"all-gather": (31.0, 385152.0),
                      "all-to-all": (2.0, 4608.0),
                      "reduce-scatter": (5.0, 17408.0)},
                     {}, {"aten::view": 8, "aten::_unsafe_view": 6}),
            "2.11": ({"all-gather": (31.0, 598016.0),
                      "all-reduce": (14.0, 294912.0),
                      "reduce-scatter": (5.0, 17408.0),
                      "all-to-all": (5.0, 16896.0)},
                     {"aten::view": 8, "aten::_unsafe_view": 6,
                      "aten::constant_pad_nd": 4}, {}),
        },
    },
    "olmoe-1b-7b": {
        "queue_c": "C25",
        "ref": {"all-gather": (29.0, 267648.0), "all-reduce": (12.0, 125440.0),
                "collective-permute": (6.0, 86528.0),
                "all-to-all": (1.0, 4096.0)},
        "port": {
            "2.13": ({"all-gather": (35.0, 394368.0),
                      "all-to-all": (2.0, 4608.0),
                      "reduce-scatter": (5.0, 17408.0),
                      "all-reduce": (8.0, 122944.0)},
                     {}, {"aten::view": 8, "aten::_unsafe_view": 6}),
            "2.11": ({"all-gather": (31.0, 630784.0),
                      "all-reduce": (12.0, 204800.0),
                      "reduce-scatter": (5.0, 17408.0),
                      "all-to-all": (3.0, 8704.0)},
                     {"aten::view": 8, "aten::_unsafe_view": 6,
                      "aten::index_put_": 2, "aten::constant_pad_nd": 4},
                     {}),
        },
    },
}
TORCH = ".".join(torch.__version__.split(".")[:2])


def _totals(colls):
    return {op: (v["count"], v["weighted_result_bytes"])
            for op, v in coll.per_op(colls).items()}


@pytest.fixture(scope="module")
def reference():
    """The reference's inventories, from a child with its own
    ``XLA_FLAGS``."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, str(REPO / "tests" / "_torch_collectives_ref.py")],
        capture_output=True, text=True, env=env, cwd=str(REPO), timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("REF "))
    return json.loads(line[len("REF "):])


@pytest.fixture()
def small_shapes(monkeypatch):
    """``CELL_SHAPE`` as a prefill and a decode shape of the port's table."""
    name, seq, batch = ref_side.CELL_SHAPE
    monkeypatch.setitem(SHAPES, name, ShapeSpec(name, seq, batch, "prefill"))
    monkeypatch.setitem(SHAPES, "decode_cell",
                        ShapeSpec("decode_cell", seq, batch, "decode"))
    return name, "decode_cell"


def _mesh22():
    return make_test_mesh((2, 2), device="meta")


# ---------------------------------------------------------------------------
# wire bytes
# ---------------------------------------------------------------------------

def test_wire_bytes_reference_example():
    colls = ref_hlo.parse_collectives(HLO)
    got = coll.collective_wire_bytes(colls)
    assert got == ref_hlo.collective_wire_bytes(colls)
    assert got == 9 * 2 * 256 * 0.75 + 512 * 0.5


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 10 ** 9), min_size=0, max_size=12),
       st.integers(0, 2 ** 31))
def test_wire_bytes_random(sizes, seed):
    rng = np.random.default_rng(seed)
    colls = [{"op": OPS[int(rng.integers(len(OPS)))], "result_bytes": r,
              "group": int(rng.choice([0, 1, 2, 3, 4, 16, 32, 512])),
              "count": float(rng.integers(1, 100))
              if rng.random() < 0.5 else int(rng.integers(1, 100))}
             for r in sizes]
    assert coll.collective_wire_bytes(colls) == \
        ref_hlo.collective_wire_bytes(colls)
    assert coll.per_op(colls).keys() <= set(OPS)


# ---------------------------------------------------------------------------
# primitive programs against the reference
# ---------------------------------------------------------------------------

def _port_program(name, device_type="cuda"):
    shapes, in_specs, out_spec = ref_side.PRIMITIVES[name]
    mesh = _mesh22()
    with coll.fake_world(mesh, device_type) as dm:
        args = [coll.to_dtensor(torch.empty(s, device="meta"), dm, P(*sp))
                for s, sp in zip(shapes, in_specs)]
        target = coll.placements(P(*out_spec), dm.mesh_dim_names)

        def fn(*a):
            if name.startswith("row_"):
                y = a[0] @ a[1]
            elif name == "column_row_mlp":
                y = torch.relu(a[0] @ a[1]) @ a[2]
            else:
                y = a[0] * 1.0
            return y.redistribute(dm, target)

        return coll.count_collectives(fn, args, mesh)[1].records


@pytest.mark.parametrize("name", EXACT)
def test_primitive_equals_reference(reference, name):
    assert _port_program(name) == reference[name]


@pytest.mark.parametrize("name", sorted(PINNED))
def test_primitive_divergence_pinned(reference, name):
    want_ref, want_port = PINNED[name]
    assert reference[name] == want_ref
    assert _port_program(name) == want_port
    # the wire bytes of both sides (ROADMAP C21-C22 give them)
    assert coll.collective_wire_bytes(want_ref) == 2048.0
    assert coll.collective_wire_bytes(want_port) == (
        1024.0 if name == "row_to_sharded" else 4096.0)


def test_cpu_world_gathers_for_all_to_all():
    """On a ``cpu`` mesh (gloo) DTensor gathers and chunks where the card's
    NCCL groups run an all-to-all; the other programs are the same."""
    assert _port_program("transpose_layout", "cpu") == [
        {"op": "all-gather", "result_bytes": 4096, "group": 2, "count": 1},
        {"op": "all-gather", "result_bytes": 8192, "group": 2, "count": 1}]
    assert _port_program("column_row_mlp", "cpu") == \
        _port_program("column_row_mlp")


# ---------------------------------------------------------------------------
# where DTensor has no plan a ``P`` can say: whole values, or a gather over
# the mesh dims no ``P`` says
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch_test::twice", mutates_args=())
def _twice(x: torch.Tensor) -> torch.Tensor:
    return x * 2


@_twice.register_fake
def _(x):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch_test::bump_", mutates_args=("buf",))
def _bump_(buf: torch.Tensor, src: torch.Tensor) -> None:
    buf.add_(src)


def _policy_run(fn, specs, shape=(8, 256), device="meta"):
    """``fn`` on DTensors of ``shape`` laid out by ``specs`` on a fake
    world of 4 (a ``cuda`` mesh of ``meta`` tensors, or a ``cpu`` one),
    ``(out, counter, the arguments' placements)``."""
    mesh = _mesh22()
    with coll.fake_world(mesh, "cuda" if device == "meta" else device) as dm:
        args = [coll.to_dtensor(torch.zeros(shape, device=device), dm,
                                P(*sp)) for sp in specs]
        out, counter = coll.count_collectives(fn, args, mesh)
        return out, counter, [a.placements for a in args]


def test_op_without_a_rule_runs_on_whole_values():
    """An op ``DTensor`` has no rule for (a custom op): its input gathered
    (counted), the op on the whole value, the result replicated."""
    from torch.distributed.tensor import Replicate

    out, counter, _ = _policy_run(
        lambda x: torch.ops.repro_torch_test.twice(x),
        [("data", "model")])
    assert counter.replicated == {"repro_torch_test::twice": 1}
    assert out.placements == (Replicate(), Replicate())
    assert tuple(out.shape) == (8, 256)
    # (8, 256) f32 gathered over model, then over data
    assert counter.records == [
        {"op": "all-gather", "result_bytes": 4096, "group": 2, "count": 1},
        {"op": "all-gather", "result_bytes": 8192, "group": 2, "count": 1}]


def test_in_place_op_without_a_rule_keeps_its_buffer_layout():
    """An in-place op ``DTensor`` has no rule for: the source laid out as
    the buffer, then both gathered; the buffer keeps its placements."""
    from torch.distributed.tensor import Shard

    out, counter, pls = _policy_run(
        lambda b, s: torch.ops.repro_torch_test.bump_(b, s),
        [(None, "model"), (None, None)])
    assert out is None and counter.replicated == {
        "repro_torch_test::bump_": 1}
    assert pls[0][1] == Shard(1)  # the buffer's placements, unchanged
    # the buffer and its source, each (8, 256) f32 gathered over model
    assert counter.records == [
        {"op": "all-gather", "result_bytes": 8192, "group": 2, "count": 2}]


def test_unexpressible_layout_is_gathered_where_no_spec_says_it():
    """A view that puts a sharded dim under an outer factor of the dim it
    makes (each shard a strided set of indices; no ``P`` says that):
    torch 2.13 lays it out as a ``_StridedShard``, which is gathered over
    that mesh dim only; torch 2.11 refuses the view, which runs on whole
    values."""
    from torch.distributed.tensor import Replicate, Shard

    out, counter, _ = _policy_run(
        lambda x: x.view(8, 64, 4).transpose(1, 2).reshape(8, 256),
        [("data", "model")])
    # (4, 256) f32, the data shard, gathered over model; then over data
    gather = {"op": "all-gather", "result_bytes": 4096, "group": 2,
              "count": 1}
    whole = {"op": "all-gather", "result_bytes": 8192, "group": 2,
             "count": 1}
    want = {"2.13": ({}, {"aten::_unsafe_view": 1},
                     (Shard(0), Replicate()), [gather]),
            "2.11": ({"aten::_unsafe_view": 1}, {},
                     (Replicate(), Replicate()), [gather, whole])}
    assert TORCH in want, f"no pins for torch {torch.__version__}"
    assert (counter.replicated, counter.gathered, out.placements,
            counter.records) == want[TORCH]


def test_unknown_collective_fails_the_cell():
    """A collective the reference's inventory has no name for raises
    ``InventoryError`` (which ``_NoPlan`` never retries)."""
    import torch.distributed as dist

    assert coll.reference_op(torch.ops._c10d_functional.all_reduce) == \
        "all-reduce"
    assert coll.reference_op(torch.ops._c10d_functional.wait_tensor) is None
    with coll.fake_world(_mesh22(), "cpu"):
        x = torch.zeros(8)
        with pytest.raises(coll.InventoryError, match="broadcast"), \
                coll.CollectiveCounter():
            torch.ops._c10d_functional.broadcast(
                x, 0, dist.group.WORLD.group_name)


def test_a_step_at_fault_raises_its_own_error():
    """An op that fails on whole values too is the step's fault: its first
    error is raised."""
    with pytest.raises(RuntimeError, match="size"):
        _policy_run(lambda x: x.view(7, -1), [(None, "model")])


# ---------------------------------------------------------------------------
# model level: a dense and an MoE prefill cell against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ref_side.CELLS)
def test_prefill_cell_pinned(reference, small_shapes, arch):
    """Both sides' per-op totals pinned; each cell whose totals differ has
    its Queue C entry (ROADMAP C24, C25), and ROADMAP names it."""
    want = CELL_TOTALS[arch]
    got_ref = _totals(reference[arch])
    assert got_ref == want["ref"]
    assert TORCH in want["port"], f"no pins for torch {torch.__version__}"
    want_port, want_whole, want_gathered = want["port"][TORCH]
    cell = dryrun.build_cell(get_config(arch).reduced(), small_shapes[0],
                             _mesh22())
    counter = dryrun.collective_inventory(cell)
    got_port = _totals(counter.records)
    assert got_port == want_port
    assert counter.replicated == want_whole
    assert counter.gathered == want_gathered
    if got_ref != got_port:
        assert want["queue_c"], f"{arch}: a difference with no entry"
        assert f"**{want['queue_c']}." in (REPO / "ROADMAP.md").read_text()


# ---------------------------------------------------------------------------
# two counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_counter_agrees_with_comm_debug_mode(small_shapes, arch):
    """On a small prefill and decode cell of each reduced config, the two
    dispatch modes count the same collectives, op for op."""
    from torch.distributed.tensor.debug import CommDebugMode

    mesh = _mesh22()
    for shape in small_shapes:
        cell = dryrun.build_cell(get_config(arch).reduced(), shape, mesh)
        with coll.fake_world(mesh) as dm:
            args = cell.dtensor_args(dm)
            with CommDebugMode() as comm:
                _, counter = coll.count_collectives(cell.fn, args, mesh)
        theirs = {}
        for func, n in comm.get_comm_counts().items():
            op = coll.reference_op(func)
            theirs[op] = theirs.get(op, 0) + n
        # CommDebugMode also counts what a failed attempt issued before
        # the op ran on whole values: the counter's ``withdrawn``
        ours = dict(counter.withdrawn)
        for r in counter.records:
            ours[r["op"]] = ours.get(r["op"], 0) + r["count"]
        assert ours == theirs, (arch, shape)
        assert sum(theirs.values()) > 0


# ---------------------------------------------------------------------------
# the values on 4 gloo processes
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_prefill_matches_whole(tmp_path, small_shapes):
    """Reduced codeqwen and olmoe prefill on a (2, 2) mesh of 4 gloo ranks
    (loopback), the reference's parameters carried by ``convert``."""
    import jax

    from repro.configs import ARCHS as REF_ARCHS
    from repro.models import init_params as jinit
    from repro_torch.convert import params_from_numpy

    name, seq, batch = ref_side.CELL_SHAPE
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    port = _free_port()
    # the ranks start (and import torch) while this process makes their
    # inputs; each waits for ``ready``
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_collectives_gloo.py"),
         str(r), str(port), str(tmp_path), *ref_side.CELLS],
        env=env, cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    try:
        rng = np.random.default_rng(0)
        for arch in ref_side.CELLS:
            cfg = dataclasses.replace(REF_ARCHS[arch].reduced(),
                                      dtype="float32")
            tcfg = dataclasses.replace(get_config(arch).reduced(),
                                       dtype="float32")
            tree = jax.tree.map(np.asarray, jax.jit(
                jinit, static_argnums=1)(jax.random.key(0), cfg))
            model = params_from_numpy(tree, tcfg, device="cpu")
            torch.save(model.state_dict(), tmp_path / f"{arch}.pt")
            torch.save(torch.from_numpy(
                rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)),
                tmp_path / f"{arch}.tokens.pt")
        (tmp_path / "ready").touch()
        # the fake world's records, while the ranks run
        fakes = {arch: dryrun.collective_inventory(dryrun.build_cell(
            dataclasses.replace(get_config(arch).reduced(), dtype="float32"),
            name, _mesh22()), device_type="cpu").records
            for arch in ref_side.CELLS}
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(4)]
    for arch, fake in fakes.items():
        for r, res in enumerate(ranks):
            got = res[arch]
            assert got["err"] <= GLOO_REL * max(got["scale"], 1.0), (
                arch, r, got["err"], got["scale"])
            assert got["records"] == fake, (arch, r)
        assert fake, arch


# ---------------------------------------------------------------------------
# placements, constrain, the process group
# ---------------------------------------------------------------------------

def _all_specs(mesh):
    """Every spec the rules give the full configs' parameters and decode
    states and the cells' inputs on ``mesh``."""
    from repro_torch.configs import shapes_for
    from repro_torch.launch import specs
    from repro_torch.models.params import param_shapes
    from repro_torch.sharding.partition import param_specs

    out = set()
    for cfg in ARCHS.values():
        out.update(param_specs(param_shapes(cfg), mesh).values())
        for shape in shapes_for(cfg):
            sh = specs.input_specs(cfg, shape)["shardings"](mesh)
            if SHAPES[shape].step == "train":
                sh = (sh[1],)
            for tree in sh:
                leaves = tree.values() if isinstance(tree, dict) else [tree]
                out.update(s.spec for s in leaves)
    return out


@pytest.mark.parametrize("kind", ["pod", "multipod"])
def test_placements_of_every_rule_spec(kind):
    """Each spec DTensor places block for block as ``NamedSharding`` does
    (a dim over ``("pod", "data")``: pod major), on rank 0's coordinates
    and every other rank's."""
    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset,
        compute_local_shape_and_global_offset)

    from repro_torch.sharding.layout import NamedSharding

    mesh = make_production_mesh(multi_pod=kind == "multipod", device="meta")
    specs = _all_specs(mesh)
    assert any(isinstance(e, tuple) for s in specs for e in s) == \
        (kind == "multipod")
    names = mesh.axis_names
    grid = np.asarray(mesh.devices).shape
    with coll.fake_world(mesh) as dm:
        for spec in specs:
            shape = tuple(4 * 512 for _ in range(max(len(spec), 1)))
            ns = NamedSharding(mesh, spec)
            idx = ns.indices(shape)
            pl = coll.placements(spec, names)
            # rank 0 (this process) through the public helper, others at
            # their mesh coordinates
            local, offset = compute_local_shape_and_global_offset(
                shape, dm, pl)
            assert tuple(offset) == tuple(s.start for s in idx[0]), spec
            for rank in (0, 1, 17, 255, int(np.prod(grid)) - 1):
                coords = [int(c) for c in np.unravel_index(rank, grid)]
                local, offset = _compute_local_shape_and_global_offset(
                    shape, grid, coords, pl)
                assert tuple(local) == ns.shard_shape(shape), spec
                assert tuple(offset) == tuple(s.start for s in idx[rank]), \
                    (spec, rank)


def test_placements_refuse_what_they_cannot_hold():
    names = ("pod", "data", "model")
    with pytest.raises(ValueError, match="cannot represent"):
        coll.placements(P(("data", "pod")), names)
    with pytest.raises(ValueError, match="not in the mesh"):
        coll.placements(P("expert"), names)
    from torch.distributed.tensor import Replicate, Shard

    assert coll.placements(P(("pod", "data"), None, "model"), names) == \
        [Shard(0), Shard(0), Shard(2)]
    assert coll.placements(P(), names) == [Replicate()] * 3


def test_constrain_returns_a_plain_tensor_itself():
    from repro_torch.sharding.ctx import constrain, use_mesh_rules

    x = torch.randn(4, 8, 16)
    with use_mesh_rules(make_production_mesh(device="meta")):
        assert constrain(x, "batch", "seq_block", "embed") is x
    assert constrain(x, "batch", None, "embed") is x


def test_no_process_group_left_behind(small_shapes):
    import torch.distributed as dist

    mesh = _mesh22()
    cell = dryrun.build_cell(get_config("xlstm-125m").reduced(),
                             small_shapes[1], mesh)
    assert dryrun.collective_inventory(cell).records
    assert not dist.is_initialized()

    def boom(*args):
        raise RuntimeError("boom")

    # the step raises inside the fake world; then the arguments do, in a
    # cell whose first trace passes
    with pytest.raises(RuntimeError, match="boom"):
        dryrun.collective_inventory(dataclasses.replace(cell, fn=boom))
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="boom"):
        dryrun.measure_cell(dataclasses.replace(cell, dtensor_args=boom))
    assert not dist.is_initialized()


def test_one_device_mesh_has_no_collectives(small_shapes):
    """A mesh of one device issues no collective: the inventory is empty
    and nothing is traced (no process group is made)."""
    import torch.distributed as dist

    mesh = make_test_mesh((1, 1), device="meta")
    cell = dryrun.build_cell(get_config("xlstm-125m").reduced(),
                             small_shapes[1], mesh)

    def never(*args):
        raise AssertionError("traced")

    counter = dryrun.collective_inventory(
        dataclasses.replace(cell, fn=never, dtensor_args=never))
    assert counter.records == [] and not dist.is_initialized()
    res = dryrun.measure_cell(cell)
    assert res["collectives"] == {} and res["inventory_caveats"] == []
    assert res["cost"]["wire_bytes_per_dev"] == 0.0


def test_import_stays_light():
    """``import repro_torch`` (and the dry run's module) imports neither
    ``torch.distributed.tensor`` nor JAX."""
    code = ("import sys, repro_torch, repro_torch.launch.dryrun, "
            "repro_torch.utils.collectives\n"
            "bad = [m for m in sys.modules if m.startswith("
            "('torch.distributed.tensor', 'jax', 'repro.'))]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]

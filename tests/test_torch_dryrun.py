"""``repro_torch.launch.dryrun`` on the ``meta`` device.

The reference's own slow cell (``tests/test_system.py``: xlstm-125m,
decode_32k, multipod) through ``run_cell``: the analytic numbers and
parameter counts equal the reference's, the argument bytes per device equal
the sum over the reference's shard shapes; the CLI (``OK`` and its JSON,
``FAIL`` and "1 cells failed"); a reduced train cell and a reduced prefill
cell through ``build_cell``/``measure_cell``; and the same decode cell on a
one-shard mesh traced on ``meta`` and run on the CPU: the FLOPs counted
equal, the real arguments' bytes the dry run's.  Serving cells carry the
collective inventory (``utils.collectives``; train cells ``null``), and it
leaves every field of the first trace as it was.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_sharding_ref as ref
import repro.models as ref_models
from repro.configs import ARCHS as REF_ARCHS
from repro.launch import specs as ref_specs
from repro.utils import flopcount as ref_flop
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh

REPO = Path(__file__).resolve().parents[1]
ARCH, SHAPE, MESH = "xlstm-125m", "decode_32k", "multipod"


def _ref_argument_bytes(arch, shape, kind):
    """The reference's decode cell's arguments (params, state, token), each
    leaf's shard shape on the production mesh, summed."""
    cfg = REF_ARCHS[arch]
    duck = ref.DuckMesh(*ref.MESHES[kind])
    spec = ref_specs.input_specs(cfg, shape)
    state, token = spec["args"]
    total = 0
    for name, leaf in ref.flat(ref_models.param_shapes(cfg)).items():
        total += ref.dev_bytes(ref.param_spec("params/" + name, leaf.shape,
                                              duck), leaf, kind)
    for name, leaf in ref.flat(state).items():
        total += ref.dev_bytes(ref.decode_spec(name, leaf.shape, duck), leaf,
                               kind)
    return total + ref.dev_bytes(ref.batch_spec(token.shape, duck), token,
                                 kind)


@pytest.fixture(scope="module")
def reference_cell():
    return dryrun.run_cell(ARCH, SHAPE, MESH)


def test_reference_cell(reference_cell):
    res = reference_cell
    cfg = REF_ARCHS[ARCH]
    ana = ref_flop.analytic_cell(cfg, SHAPE, 512, 16)
    assert res["n_chips"] == 512 and res["kind"] == "decode"
    assert res["n_params"] == ref_models.count_params(cfg)
    assert res["n_active_params"] == ref_models.count_params(
        cfg, active_only=True)
    assert res["cost"]["flops_per_dev"] == ana["flops_per_dev"]
    assert res["cost"]["hbm_bytes_per_dev"] == ana["hbm_bytes_per_dev"]
    assert res["model_flops"] == ana["model_flops"]
    assert res["useful_flops_ratio"] == (
        ana["model_flops"] / (ana["flops_per_dev"] * 512))
    mem = res["memory"]
    assert mem["argument_bytes_per_dev"] == _ref_argument_bytes(ARCH, SHAPE,
                                                                MESH)
    assert mem["peak_bytes_per_dev"] == (
        mem["argument_bytes_per_dev"] + mem["output_bytes_per_dev"]
        + mem["temp_bytes_per_dev"] - mem["alias_bytes_per_dev"])
    assert mem["temp_bytes_per_dev"] > 0
    # 128 sequences over (pod, data) = 32 shards: 4 per shard
    assert res["batch_per_shard"] == 4 and res["device"] == "meta"
    assert res["cost"]["torch_flops_per_dev_raw"] > 0
    assert res["constraints"] == {"batch None embed": 1,
                                  "batch seq vocab": 1}
    # the collective inventory on the 512 ranks: per op as the reference
    # shapes it, its wire bytes, the roofline's collective term
    colls = res["collectives"]
    assert colls and set(colls) <= {"all-reduce", "all-gather",
                                    "reduce-scatter", "all-to-all"}
    for v in colls.values():
        assert v["count"] >= 1 and v["weighted_result_bytes"] > 0
    wire = res["cost"]["wire_bytes_per_dev"]
    assert wire > 0 and res["inventory_seconds"] > 0
    roof = res["roofline"]
    assert roof["collective_s"] == wire / 900e9
    assert roof == ref_roofline(res, wire)
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert roof[roof["dominant"] + "_s"] == max(
        roof["compute_s"], roof["memory_s"], roof["collective_s"])
    # what it is not: a partitioner's plan where ops ran on whole values
    assert res["inventory_caveats"] == [
        f"run on whole values: {op} x {n}"
        for op, n in res["inventory_replicated"].items()] + [
        f"result gathered where no P says its layout: {op} x {n}"
        for op, n in res["inventory_gathered"].items()]
    assert res["inventory_caveats"]
    assert res["torch_version"] == torch.__version__


def _no_inventory(monkeypatch):
    """The dry run as it was before the inventory: no second trace."""
    monkeypatch.setattr(dryrun, "collective_inventory", lambda cell: None)


def test_reference_cell_inventory(reference_cell, monkeypatch):
    """The inventory leaves every field of the reference's cell as it is
    without it; without it the inventory's fields are ``null``."""
    _no_inventory(monkeypatch)
    off = dryrun.run_cell(ARCH, SHAPE, MESH)
    for k in ("memory", "constraints", "model_flops", "n_chips", "n_params",
              "batch_per_shard", "useful_flops_ratio"):
        assert reference_cell[k] == off[k], k
    for k in ("flops_per_dev", "hbm_bytes_per_dev", "torch_flops_per_dev_raw"):
        assert reference_cell["cost"][k] == off["cost"][k], k
    assert off["collectives"] is None and off["inventory_seconds"] is None
    assert off["cost"]["wire_bytes_per_dev"] is None
    assert off["roofline"]["collective_s"] is None
    assert off["roofline"]["dominant"] in ("compute", "memory")
    assert off["inventory_caveats"] is None


def ref_roofline(res, wire):
    """The roofline terms of ``res`` with ``wire`` bytes on the wire, from
    the port's card constants (``utils.roofline``)."""
    from repro_torch.utils.roofline import roofline_terms

    return roofline_terms(res["cost"]["flops_per_dev"],
                          res["cost"]["hbm_bytes_per_dev"], wire)


def test_cli_ok_and_json(tmp_path, capsys):
    dryrun.main(["--arch", ARCH, "--shape", SHAPE, "--mesh", MESH, "--out",
                 str(tmp_path)])
    out = capsys.readouterr().out
    assert out.startswith(f"OK   {ARCH}_{SHAPE}_{MESH}: peak/dev="), out
    rec = json.loads((tmp_path / f"{ARCH}_{SHAPE}_{MESH}.json").read_text())
    assert f"collective={rec['roofline']['collective_s'] * 1e3:.2f}ms" in out
    assert "inventory not a plan: " in out
    assert rec["arch"] == ARCH and rec["mesh"] == MESH
    assert rec["cost"]["xla_flops_per_dev_raw"] is None
    assert rec["cost"]["xla_bytes_per_dev_raw"] is None
    assert rec["collectives"] and rec["cost"]["wire_bytes_per_dev"] > 0


def test_cli_unknown_arch_fails(tmp_path):
    """``python -m repro_torch.launch.dryrun`` with an unknown arch: a FAIL
    line, the traceback file, exit non-zero with "1 cells failed"."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "nope",
         "--shape", SHAPE, "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=str(REPO), timeout=300)
    assert proc.returncode != 0
    assert "1 cells failed" in proc.stderr
    assert proc.stdout.startswith("FAIL nope_decode_32k_pod: KeyError")
    assert (tmp_path / "nope_decode_32k_pod.FAILED.txt").exists()
    assert "jax" not in proc.stdout + proc.stderr


def _bytes(shardings, leaves):
    """Bytes per device: each leaf's shard shape times its element size."""
    return sum(int(np.prod(shardings[k].shard_shape(tuple(t.shape)),
                           dtype=np.int64)) * t.element_size()
               for k, t in leaves.items())


@pytest.mark.parametrize("arch,shape", [("codeqwen1.5-7b", "train_4k"),
                                        ("paligemma-3b", "prefill_32k")])
def test_reduced_cells(arch, shape):
    """A reduced train cell and a reduced prefill cell on a (2, 2) mesh on
    ``meta``: one batch shard of the global batch (over ``data``), the
    argument bytes the sum over the specs, the donated train state as the
    alias, the constrain sites resolved and counted, FLOPs counted."""
    from repro_torch.ckpt.checkpoint import named_leaves
    from repro_torch.launch import specs
    from repro_torch.models.params import param_shapes

    cfg = get_config(arch).reduced()
    mesh = make_test_mesh((2, 2), device="meta")
    cell = dryrun.build_cell(cfg, shape, mesh)
    spec = specs.input_specs(cfg, shape)
    sh = spec["shardings"](mesh)
    if cell.kind == "train":
        state = dict(named_leaves(spec["args"][0]))
        want = _bytes(sh[0], state) + _bytes(sh[1], spec["args"][1])
        alias = _bytes(sh[0], state)
        assert cell.local_batch == 256 // 2
    else:
        params = {"params": param_shapes(cfg)}
        want = (_bytes(specs.state_shardings(params, mesh),
                       dict(named_leaves(params)))
                + _bytes({"t": sh[0]}, {"t": spec["args"][0]})
                + _bytes(sh[1], spec["args"][1]))
        alias = 0
        assert cell.local_batch == 32 // 2
    assert cell.kind == spec["kind"]
    res = dryrun.measure_cell(cell)
    assert res["constraints"]["batch seq_block embed"] > 0
    assert res["constraints"]["batch seq vocab"] > 0
    mem = res["memory"]
    assert mem["argument_bytes_per_dev"] == want
    assert mem["alias_bytes_per_dev"] == alias
    assert mem["temp_bytes_per_dev"] > 0
    assert res["cost"]["torch_flops_per_dev_raw"] > 0
    assert res["device"] == "meta" and res["kind"] == cell.kind
    if cell.kind == "train":  # no inventory of a train cell yet
        assert res["collectives"] is None
        assert res["cost"]["wire_bytes_per_dev"] is None
        assert res["roofline"]["collective_s"] is None
        assert res["inventory_seconds"] is None
    else:
        assert res["collectives"]["all-gather"]["count"] > 0
        assert res["cost"]["wire_bytes_per_dev"] > 0
        assert res["roofline"]["collective_s"] > 0
        moe = any(c.startswith("C25:") for c in res["inventory_caveats"])
        assert moe == bool(cfg.n_experts and cell.kind == "prefill")


@pytest.mark.parametrize("arch,shape", [("olmoe-1b-7b", "decode_32k"),
                                        ("paligemma-3b", "prefill_32k"),
                                        ("codeqwen1.5-7b", "train_4k")])
def test_inventory_leaves_the_first_trace_alone(arch, shape, monkeypatch):
    """With the inventory and without it: the memory, FLOP and constraint
    fields bit for bit equal; without it the inventory's fields are
    ``null``, as before it existed."""
    cfg = get_config(arch).reduced()
    mesh = make_test_mesh((2, 2), device="meta")
    on = dryrun.measure_cell(dryrun.build_cell(cfg, shape, mesh))
    _no_inventory(monkeypatch)
    off = dryrun.measure_cell(dryrun.build_cell(cfg, shape, mesh))
    assert on["memory"] == off["memory"]
    assert on["constraints"] == off["constraints"]
    for k in ("flops_per_dev", "hbm_bytes_per_dev", "torch_flops_per_dev_raw",
              "xla_flops_per_dev_raw", "xla_bytes_per_dev_raw"):
        assert on["cost"][k] == off["cost"][k], k
    for k in ("compute_s", "memory_s"):
        assert on["roofline"][k] == off["roofline"][k], k
    assert off["collectives"] is None and off["inventory_seconds"] is None
    assert off["cost"]["wire_bytes_per_dev"] is None
    assert off["roofline"]["collective_s"] is None
    assert (on["collectives"] is None) == (shape == "train_4k")


def test_meta_count_equals_a_real_run():
    """The decode cell of a reduced config on a one-shard mesh, traced on
    ``meta`` and run on the CPU: the FLOPs counted are equal, the dry run's
    argument bytes are the bytes of the real parameters, state and token,
    and the trace made nothing off its device."""
    cfg = get_config(ARCH).reduced()
    meta = dryrun.build_cell(cfg, SHAPE, make_test_mesh((1, 1),
                                                        device="meta"))
    real = dryrun.build_cell(cfg, SHAPE, make_test_mesh((1, 1),
                                                        device="cpu"),
                             device="cpu")
    got_meta, got_real = dryrun.measure_cell(meta), dryrun.measure_cell(real)
    assert got_meta["cost"] == got_real["cost"]
    assert got_meta["memory"] == {**got_real["memory"],
                                  "temp_bytes_per_dev":
                                  got_meta["memory"]["temp_bytes_per_dev"],
                                  "peak_bytes_per_dev":
                                  got_meta["memory"]["peak_bytes_per_dev"]}
    nbytes = sum(t.numel() * t.element_size()
                 for t in real.tensors())
    assert nbytes == got_real["memory"]["argument_bytes_per_dev"]
    assert got_real["device"] == "cpu" and real.local_batch == 128


def test_kv_int8_and_no_sp_flags(monkeypatch):
    """``--kv-int8`` swaps the KV caches for int8 codes and bf16 scales
    (fewer argument bytes); ``--no-sp`` records the cell as without
    sequence parallelism.  (The first trace's fields only: no inventory.)"""
    _no_inventory(monkeypatch)
    plain = dryrun.run_cell("mixtral-8x7b", "decode_32k", "pod")
    quant = dryrun.run_cell("mixtral-8x7b", "decode_32k", "pod",
                            kv_int8=True, no_sp=True)
    assert plain["seq_parallel"] and not quant["seq_parallel"]
    assert (quant["memory"]["argument_bytes_per_dev"]
            < plain["memory"]["argument_bytes_per_dev"])
    assert quant["cost"]["flops_per_dev"] == plain["cost"]["flops_per_dev"]
    with pytest.raises(ValueError, match="skips long_500k"):
        dryrun.run_cell("codeqwen1.5-7b", "long_500k", "pod")

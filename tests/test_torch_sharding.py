"""``repro_torch.sharding`` against ``repro.sharding``.

``logical_to_spec`` on the reference's own cases and on a sweep of every
logical name, dims divisible and not, four meshes, with ``exclude``;
``constrain``'s ``disable``; ``param_specs`` of all 10 full configs on both
production meshes (leaf names, specs and bytes per device) and of the
reduced configs on (2, 2); ``constrain`` changing no value (prefill, decode
and the train step's gradients bitwise with and without a mesh context on a
dense, an MoE and a recurrent reduced config); the constrain sites against
the reference's; and ``layout.NamedSharding``'s pieces.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import ast
import itertools
import re
from collections import Counter
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JaxNamedSharding

import _torch_sharding_ref as ref
from repro.configs import ARCHS as REF_ARCHS
from repro.models import param_shapes as ref_param_shapes
from repro.sharding import partition as ref_part
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import decode_step, loss_fn, prefill
from repro_torch.models.params import (leaf_path, param_shapes, path_str,
                                       stack_named)
from repro_torch.models.transformer import init_params
from repro_torch.sharding import constrain, ctx, partition, use_mesh_rules
from repro_torch.sharding.layout import NamedSharding
from repro_torch.sharding.partition import P

REPO = Path(__file__).resolve().parents[1]
SWEEP_MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}
NAMES = [None, *partition.LOGICAL_RULES, "not_a_rule"]
DIMS = (1, 2, 8, 16, 48, 256, 51865)
EXCLUDES = ((), ("pod",), ("model",), ("data",))
BITWISE_ARCHS = ("codeqwen1.5-7b", "olmoe-1b-7b", "xlstm-125m")


def _same(port_spec, ref_spec):
    return tuple(port_spec) == tuple(ref_spec) and ref_spec == tuple(port_spec)


def test_rule_tables_are_the_reference_s():
    assert dict(partition.LOGICAL_RULES) == dict(ref_part.LOGICAL_RULES)
    assert list(partition._PARAM_RULES) == list(ref_part._PARAM_RULES)


def test_reference_cases():
    """``tests/test_models.py``'s cases: whisper's vocab falls back to
    replication, the divisibility chain, batch over (pod, data)."""
    mesh = ref.DuckMesh((16, 16), ("data", "model"))
    spec = partition.logical_to_spec(("vocab", "fsdp"), (51865, 768), mesh)
    assert spec[0] is None and spec == P(None, "data")
    assert partition.logical_to_spec(("fsdp", "qkv_fused"), (2048, 2048),
                                     mesh) == P("data", "model")
    assert partition.logical_to_spec(("experts", "moe_d", "fsdp"),
                                     (8, 4096, 28672), mesh) == \
        P(None, "model", "data")
    pod = ref.DuckMesh((2, 16, 16), ("pod", "data", "model"))
    assert partition.logical_to_spec(("batch", None), (256, 4096), pod) == \
        P(("pod", "data"), None)
    assert P("a") != P("a", None) and P() != P(None)
    assert P(("a",), ()) == P("a", None)
    with pytest.raises(AssertionError):
        partition.logical_to_spec(("batch",), (4, 4), mesh)


@pytest.mark.parametrize("exclude", EXCLUDES, ids=lambda e: "-".join(e) or
                         "none")
@pytest.mark.parametrize("kind", SWEEP_MESHES)
def test_logical_to_spec_sweep(kind, exclude):
    """Every logical name alone and in every pair, over dims divisible and
    not: the port's spec is the reference's."""
    mesh = ref.DuckMesh(*SWEEP_MESHES[kind])
    cases = [((n,), (d,)) for n in NAMES for d in DIMS]
    cases += [((a, b), dims) for a, b in itertools.product(NAMES, NAMES)
              for dims in itertools.product(DIMS[1:6:2], DIMS[2:7:2])]
    for logical, shape in cases:
        want = ref_part.logical_to_spec(logical, shape, mesh, exclude=exclude)
        got = partition.logical_to_spec(logical, shape, mesh, exclude=exclude)
        assert _same(got, want), (logical, shape, got, want)


def test_constrain_disable_and_exclude():
    """Under ``use_mesh_rules(exclude, disable)`` the recorded spec is the
    reference's ``logical_to_spec`` with the disabled names as None."""
    mesh = make_production_mesh(multi_pod=True, device="meta")
    duck = ref.DuckMesh(*ref.MESHES["multipod"])
    x = torch.empty((64, 4096, 1024), device="meta")
    for exclude, disable in itertools.product(EXCLUDES[:3],
                                              ((), ("seq_block",))):
        logical = ("batch", "seq_block", "embed")
        with use_mesh_rules(mesh, exclude=exclude, disable=disable), \
                ctx.recording() as sites:
            assert constrain(x, *logical) is x
        names = tuple(None if n in disable else n for n in logical)
        want = ref_part.logical_to_spec(names, tuple(x.shape), duck,
                                        exclude=exclude)
        assert [s[:2] for s in sites] == [(logical, tuple(x.shape))]
        assert _same(sites[0][2], want)


def _ref_param_layout(cfg, kind):
    duck = ref.DuckMesh(*ref.MESHES[kind])
    specs = ref.flat(ref_part.param_specs(ref_param_shapes(cfg), duck))
    leaves = ref.flat(ref_param_shapes(cfg))
    return {k: (tuple(leaves[k].shape), specs[k],
                ref.dev_bytes(specs[k], leaves[k], kind)) for k in leaves}


def _port_param_layout(cfg, mesh):
    leaves = stack_named(param_shapes(cfg).named_parameters())
    specs = partition.param_specs(param_shapes(cfg), mesh)
    out = {}
    for k, spec in specs.items():
        shape = tuple(leaves[k].shape)
        local = NamedSharding(mesh, spec).shard_shape(shape)
        out[k] = (shape, spec, int(np.prod(local, dtype=np.int64))
                  * leaves[k].element_size())
    return out


@pytest.mark.parametrize("kind", ["pod", "multipod"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_full_configs(arch, kind):
    """Every leaf of the full config: name, stacked shape, spec and bytes
    per device equal the reference's on the production mesh."""
    mesh = make_production_mesh(multi_pod=kind == "multipod", device="meta")
    got = _port_param_layout(get_config(arch), mesh)
    want = _ref_param_layout(REF_ARCHS[arch], kind)
    assert sorted(got) == sorted(want)
    for k, (shape, spec, nbytes) in want.items():
        g_shape, g_spec, g_bytes = got[k]
        assert (g_shape == shape and _same(g_spec, spec)
                and g_bytes == nbytes), (k, got[k], want[k])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_reduced_on_2x2(arch):
    mesh = make_test_mesh((2, 2), device="meta")
    duck = ref.DuckMesh((2, 2), ("data", "model"))
    want = ref.flat(ref_part.param_specs(
        ref_param_shapes(REF_ARCHS[arch].reduced()), duck))
    got = partition.param_specs(param_shapes(get_config(arch).reduced()),
                                mesh)
    assert sorted(got) == sorted(want)
    assert all(_same(got[k], want[k]) for k in want)
    # a port parameter name (one superblock) gets the stacked leaf's spec
    # without its leading entry
    for name, p in param_shapes(get_config(arch).reduced()).named_parameters():
        if name.startswith("blocks.1."):
            stacked = want[path_str(leaf_path(name)[0])]
            one = partition.spec_for_path(name, tuple(p.shape), mesh)
            assert tuple(one) == tuple(stacked)[1:len(stacked)], \
                (name, one, stacked)


def test_constrain_is_identity():
    x = torch.arange(12.0).reshape(3, 4)
    assert constrain(x, "batch", "embed") is x
    with use_mesh_rules(make_test_mesh((2, 2), device="meta")):
        assert ctx.current_mesh() is not None
        assert constrain(x, "batch", "embed") is x
    assert ctx.current_mesh() is None


def _run(cfg, tokens):
    """Prefill logits and state, one decode step's logits and state, the
    loss and its gradients, on parameters from seed 0."""
    params = init_params(torch.Generator().manual_seed(0), cfg,
                         device="cpu").requires_grad_(True)
    with torch.no_grad():
        logits, state = prefill(params, cfg, tokens, max_len=12)
        nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        dlogits, dstate = decode_step(params, cfg, state, nxt)
    loss, _ = loss_fn(params, cfg, {"tokens": tokens})
    grads = torch.autograd.grad(loss, list(params.parameters()))
    return [logits, dlogits, loss.detach(), *_flat(state), *_flat(dstate),
            *grads]


def _flat(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flat(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


@pytest.mark.parametrize("arch", BITWISE_ARCHS)
def test_values_bitwise_under_mesh_rules(arch):
    """Prefill, decode and the gradients with a mesh context active equal
    the run without one, bit for bit; the context resolved sites."""
    cfg = get_config(arch).reduced()
    tokens = torch.randint(0, cfg.vocab, (2, 9), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    plain = _run(cfg, tokens)
    mesh = make_production_mesh(multi_pod=True, device="meta")
    with use_mesh_rules(mesh), ctx.recording() as sites:
        ruled = _run(cfg, tokens)
    assert sites
    assert len(plain) == len(ruled)
    for a, b in zip(plain, ruled):
        assert torch.equal(a, b)


_SITE = re.compile(r"constrain\(\s*[\w\.\(\)\[\], ]*?,\s*((?:\"\w+\"|None)"
                   r"(?:\s*,\s*(?:\"\w+\"|None))*)\s*\)")


def _sites(package):
    found = []
    for f in sorted((REPO / "src" / package / "models").glob("*.py")):
        text = f.read_text()
        for m in _SITE.finditer(text):
            found.append(ast.literal_eval("(" + m.group(1) + ",)"))
    return found


def test_constrain_sites_are_the_reference_s():
    """The port's models hold the reference's 8 constrain sites, name for
    name, and a prefill and a decode step of the MoE config resolve every
    one of them."""
    want = _sites("repro")
    got = _sites("repro_torch")
    assert len(want) == 8 and Counter(got) == Counter(want), (got, want)
    cfg = get_config("olmoe-1b-7b").reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 5), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    with use_mesh_rules(make_test_mesh((2, 2), device="meta")), \
            ctx.recording() as sites, torch.no_grad():
        logits, state = prefill(params, cfg, tokens, max_len=8)
        decode_step(params, cfg, state, tokens[:, :1])
    assert {s[0] for s in sites} == set(want)


def test_named_sharding_pieces():
    """Each shard's piece is its block (pod-major for a joint axis),
    replicated over the axes the spec leaves out; ``gather`` is the tensor
    bit for bit; shard shapes agree with the reference's on an
    ``AbstractMesh``."""
    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    t = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    sh = NamedSharding(mesh, P(("pod", "data"), None, "model"))
    s = sh.shard(t)
    assert sh.num_devices == 8 and len(s.pieces) == 8
    assert sh.shard_shape(t.shape) == (2, 6, 2)
    want_shape = JaxNamedSharding(
        AbstractMesh((2, 2, 2), ("pod", "data", "model")),
        jax.sharding.PartitionSpec(("pod", "data"), None, "model"),
    ).shard_shape((8, 6, 4))
    assert sh.shard_shape(t.shape) == tuple(want_shape)
    for i, (pod, data, model) in enumerate(np.ndindex(2, 2, 2)):
        row = (pod * 2 + data) * 2
        assert torch.equal(s.pieces[i], t[row:row + 2, :,
                                          model * 2:model * 2 + 2])
    assert torch.equal(s.gather("cpu"), t)
    rep = NamedSharding(mesh, P()).shard(t)
    assert all(torch.equal(p, t) for p in rep.pieces)
    with pytest.raises(ValueError, match="divide"):
        NamedSharding(mesh, P("model")).shard_shape((3,))

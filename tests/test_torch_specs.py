"""``repro_torch.launch.specs`` and ``utils.flopcount`` against the
reference's, for every (arch x shape) cell of the 10 full configs.

The port's ``input_specs`` leaves (``meta`` tensors from the real
constructors) against the reference's ``jax.eval_shape`` leaves: name,
shape and dtype; their shardings' specs and bytes per device on both
production meshes against the reference's rules resolved on a duck-typed
mesh (``tests/_torch_sharding_ref.py``); ``analytic_cell`` equal, float for
float.  Also the decode state carried across with ``convert``, and the
walk that names its leaves making no reference cycle.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import dataclasses
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

import _torch_sharding_ref as ref
import repro.models as ref_models
from repro.configs import ARCHS as REF_ARCHS
from repro.launch import specs as ref_specs
from repro.utils import flopcount as ref_flop
from repro_torch.ckpt.checkpoint import named_leaves
from repro_torch.configs import ARCHS, get_config, shapes_for
from repro_torch.convert import decode_state_from_numpy, decode_state_to_numpy
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.utils import flopcount

CELLS = [(a, s) for a in sorted(ARCHS) for s in shapes_for(ARCHS[a])]
MESHES = {k: make_production_mesh(multi_pod=k == "multipod", device="meta")
          for k in ref.MESHES}
_REF_SPECS = {}


def _ref_input_specs(arch, shape):
    if (arch, shape) not in _REF_SPECS:
        _REF_SPECS[(arch, shape)] = ref_specs.input_specs(REF_ARCHS[arch],
                                                          shape)
    return _REF_SPECS[(arch, shape)]


def _dtype(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.dtype(leaf.dtype))


def _port_args(spec):
    """The cell's arguments as ``[(group, {name: leaf}, shardings(mesh) ->
    {name: NamedSharding})]`` in the reference's argument order."""
    if spec["kind"] == "train":
        state, batch = spec["args"]
        return [("state", dict(named_leaves(state)),
                 lambda m: spec["shardings"](m)[0]),
                ("batch", batch, lambda m: spec["shardings"](m)[1])]
    if spec["kind"] == "prefill":
        tokens, extras = spec["args"]
        return [("tokens", {"": tokens},
                 lambda m: {"": spec["shardings"](m)[0]}),
                ("extras", extras, lambda m: spec["shardings"](m)[1])]
    state, token = spec["args"]
    return [("state", specs.decode_state_leaves(state),
             lambda m: spec["shardings"](m)[0]),
            ("token", {"": token}, lambda m: {"": spec["shardings"](m)[1]})]


def _ref_args(spec):
    """The reference's cell as ``[(group, {name: leaf}, rule)]``, ``rule``
    the reference's spec of one leaf on a duck-typed mesh."""
    args = spec["args"]
    if spec["kind"] == "train":
        return [("state", ref.flat(args[0]), ref.param_spec),
                ("batch", ref.flat(args[1]),
                 lambda n, s, m: ref.batch_spec(s, m))]
    if spec["kind"] == "prefill":
        return [("tokens", {"": args[0]},
                 lambda n, s, m: ref.batch_spec(s, m)),
                ("extras", ref.flat(args[1]),
                 lambda n, s, m: ref.batch_spec(s, m))]
    return [("state", ref.flat(args[0]), ref.decode_spec),
            ("token", {"": args[1]}, lambda n, s, m: ref.batch_spec(s, m))]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_cell(arch, shape):
    """Every leaf of the cell's arguments: name, shape, dtype, and on both
    production meshes its spec and bytes per device."""
    port = specs.input_specs(get_config(arch), shape)
    want = _ref_input_specs(arch, shape)
    assert port["kind"] == want["kind"]
    assert port.get("accum_steps") == want.get("accum_steps")
    assert port["opt_config"].moments_dtype == want["opt_config"].moments_dtype
    for (group, leaves, shardings), (g2, ref_leaves, rule) in zip(
            _port_args(port), _ref_args(want)):
        assert group == g2
        assert sorted(leaves) == sorted(ref_leaves), group
        for name, leaf in ref_leaves.items():
            got = leaves[name]
            assert got.device.type == "meta"
            assert tuple(got.shape) == tuple(leaf.shape), (group, name)
            assert _dtype(got) == _dtype(leaf), (group, name)
        for kind, mesh in MESHES.items():
            duck = ref.DuckMesh(*ref.MESHES[kind])
            sh = shardings(mesh)
            assert sorted(sh) == sorted(ref_leaves)
            for name, leaf in ref_leaves.items():
                r_spec = rule(name, tuple(leaf.shape), duck)
                assert tuple(sh[name].spec) == tuple(r_spec), \
                    (kind, group, name, sh[name].spec, r_spec)
                local = sh[name].shard_shape(tuple(leaves[name].shape))
                nbytes = (int(np.prod(local, dtype=np.int64))
                          * leaves[name].element_size())
                assert nbytes == ref.dev_bytes(r_spec, leaf, kind), \
                    (kind, group, name)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_cell(arch, shape):
    """The analytic FLOP and HBM model equals the reference's, float for
    float, on both production meshes."""
    for n_chips in (256, 512):
        got = flopcount.analytic_cell(get_config(arch), shape, n_chips, 16)
        want = ref_flop.analytic_cell(REF_ARCHS[arch], shape, n_chips, 16)
        assert got == want
    assert flopcount.cell_flops(get_config(arch), shape) == \
        ref_flop.cell_flops(REF_ARCHS[arch], shape)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-125m",
                                  "whisper-small", "gemma3-27b"])
def test_decode_state_carried_across(arch):
    """The reference's decode state (``init_decode_state``'s tree, each
    leaf filled with random bits of its dtype), flattened with its
    ``_path_str``, becomes the port's state and back leaf for leaf, bitwise
    (int8 caches too); its names and shapes are ``decode_state_leaves``'."""
    rng = np.random.default_rng(0)
    for quant in (False, True):
        rcfg = dataclasses.replace(REF_ARCHS[arch].reduced(), kv_quant=quant)
        cfg = dataclasses.replace(get_config(arch).reduced(), kv_quant=quant)
        abstract = jax.eval_shape(
            lambda: ref_models.init_decode_state(rcfg, 2, 12))
        leaves = {}
        for k, v in ref.flat(abstract).items():
            dt = np.dtype(v.dtype)
            n = int(np.prod(v.shape)) * dt.itemsize
            words = rng.integers(0, 256, size=n, dtype=np.uint8)
            leaves[k] = words.view(np.uint16 if dt.name == "bfloat16"
                                   else dt).reshape(v.shape)
        port = decode_state_from_numpy(leaves, cfg, device="cpu")
        back = decode_state_to_numpy(port)
        assert list(back) == list(leaves)
        for k, v in leaves.items():
            assert back[k].shape == v.shape, k
            assert back[k].tobytes() == v.tobytes(), k
        shapes = {k: tuple(t.shape)
                  for k, t in specs.decode_state_leaves(port).items()}
        assert {k: tuple(v.shape) for k, v in leaves.items()} == shapes


def test_decode_state_walk_frees_its_tensors():
    """Naming a decode state's leaves makes no reference cycle: with the
    garbage collector off, a tensor of the state dies with its last
    reference.  (A cycle kept the dry run's counted decode step's 3 GB
    state alive on the card.)"""
    from repro_torch.models import init_decode_state

    state = init_decode_state(get_config("xlstm-125m").reduced(), 2, 8,
                              device="cpu")
    probe = weakref.ref(state["blocks"][0][0].c)
    gc.disable()
    try:
        groups = specs.decode_state_groups(state)
        leaves = specs.decode_state_leaves(state)
        assert groups["blocks/0/c"][0] is probe()
        del groups, leaves, state
        assert probe() is None
    finally:
        gc.enable()

"""``repro_torch.launch.elastic`` and ``restore_checkpoint(shardings=...)``.

``elastic_mesh``'s shapes for several surviving-device counts against
``repro.launch.elastic.elastic_mesh`` on forced host devices (in a child
process with its own ``XLA_FLAGS``); ``resume_on_mesh`` on 4 host shards
(the counterpart of ``tests/test_checkpoint.py``'s elastic reshard): every
leaf on 4 devices, each piece of its spec's shape, gathered bitwise; and a
checkpoint the reference wrote restored onto a mesh of host shards.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_sharding_ref as ref
from repro.ckpt import save_checkpoint as ref_save
from repro.configs import get_config as ref_get_config
from repro.train.optimizer import OptConfig as RefOptConfig
from repro.train.steps import init_train_state as ref_init_train_state
from repro_torch.ckpt import CheckpointManager, restore_checkpoint
from repro_torch.ckpt import save_checkpoint
from repro_torch.ckpt.checkpoint import named_leaves
from repro_torch.configs import get_config
from repro_torch.launch.elastic import elastic_mesh, resume_on_mesh
from repro_torch.launch.mesh import make_test_mesh, shard_devices
from repro_torch.launch.specs import abstract_train_state, state_shardings
from repro_torch.sharding.layout import NamedSharding, Sharded
from repro_torch.sharding.partition import P
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.steps import init_train_state

REPO = Path(__file__).resolve().parents[1]
SURVIVORS = [(64, 16), (63, 16), (48, 16), (17, 16), (16, 16), (40, 4),
             (7, 2), (5, 1), (1, 1), (15, 16)]


def _ref_elastic_shapes():
    code = (
        "import json\n"
        "import jax\n"
        "from repro.launch.elastic import elastic_mesh\n"
        f"out = []\n"
        f"for n, model in {SURVIVORS!r}:\n"
        "    try:\n"
        "        m = elastic_mesh(model, devices=jax.devices()[:n])\n"
        "        out.append([list(m.devices.shape), list(m.axis_names)])\n"
        "    except RuntimeError as e:\n"
        "        out.append(str(e))\n"
        "print('SHAPES', json.dumps(out))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=64",
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("SHAPES "))
    return json.loads(line[len("SHAPES "):])


def test_elastic_mesh_shapes():
    want = _ref_elastic_shapes()
    for (n, model), w in zip(SURVIVORS, want):
        devices = shard_devices(n, "cpu")
        if isinstance(w, str):
            with pytest.raises(RuntimeError) as e:
                elastic_mesh(model, devices=devices)
            assert str(e.value) == w
            continue
        m = elastic_mesh(model, devices=devices)
        assert [list(m.devices.shape), list(m.axis_names)] == w


def test_elastic_mesh_default_devices():
    """Without ``devices`` the mesh spans the kind's devices: one host shard
    on the CPU; ``cuda`` by default, which raises without a card."""
    m = elastic_mesh(1, device="cpu")
    assert m.devices.shape == (1, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            elastic_mesh(1)


def _check_sharded(state, want, n_devices):
    got = dict(named_leaves(state))
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        s = got[name]
        assert isinstance(s, Sharded) and s.sharding.num_devices == n_devices
        local = s.sharding.shard_shape(tuple(leaf.shape))
        assert all(tuple(p.shape) == local for p in s.pieces), name
        g = s.gather("cpu")
        assert g.dtype == leaf.dtype and torch.equal(g, leaf), name


def test_resume_on_4_host_shards(tmp_path):
    """A train state (an MoE config in bf16, bf16 moments) saved by the
    port, resumed onto 4 of 5 surviving host shards as a (2, 2) mesh."""
    import dataclasses

    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(),
                              dtype="bfloat16")
    oc = OptConfig(moments_dtype="bfloat16")
    state = init_train_state(torch.Generator().manual_seed(0), cfg, oc,
                             device="cpu")
    CheckpointManager(tmp_path, every=1).maybe_save(2, state)
    mesh = elastic_mesh(2, devices=shard_devices(5, "cpu"))
    restored, manifest = resume_on_mesh(tmp_path,
                                        abstract_train_state(cfg, oc), mesh)
    assert manifest["step"] == 2
    want = dict(named_leaves(state))
    _check_sharded(restored, want, 4)
    specs = {k: v.sharding.spec for k, v in named_leaves(restored)}
    assert specs["params/blocks/0/moe/wi_moe"] == P(None, "model", None,
                                                    "data")
    with pytest.raises(FileNotFoundError):
        resume_on_mesh(tmp_path / "none", abstract_train_state(cfg, oc), mesh)


def test_reshard_like_the_reference(tmp_path):
    """``tests/test_checkpoint.py``'s reshard: an 8 x 8 leaf restored onto a
    4-device mesh as ``P("data", None)``."""
    w = torch.arange(64.0).reshape(8, 8)
    save_checkpoint(tmp_path, 1, {"w": w})
    mesh = make_test_mesh((4,), ("data",), device="cpu")
    shard = {"w": NamedSharding(mesh, P("data", None))}
    restored, _ = restore_checkpoint(tmp_path, 1, {"w": w}, shardings=shard)
    assert restored["w"].sharding.num_devices == 4
    assert [tuple(p.shape) for p in restored["w"].pieces] == [(2, 8)] * 4
    assert torch.equal(restored["w"].gather("cpu"), w)
    with pytest.raises(ValueError, match="not both"):
        restore_checkpoint(tmp_path, 1, {"w": w}, shardings=shard,
                           device="cpu")
    with pytest.raises(KeyError, match="no sharding"):
        restore_checkpoint(tmp_path, 1, {"w": w}, shardings={})


def test_restore_reference_checkpoint_sharded(tmp_path):
    """A train state the reference wrote, restored into the port's abstract
    state onto a (2, 2) mesh of host shards: every leaf gathers to the
    reference's bits."""
    rcfg = ref_get_config("codeqwen1.5-7b").reduced()
    roc = RefOptConfig()
    ref_state = ref_init_train_state(jax.random.key(0), rcfg, roc)
    ref_save(tmp_path, 4, ref_state)
    cfg, oc = get_config("codeqwen1.5-7b").reduced(), OptConfig()
    target = abstract_train_state(cfg, oc)
    mesh = make_test_mesh((2, 2), device="cpu")
    restored, manifest = restore_checkpoint(
        tmp_path, 4, target, shardings=state_shardings(target, mesh))
    assert manifest["step"] == 4
    want = {k: torch.from_numpy(np.array(v))
            for k, v in ref.flat(ref_state).items()}
    _check_sharded(restored, want, 4)

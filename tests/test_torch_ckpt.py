"""The port's checkpoints against the JAX reference's.

A checkpoint the reference writes restores into the port's train state
bitwise (its bf16 leaves too, by the manifest's dtype), and the port's
restores into the reference's bitwise for f32 leaves; the two write the
same ``data.bin``.  The port's manifest writer is byte for byte
``msgpack.packb`` and its reader ``msgpack.unpackb``.  The reference cannot
restore a bf16 leaf at all (ROADMAP C18), shown here.  Also the atomic,
gc, resume and shape cases of ``tests/test_checkpoint.py`` and the zlib
fallback.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as jrestore
from repro.ckpt import save_checkpoint as jsave
from repro.configs import ARCHS
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.ckpt import (CheckpointManager, latest_step,
                              restore_checkpoint, save_checkpoint)
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.ckpt import manifest
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy

ARCH = "jamba-1.5-large-398b"  # stacked superblocks, a tail-free hybrid


def _jstate(opt="adamw", moments="float32", dtype=None):
    cfg = ARCHS[ARCH].reduced()
    if dtype:
        import dataclasses
        cfg = dataclasses.replace(cfg, dtype=dtype)
    st = jsteps.init_train_state(
        jax.random.key(0), cfg, jopt.OptConfig(name=opt,
                                               moments_dtype=moments))
    st["step"] = jnp.asarray(7, jnp.int32)
    return st


def _tcfg(dtype=None):
    cfg = TARCHS[ARCH].reduced()
    if dtype:
        import dataclasses
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return cfg


def _leaves(tree):
    return [np.atleast_1d(np.asarray(v)) for v in jax.tree.leaves(tree)]


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype.itemsize == y.dtype.itemsize
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_reference_checkpoint_restores_into_the_port(tmp_path, opt):
    st = _jstate(opt)
    jsave(tmp_path, 7, st)
    target = train_state_from_numpy(jax.tree.map(np.asarray, _jstate(opt)),
                                    _tcfg(), device="cpu")
    got, man = restore_checkpoint(tmp_path, 7, target)
    assert man["step"] == 7 and int(got["step"]) == 7
    assert all(p.requires_grad for p in got["params"].parameters())
    _same(train_state_to_numpy(got), jax.tree.map(np.asarray, st))


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_port_checkpoint_restores_into_the_reference(tmp_path, opt):
    st = _jstate(opt)
    port = train_state_from_numpy(jax.tree.map(np.asarray, st), _tcfg(),
                                  device="cpu")
    save_checkpoint(tmp_path / "port", 7, port)
    back, man = jrestore(tmp_path / "port", 7, st)
    assert man["step"] == 7
    _same(back, st)
    jsave(tmp_path / "ref", 7, st)
    assert (tmp_path / "port/ckpt_00000007/data.bin").read_bytes() == \
        (tmp_path / "ref/ckpt_00000007/data.bin").read_bytes()
    assert {k: v for k, v in man.items() if k != "treedef"} == {
        k: v for k, v in msgpack.unpackb(
            (tmp_path / "ref/ckpt_00000007/manifest.msgpack").read_bytes()
        ).items() if k != "treedef"}


def test_bf16_leaves(tmp_path):
    """bf16 weights and moments: the reference's checkpoint restores into
    the port bitwise by the manifest's dtype; the port's own round trip
    too.  The reference restores neither (C18: ``np.load`` gives the words
    as ``|V2``, which ``jnp.asarray`` refuses)."""
    st = _jstate(moments="bfloat16", dtype="bfloat16")
    st["error_fb"] = jsteps.init_error_fb(st["params"])
    jsave(tmp_path / "ref", 7, st)
    target = train_state_from_numpy(jax.tree.map(np.asarray, st),
                                    _tcfg("bfloat16"), device="cpu")
    got, man = restore_checkpoint(tmp_path / "ref", 7, target)
    assert man["leaves"]["params/embed"]["dtype"] == "bfloat16"
    assert got["params"].embed.dtype == torch.bfloat16
    _same(train_state_to_numpy(got), jax.tree.map(np.asarray, st))
    save_checkpoint(tmp_path / "port", 7, target)
    again, _ = restore_checkpoint(tmp_path / "port", 7, target)
    _same(train_state_to_numpy(again), jax.tree.map(np.asarray, st))
    for d in ("ref", "port"):
        with pytest.raises(TypeError, match="V2"):
            jrestore(tmp_path / d, 7, st)


PACK_CASES = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    0.0, -1.5, 3.141592653589793, 1e300, True, False, None, "", "a" * 31,
    "b" * 32, "c" * 255, "d" * 256, "é" * 40000, [], list(range(15)),
    list(range(16)), list(range(70000)), {}, {f"k{i}": i for i in range(15)},
    {f"k{i}": [i, None] for i in range(16)},
    {"nested": {"shape": [3, 4], "dtype": "float32", "ok": True,
                "t": (1, 2.5)}},
]


@pytest.mark.parametrize("obj", PACK_CASES, ids=range(len(PACK_CASES)))
def test_manifest_bytes_equal_msgpack(obj):
    raw = msgpack.packb(obj)
    assert manifest.packb(obj) == raw
    assert manifest.unpackb(raw) == msgpack.unpackb(raw)


def test_manifest_rejects_what_it_cannot_write():
    with pytest.raises(TypeError):
        manifest.packb({"a": np.int64(3)})
    with pytest.raises(ValueError, match="extra bytes"):
        manifest.unpackb(msgpack.packb(1) + b"\x00")


def _small():
    return {"params": {"embed": torch.randn(6, 4, generator=torch.Generator(
        ).manual_seed(0))}, "step": torch.tensor(7, dtype=torch.int32)}


def test_latest_and_gc(tmp_path):
    for s in (10, 20, 30, 40):
        save_checkpoint(tmp_path, s, _small(), keep=2)
    assert latest_step(tmp_path) == 40
    assert sorted(p.name for p in tmp_path.glob("ckpt_*")) == [
        "ckpt_00000030", "ckpt_00000040"]
    assert not list(tmp_path.glob(".tmp-*"))
    assert latest_step(tmp_path / "absent") is None


def test_shape_and_missing_leaf_rejected(tmp_path):
    save_checkpoint(tmp_path, 3, _small())
    bad = _small()
    bad["params"]["embed"] = torch.zeros(7, 4)
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(tmp_path, 3, bad)
    bad = _small()
    bad["params"]["head"] = torch.zeros(2)
    with pytest.raises(KeyError, match="params/head"):
        restore_checkpoint(tmp_path, 3, bad)


def test_manager_resume(tmp_path):
    mgr = CheckpointManager(tmp_path, every=2)
    assert mgr.restore_latest(_small()) == (None, None)
    assert mgr.maybe_save(1, _small()) is None
    assert mgr.maybe_save(2, _small()) is not None
    restored, man = mgr.restore_latest(_small())
    assert man["step"] == 2
    assert torch.equal(restored["params"]["embed"], _small()["params"]["embed"])


def test_zlib_when_zstandard_is_absent(tmp_path, monkeypatch):
    """Without the wheel, new checkpoints are zlib and say so; a zstd
    checkpoint then names the missing wheel."""
    save_checkpoint(tmp_path / "z", 1, _small())
    monkeypatch.setattr(tckpt, "_zstandard", lambda: None)
    save_checkpoint(tmp_path / "l", 1, _small())
    got, man = restore_checkpoint(tmp_path / "l", 1, _small())
    assert man["codec"] == "zlib"
    assert torch.equal(got["params"]["embed"], _small()["params"]["embed"])
    with pytest.raises(ModuleNotFoundError, match="zstandard"):
        restore_checkpoint(tmp_path / "z", 1, _small())

"""The int8 cross-pod gradient exchange against the JAX reference.

``quantized_psum_mean`` from identical gradients (and error-feedback
buffers) is bitwise the reference's: elementwise ops, a max and an int sum.
The compressed train step on the reduced codeqwen config, against the
reference's ``make_compressed_train_step`` on the same state and batch:
at one pod in process, at two pods in a child process whose JAX has two
forced host devices (its own ``XLA_FLAGS``; nothing here sets them in
``os.environ``).  The loss and grad norm within ``1e-5`` relative; the
parameters and moments within ``1e-6 x max(|ref|, 1)`` per element but
where a gradient within rounding of a code boundary took the other int8
code (at most 0.1% of a leaf; a first moment then differs by one code,
``(1 - b1) * scale / pods``); each pod's bf16 residual within one code
(``scale``) plus the gradient tolerance and a bf16 ulp.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_train_ref import (GRAD_REL, LEFT_OUT, LOSS_REL, OPT_REL, _batch,
                              _jstate, _oc, _path_str, jopt, topt,
                              train_state_from_numpy, train_state_to_numpy)
from repro.configs import ARCHS
from repro.models import loss_fn as jloss
from repro.train import steps as jsteps
from repro.utils.jax_compat import make_mesh, shard_map
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.launch.mesh import make_pod_data_mesh, make_test_mesh
from repro_torch.train import steps as tsteps

REPO = Path(__file__).resolve().parents[1]
ARCH = "codeqwen1.5-7b"


def _grads_np(seed, pods, shapes=((64, 8), (3, 16), (5,))):
    rng = np.random.default_rng(seed)
    return [{f"l{i}": rng.normal(0, 0.01 * (i + 1), s).astype(np.float32)
             for i, s in enumerate(shapes)} for _ in range(pods)]


def _bf16(t):
    return torch.from_numpy(np.asarray(t).view(np.int16).copy()).view(
        torch.bfloat16)


def _words(t):
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("with_efb", [False, True])
def test_quantized_psum_mean_bitwise(with_efb):
    (g,) = _grads_np(0, 1)
    efb = ({k: jnp.asarray(0.003 * v[::-1].copy(), jnp.bfloat16)
            for k, v in g.items()} if with_efb else None)
    mesh = make_mesh((1,), ("pod",))
    want, want_e = shard_map(
        lambda gg, ee: jsteps.quantized_psum_mean(gg, "pod", 1, error_fb=ee),
        mesh, in_specs=(P(), P()), out_specs=(P(), P()),
    )({k: jnp.asarray(v) for k, v in g.items()}, efb)
    got, got_e = tsteps.quantized_psum_mean(
        [{k: torch.from_numpy(v) for k, v in g.items()}],
        None if efb is None else {k: _bf16(v) for k, v in efb.items()})
    for k in g:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert got_e[0][k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            _words(got_e[0][k]), np.asarray(want_e[k]).view(np.int16))


def _port_compressed(st_np, mesh, steps=1):
    tcfg = TARCHS[ARCH].reduced()
    state = train_state_from_numpy(st_np, tcfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    step = tsteps.make_compressed_train_step(tcfg, _oc(topt), mesh,
                                             remat=False)
    for _ in range(steps):
        state, metrics = step(state, batch)
    return state, metrics


def _check_compressed(ref, state, metrics, pods):
    """``ref``: the reference's metrics, state and full-batch gradients
    (numpy, flat by path), its error feedback per pod."""
    for k in ("loss", "grad_norm"):
        want, got = float(ref["metrics"][k]), float(metrics[k])
        assert abs(got - want) <= LOSS_REL * abs(want), (k, got, want)
    got = {_path_str(p): v for p, v in jax.tree_util.tree_flatten_with_path(
        train_state_to_numpy({k: v for k, v in state.items()
                              if k != "error_fb"}))[0]}
    for name, g in ref["grads"].items():
        # a gradient within rounding of a code boundary (k + 1/2) * scale
        # may take the other int8 code, at any magnitude: its mean moves by
        # scale / pods, its first moment by (1 - b1) times that
        step_m = (1 - 0.9) * ref["scale"][name] / pods
        for part in ("params/", "opt/m/", "opt/v/"):
            w = ref["state"][part + name]
            d = np.abs(got[part + name] - w)
            out = d / np.maximum(np.abs(w), 1.0) > OPT_REL
            assert out.mean() <= LEFT_OUT, (part + name, out.mean())
            if part == "opt/m/":
                assert d.max() <= step_m * (1 + 1e-3) + OPT_REL, (
                    part + name, d.max(), step_m)
    assert len(state["error_fb"]) == pods
    for i in range(pods):
        for name, w in ref["efb"][i].items():
            g = ref["grads"][name]
            scale = ref["scale"][name]
            e = np.abs(state["error_fb"][i][name].float().numpy() - w)
            bound = scale + GRAD_REL * max(float(np.abs(g).max()), 1e-6) \
                + scale * 2.0 ** -8
            assert e.max() <= bound, (i, name, e.max(), bound)


def test_compressed_step_one_pod():
    cfg = ARCHS[ARCH].reduced()
    st = _jstate(cfg, _oc(jopt))
    st["error_fb"] = jsteps.init_error_fb(st["params"])
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    new, metrics = jax.jit(jsteps.make_compressed_train_step(
        cfg, _oc(jopt), make_mesh((1,), ("pod",)), remat=False))(st, batch)
    grads = jax.jit(jax.grad(lambda p: jloss(p, cfg, batch,
                                             remat=False)[0]))(st["params"])
    ref = _ref_dict(new, metrics, grads, [new["error_fb"]], [grads])
    st_np = jax.tree.map(np.asarray, st)
    state, tmet = _port_compressed(st_np, make_test_mesh((1,), ("pod",),
                                                         device="cpu"))
    _check_compressed(ref, state, tmet, 1)


def _flat_np(tree):
    return {_path_str(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ref_dict(new, metrics, grads, efbs, pod_grads):
    g = {k: v.astype(np.float64) for k, v in _flat_np(grads).items()}
    pods = [_flat_np(p) for p in pod_grads]
    scale = {k: max(float(np.abs(p[k]).max()) for p in pods) / 127
             for k in g}
    state = {k: v.astype(np.float64) for k, v in
             _flat_np({k: v for k, v in new.items() if k != "error_fb"}
                      ).items()}
    return {"metrics": jax.tree.map(np.asarray, metrics), "grads": g,
            "state": state,
            "efb": [{k: v.astype(np.float32) for k, v in _flat_np(e).items()}
                    for e in efbs],
            "scale": scale}


_CHILD = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, "tests")
from _torch_train_ref import _batch, _jstate, _oc, jopt
from repro.configs import ARCHS
from repro.models import loss_fn as jloss
from repro.train import steps as jsteps
from repro.utils.jax_compat import make_mesh

cfg = ARCHS[sys.argv[1]].reduced()
st = _jstate(cfg, _oc(jopt))
st["error_fb"] = jsteps.init_error_fb(st["params"])
batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
mesh = make_mesh((2,), ("pod",))
step = jax.jit(jsteps.make_compressed_train_step(cfg, _oc(jopt), mesh,
                                                 remat=False))
new, metrics = step(st, batch)
lf = lambda b: jax.jit(jax.grad(lambda p: jloss(p, cfg, b, remat=False)[0]))(
    st["params"])
half = batch["tokens"].shape[0] // 2
out = {"state": st, "new": {k: v for k, v in new.items() if k != "error_fb"},
       "metrics": metrics, "grads": lf(batch),
       "pod0": lf({"tokens": batch["tokens"][:half]}),
       "pod1": lf({"tokens": batch["tokens"][half:]}),
       # each pod's residual: the shards of the replicated-spec output
       "efb0": jax.tree.map(
           lambda a: a.addressable_shards[0].data.astype(jnp.float32),
           new["error_fb"]),
       "efb1": jax.tree.map(
           lambda a: a.addressable_shards[1].data.astype(jnp.float32),
           new["error_fb"])}
flat = {}
for p, v in jax.tree_util.tree_flatten_with_path(out)[0]:
    v = np.asarray(v)
    flat[jax.tree_util.keystr(p)] = (v.view(np.uint16)
                                     if v.dtype.name == "bfloat16" else v)
np.savez(sys.argv[2], **flat)
print("COMPRESSED2 OK")
"""


def _unflat(flat, prefix, like):
    """The child's flat arrays under ``prefix`` back into ``like``'s
    tree."""
    paths = jax.tree_util.tree_flatten_with_path(like)[0]
    leaves = []
    for p, v in paths:
        a = flat[prefix + jax.tree_util.keystr(p)]
        if np.asarray(v).dtype.name == "bfloat16":
            a = a.view(jnp.bfloat16)
        leaves.append(a)
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(like),
                                        leaves)


def test_compressed_step_two_pods(tmp_path):
    """Two pods: the reference on two forced host devices in a child
    process, the port on two host pods of a (pod, data) = (2, 1) mesh."""
    out = tmp_path / "ref.npz"
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
    proc = subprocess.run([sys.executable, "-c", _CHILD, ARCH, str(out)],
                          capture_output=True, text=True, env=env,
                          cwd=str(REPO), timeout=600)
    assert proc.returncode == 0 and "COMPRESSED2 OK" in proc.stdout, \
        proc.stderr[-3000:]
    flat = dict(np.load(out))
    cfg = ARCHS[ARCH].reduced()
    like = jax.eval_shape(lambda: _jstate(cfg, _oc(jopt)))
    st = _unflat(flat, "['state']", {**like, "error_fb": jax.eval_shape(
        lambda: jsteps.init_error_fb(like["params"]))})
    new = _unflat(flat, "['new']", like)
    metrics = {k: flat[f"['metrics']['{k}']"] for k in
               ("aux", "grad_norm", "loss", "xent")}
    g = lambda key: _unflat(flat, f"['{key}']", like["params"])
    ref = _ref_dict(new, metrics, g("grads"), [g("efb0"), g("efb1")],
                    [g("pod0"), g("pod1")])
    st_np = jax.tree.map(np.asarray, st)
    state, tmet = _port_compressed(st_np, make_pod_data_mesh(2, 1,
                                                             device="cpu"))
    _check_compressed(ref, state, tmet, 2)


def test_compressed_step_needs_pods():
    tcfg = TARCHS[ARCH].reduced()
    with pytest.raises(AssertionError, match="multi-pod"):
        tsteps.make_compressed_train_step(
            tcfg, _oc(topt), make_test_mesh((2,), ("data",), device="cpu"))

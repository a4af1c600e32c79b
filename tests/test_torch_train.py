"""The port's train step against the JAX reference, on carried state.

For a dense, an MoE and two recurrent reduced configs (f32), the
reference's train state (``repro.train.steps.init_train_state``, its step
set past warmup so the learning rate is not 0) is carried into the port
with ``convert.train_state_from_numpy``; both packages then take one
``make_train_step`` step on the same batch.  Tolerances (ROADMAP, Queue A
2):

* the loss and the grad norm within ``1e-5`` relative;
* every gradient leaf within ``1e-4 x max(max|g_ref|, 1e-6)``;
* the parameters and the optimizer state after the step within ``1e-6 x
  max(|ref|, 1)`` per element, except where ``|g_ref|`` is at most 100
  times the gradient tolerance: there Adam's ``m / sqrt(v)`` turns a sign
  flip of a near-zero gradient into ``+-lr``.  Such elements may be left
  out, at most 0.1% of a leaf.

Also ``accum_steps=2``, Adafactor, remat (the port's numbers with it equal
its own without it, bitwise) and the train state's round trip through
``convert``.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_ref import (AT_STEP, ARCHS, TARCHS, _batch, _check, _oc,
                              _path_str, _port_step, jopt, jsteps, loss_fn,
                              topt, train_state_from_numpy,
                              train_state_to_numpy, tsteps)


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "olmoe-1b-7b"])
def test_train_step_matches_reference(arch):
    """A dense and an MoE config (the recurrent ones:
    ``tests/test_torch_train_recurrent.py``)."""
    _check(arch)


def test_accum_steps_two():
    """Two microbatches of 2, f32 gradients accumulated / 2 (MoE: each
    microbatch its own routing groups and aux loss)."""
    _check("olmoe-1b-7b", accum=2)


def test_adafactor_step():
    """Factored second moments of the stacked leaves: the stacked
    ``(n_blocks, d)`` vectors factor across blocks as the reference's.
    (On a leaf with gradient elements that are zero but for rounding, as
    codeqwen's key bias, Adafactor scales that noise to unit RMS and the
    two packages' updates part: ROADMAP C19.)"""
    _check("olmoe-1b-7b", opt="adafactor")


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "xlstm-125m"])
def test_remat_changes_no_number(arch):
    """Block-level remat recomputes the superblocks in the backward: the
    loss, every gradient and the new state bitwise as without it."""
    _, a, ma = _port_step(arch, own=True)
    _, b, mb = _port_step(arch, remat=True, own=True)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for x, y in zip(jax.tree.leaves(train_state_to_numpy(a)),
                    jax.tree.leaves(train_state_to_numpy(b))):
        np.testing.assert_array_equal(x, y)


def test_remat_saves_only_block_boundaries():
    """With remat, the graph holds fewer saved tensors than without."""
    tcfg = TARCHS["codeqwen1.5-7b"].reduced()
    state = tsteps.init_train_state(torch.Generator().manual_seed(0), tcfg,
                                    _oc(topt))
    batch = {"tokens": torch.from_numpy(_batch(tcfg)["tokens"])}
    counts = []
    for remat in (False, True):
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t.numel()) or t, lambda t: t):
            loss_fn(state["params"], tcfg, batch, remat=remat)
        counts.append(sum(saved))
    assert counts[1] < counts[0] / 2, counts


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_train_state_round_trip(opt):
    """The reference's state through the port and back, leaf for leaf,
    with bf16 moments and an error-feedback buffer."""
    cfg, tcfg = ARCHS["xlstm-125m"].reduced(), TARCHS["xlstm-125m"].reduced()
    oc = _oc(jopt, name=opt, moments_dtype="bfloat16")
    st = jsteps.init_train_state(jax.random.key(3), cfg, oc)
    st["error_fb"] = jax.tree.map(
        lambda p: (0.01 * p).astype(jnp.bfloat16), st["params"])
    tree = jax.tree.map(np.asarray, st)
    back = train_state_to_numpy(train_state_from_numpy(tree, tcfg, "cpu"))
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = dict((_path_str(p), v) for p, v in
               jax.tree_util.tree_flatten_with_path(back)[0])
    assert sorted(got) == sorted(_path_str(p) for p, _ in want)
    for p, w in want:
        g = got[_path_str(p)]
        assert g.shape == w.shape and g.dtype.itemsize == w.dtype.itemsize
        np.testing.assert_array_equal(np.atleast_1d(g).view(np.uint8),
                                      np.atleast_1d(w).view(np.uint8))


def test_init_train_state():
    """The port's own state: trainable parameters, moments shaped as the
    reference's leaves, step 0."""
    tcfg = TARCHS["jamba-1.5-large-398b"].reduced()
    cfg = ARCHS["jamba-1.5-large-398b"].reduced()
    state = tsteps.init_train_state(torch.Generator().manual_seed(0), tcfg,
                                    _oc(topt))
    assert all(p.requires_grad for p in state["params"].parameters())
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    shapes = jax.eval_shape(lambda: jsteps.init_train_state(
        jax.random.key(0), cfg, _oc(jopt)))
    want = {_path_str(p): tuple(v.shape) for p, v in
            jax.tree_util.tree_flatten_with_path(shapes["opt"]["m"])[0]}
    assert {k: tuple(v.shape) for k, v in state["opt"]["m"].items()} == want


# whisper-small's key biases: every key gets the same bias in a softmax
# row, so their gradients are zero but for rounding (ROADMAP C20)
C20_LEAVES = ("blocks/0/bk", "blocks/0/cross/bk", "enc_blocks/0/bk")
C20_FLOOR = 1e-6  # the reference's own rounding floor on these leaves


def test_whisper_key_bias_gradients():
    """C20: on whisper's reduced config the three key-bias gradients are
    rounding noise in both packages, so they are bounded in absolute terms
    at the reference's floor (``C20_FLOOR``, 1e-6: the reference's and the
    port's values, and their difference); the loss, the grad norm and
    every other gradient leaf keep ``_check``'s tolerances."""
    from _torch_train_ref import GRAD_REL, LOSS_REL, _reference

    arch = "whisper-small"
    _, jgrads, _, jmet = _reference(arch)
    grads, _, metrics = _port_step(arch)
    for k in ("loss", "grad_norm"):
        want, got = float(jmet[k]), float(metrics[k])
        assert abs(got - want) <= LOSS_REL * abs(want), (k, got, want)
    assert sorted(grads) == sorted(jgrads)
    for k, g in jgrads.items():
        err = float(np.abs(grads[k] - g).max())
        if k in C20_LEAVES:
            assert float(np.abs(g).max()) <= C20_FLOOR, k
            assert float(np.abs(grads[k]).max()) <= C20_FLOOR, k
            assert err <= C20_FLOOR, f"{k}: {err:.3e}"
            continue
        tol = GRAD_REL * max(float(np.abs(g).max()), 1e-6)
        assert err <= tol, f"grad {k}: {err:.3e} > {tol:.3e}"

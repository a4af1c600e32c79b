"""The port's xLSTM layers (``repro_torch.models.xlstm``) against
``repro.models.xlstm``, function by function.

The reference's parameters (``mlstm_init`` / ``slstm_init`` of xlstm-125m's
reduced config, in f32, zero leaves filled from a seed) are carried into a
``ParamTree``; both packages get the same numpy inputs from a seed.  Every
float output agrees within ``1e-4 x max(max|ref|, 1)``: the mLSTM's gates,
its chunked form (one chunk, several chunks, and a length that is no
multiple of the chunk, which the reference runs as one chunk), its
closed-form prefill state and its decode step; the sLSTM's cell, its loop
over time with the state, and its decode step.  On the port alone, the
teacher-forcing contract of one layer of each kind: prefill's state and
the decode steps give the full sequence's outputs.  In bf16 (d_model 96),
one layer of each kind, prefill and a decode step, against the reference
run op by op: at most ``SHARE`` of the outputs differ, and the port in
f32 (its outputs rounded to bf16) breaks that bound.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import xlstm as jx
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.models import xlstm as tx
from repro_torch.models.layers import ParamTree

ARCH = "xlstm-125m"
REL = 1e-4
B = 2
SHARE = 0.1   # of a bf16 output's elements, as test_torch_models_bf16.py's


def _close(got, want, what, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel} * {scale:.3e}"


def _cfgs():
    return ARCHS[ARCH].reduced(), TARCHS[ARCH].reduced()


def _params(init, seed=0):
    """The reference's layer parameters (zero leaves filled with 0.1 x
    N(0, 1): a zero bias hides its add) and the port's copy of them."""
    cfg, _ = _cfgs()
    jp = init(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    jp = {k: (jnp.asarray(0.1 * rng.normal(size=v.shape), v.dtype)
              if not np.asarray(v).any() else v) for k, v in jp.items()}
    tp = ParamTree(**{k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    return jp, tp


def _x(seed, *shape, scale=1.0):
    x = scale * np.random.default_rng(seed).normal(size=shape)
    return x.astype(np.float32)


def _t(tree):
    return type(tree)(*[torch.from_numpy(np.array(a)) for a in tree])


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def test_mlstm_qkv_gates():
    cfg, tcfg = _cfgs()
    jp, tp = _params(jx.mlstm_init)
    xm = _x(1, B, 11, jx._mdims(cfg)[0])
    want = jx._mlstm_qkv_gates(jp, cfg, jnp.asarray(xm))
    got = tx._mlstm_qkv_gates(tp, tcfg, torch.from_numpy(xm))
    for g, w, what in zip(got, want, ("q", "k", "v", "i_pre", "f_pre")):
        _close(g, w, what)


@pytest.mark.parametrize("seq,chunk", [
    (16, 512),   # one chunk
    (24, 8),     # three query and key chunks
    (20, 8),     # no multiple of the chunk: the reference runs one chunk
])
def test_mlstm_apply_train(seq, chunk):
    cfg, tcfg = _cfgs()
    jp, tp = _params(jx.mlstm_init)
    x = _x(2, B, seq, cfg.d_model)
    want = jax.jit(lambda p, x: jx.mlstm_apply_train(p, cfg, x, chunk=chunk)
                   )(jp, jnp.asarray(x))
    got = tx.mlstm_apply_train(tp, tcfg, torch.from_numpy(x), chunk=chunk)
    _close(got, want, f"mlstm y at S={seq}, chunk={chunk}")


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [24, 100])
def test_card_mlstm_apply_train_against_cpu(seq):
    """The chunked form on the card against the port on the CPU, the same
    f32 weights, at chunk 8: several query chunks, each over the key chunks
    up to its own, within 1e-4 x scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg, tcfg = _cfgs()
    _, tp = _params(jx.mlstm_init)
    gp = _params(jx.mlstm_init)[1].cuda()
    x = torch.from_numpy(_x(2, B, seq, cfg.d_model))
    want = tx.mlstm_apply_train(tp, tcfg, x, chunk=8)
    got = tx.mlstm_apply_train(gp, tcfg, x.cuda(), chunk=8)
    _close(got.cpu(), want, f"mlstm y on the card, S={seq}, chunk 8")


@pytest.mark.parametrize("seq", [1, 13])
def test_mlstm_prefill_state(seq):
    cfg, tcfg = _cfgs()
    jp, tp = _params(jx.mlstm_init)
    x = _x(3, B, seq, cfg.d_model)
    want = jx.mlstm_prefill_state(jp, cfg, jnp.asarray(x))
    got = tx.mlstm_prefill_state(tp, tcfg, torch.from_numpy(x))
    assert got._fields == want._fields
    for name, g, w in zip(want._fields, got, want):
        _close(g, w, f"state {name}")


def test_mlstm_apply_decode():
    cfg, tcfg = _cfgs()
    jp, tp = _params(jx.mlstm_init)
    state = jx.mlstm_prefill_state(jp, cfg, jnp.asarray(
        _x(4, B, 9, cfg.d_model)))
    x1 = _x(5, B, 1, cfg.d_model)
    want, wst = jx.mlstm_apply_decode(jp, cfg, jnp.asarray(x1), state)
    got, gst = tx.mlstm_apply_decode(tp, tcfg, torch.from_numpy(x1),
                                     _t(state))
    _close(got, want, "y")
    for name, g, w in zip(wst._fields, gst, wst):
        _close(g, w, f"state {name}")


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_state(seed, cfg):
    hd, _ = jx._sdims(cfg)
    shape = (B, cfg.n_heads, hd)
    c, m, h = (_x(seed + i, *shape) for i in range(3))
    n = np.abs(_x(seed + 3, *shape)) + 0.5
    return jx.SLSTMState(c=c, n=n, m=m, h=h)


def test_slstm_cell():
    cfg, tcfg = _cfgs()
    jp, tp = _params(jx.slstm_init)
    xg = _x(6, B, 4 * cfg.d_model)
    st = _slstm_state(7, cfg)
    want = jx._slstm_cell(jp, cfg, jnp.asarray(xg),
                          jx.SLSTMState(*map(jnp.asarray, st)))
    got = tx._slstm_cell(tp, tcfg, torch.from_numpy(xg), _t(st))
    for name, g, w in zip(want._fields, got, want):
        _close(g, w, f"cell {name}")


def test_slstm_apply_train_with_state():
    cfg, tcfg = _cfgs()
    jp, tp = _params(jx.slstm_init)
    x = _x(8, B, 19, cfg.d_model)
    want, wst = jax.jit(lambda p, x: jx.slstm_apply_train(
        p, cfg, x, return_state=True))(jp, jnp.asarray(x))
    got, gst = tx.slstm_apply_train(tp, tcfg, torch.from_numpy(x),
                                    return_state=True)
    _close(got, want, "y")
    for name, g, w in zip(wst._fields, gst, wst):
        _close(g, w, f"state {name}")
    assert tx.slstm_apply_train(tp, tcfg, torch.from_numpy(x))[1] is None


def test_slstm_apply_decode():
    cfg, tcfg = _cfgs()
    jp, tp = _params(jx.slstm_init)
    x1 = _x(9, B, 1, cfg.d_model)
    st = _slstm_state(10, cfg)
    want, wst = jx.slstm_apply_decode(jp, cfg, jnp.asarray(x1),
                                      jx.SLSTMState(*map(jnp.asarray, st)))
    got, gst = tx.slstm_apply_decode(tp, tcfg, torch.from_numpy(x1), _t(st))
    _close(got, want, "y")
    for name, g, w in zip(wst._fields, gst, wst):
        _close(g, w, f"state {name}")


def test_init_states():
    cfg, tcfg = _cfgs()
    for jinit, tinit in ((jx.init_mlstm_state, tx.init_mlstm_state),
                         (jx.init_slstm_state, tx.init_slstm_state)):
        want, got = jinit(cfg, B), tinit(tcfg, B, "cpu")
        assert got._fields == want._fields
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            assert not g.any()


# ---------------------------------------------------------------------------
# One layer, prefill then decode (the port alone)
# ---------------------------------------------------------------------------

def _mlstm_prefill(p, cfg, x):
    return (tx.mlstm_apply_train(p, cfg, x),
            tx.mlstm_prefill_state(p, cfg, x))


LAYERS = {
    "mlstm": (jx.mlstm_init, _mlstm_prefill, tx.mlstm_apply_decode),
    "slstm": (jx.slstm_init,
              lambda p, cfg, x: tx.slstm_apply_train(p, cfg, x,
                                                     return_state=True),
              tx.slstm_apply_decode),
}


@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_teacher_forcing_one_layer(kind):
    """Prefill 12 tokens for the state, then decode 4 tokens one at a
    time: each output as the full sequence's, within 1e-4 x max(max|y|,
    1)."""
    init, prefill, decode = LAYERS[kind]
    _, tcfg = _cfgs()
    _, tp = _params(init)
    x = torch.from_numpy(_x(11, B, 16, tcfg.d_model))
    full, _ = prefill(tp, tcfg, x)
    _, state = prefill(tp, tcfg, x[:, :12])
    for i in range(12, 16):
        y, state = decode(tp, tcfg, x[:, i: i + 1], state)
        _close(y, full[:, i: i + 1], f"{kind} decode step at {i}")


# ---------------------------------------------------------------------------
# One layer in bf16 against the reference run op by op
# ---------------------------------------------------------------------------

def _tt(a) -> torch.Tensor:
    """A reference array as a torch tensor; bfloat16 as its 16-bit words."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _share(got, want) -> float:
    """The share of elements of ``got`` (rounded to bf16) that differ."""
    g = got.to(torch.bfloat16).float().numpy()
    return float((g != np.asarray(want).astype(np.float32)).mean())


BF16_LAYERS = {
    "mlstm": (jx.mlstm_init,
              lambda m, p, cfg, x: (m.mlstm_apply_train(p, cfg, x),
                                    m.mlstm_prefill_state(p, cfg, x)),
              "mlstm_apply_decode", tx.MLSTMState),
    "slstm": (jx.slstm_init,
              lambda m, p, cfg, x: m.slstm_apply_train(p, cfg, x,
                                                       return_state=True),
              "slstm_apply_decode", tx.SLSTMState),
}


@pytest.mark.parametrize("port_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", sorted(BF16_LAYERS))
def test_bf16_layer(kind, port_dtype):
    """Prefill 40 tokens and one decode step from the reference's state,
    the same bf16 inputs on both sides: at most SHARE of each output's
    elements differ; with ``port_dtype="float32"`` (the control) the
    prefill output breaks that bound."""
    init, prefill, decode, state_cls = BF16_LAYERS[kind]
    cfg = dataclasses.replace(_cfgs()[0], dtype="bfloat16", d_model=96)
    jp = init(jax.random.key(0), cfg)
    rng = np.random.default_rng(3)
    jp = {k: (jnp.asarray(0.1 * rng.normal(size=v.shape), v.dtype)
              if not np.asarray(v).any() else v) for k, v in jp.items()}
    tdt = getattr(torch, port_dtype)
    tcfg = dataclasses.replace(cfg, dtype=port_dtype)
    tp = ParamTree(**{k: _tt(v).to(tdt if v.dtype.name == "bfloat16"
                                   else torch.float32)
                      for k, v in jp.items()})
    x = jnp.asarray(_x(12, B, 40, 96), jnp.bfloat16)
    x1 = jnp.asarray(_x(13, B, 1, 96), jnp.bfloat16)
    with jax.disable_jit():
        want, wstate = prefill(jx, jp, cfg, x)
        want1, _ = getattr(jx, decode)(jp, cfg, x1, wstate)
    got, _ = prefill(tx, tp, tcfg, _tt(x).to(tdt))
    got1, _ = getattr(tx, decode)(tp, tcfg, _tt(x1).to(tdt),
                                  state_cls(*map(_tt, wstate)))
    if port_dtype == "float32":
        assert _share(got, want) > SHARE
    else:
        assert got.dtype == torch.bfloat16 and got1.dtype == torch.bfloat16
        assert _share(got, want) <= SHARE
        assert _share(got1, want1) <= SHARE

"""The port's Mamba layer (``repro_torch.models.ssm``) against
``repro.models.ssm``, function by function.

The reference's parameters (``ssm_init`` of jamba's reduced config, in
f32, its zero bias filled from a seed) are carried into a ``ParamTree``;
both packages get the same numpy inputs from a seed.  Every float output
agrees within ``1e-4 x max(max|ref|, 1)``: the causal conv (with and
without the decode buffer), the selective terms (masked and not), the
chunk scan at lengths that pair evenly and oddly, the chunked layer with
its state (a padded tail and a whole number of chunks), and the decode
step.  On the port alone, the teacher-forcing contract of one layer:
prefill's state and the decode steps give the full sequence's outputs.
In bf16 (d_model 96): the causal conv bitwise against the reference run
op by op, and the layer's prefill and a decode step with at most
``SHARE`` of their outputs differing, a bound the port in f32 (its
outputs rounded to bf16) breaks.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import ssm as jssm
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import ParamTree

ARCH = "jamba-1.5-large-398b"
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


def _params(seed=0):
    """The reference's layer parameters and the port's copy of them."""
    cfg, _ = _cfgs()
    jp = jssm.ssm_init(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    jp["conv_b"] = jnp.asarray(0.1 * rng.normal(size=jp["conv_b"].shape),
                               jnp.float32)   # a zero bias hides its add
    tp = ParamTree(**{k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    return jp, tp


def _x(seed, *shape, scale=1.0):
    x = scale * np.random.default_rng(seed).normal(size=shape)
    return x.astype(np.float32)


def _state(seed, cfg):
    d_in, _, st = jssm._dims(cfg)
    return (_x(seed, B, d_in, st), _x(seed + 1, B, cfg.ssm_conv - 1, d_in))


@pytest.mark.parametrize("decode", [False, True])
def test_causal_conv(decode):
    cfg, _ = _cfgs()
    jp, tp = _params()
    d_in = jssm._dims(cfg)[0]
    x = _x(1, B, 1 if decode else 13, d_in)
    buf = _x(2, B, cfg.ssm_conv - 1, d_in) if decode else None
    want = jssm._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"],
                             prepend=None if buf is None else jnp.asarray(buf))
    got = tssm._causal_conv(torch.from_numpy(x), tp.conv_w, tp.conv_b,
                            prepend=None if buf is None
                            else torch.from_numpy(buf))
    _close(got, want, "causal conv")


@pytest.mark.parametrize("masked", [False, True])
def test_selective_terms(masked):
    cfg, tcfg = _cfgs()
    jp, tp = _params()
    x = _x(3, B, 8, jssm._dims(cfg)[0])
    mask = (np.arange(8) < 5).astype(np.float32) if masked else None
    want = jssm._selective_terms(jp, cfg, jnp.asarray(x),
                                 mask=None if mask is None
                                 else jnp.asarray(mask))
    got = tssm._selective_terms(tp, tcfg, torch.from_numpy(x),
                                mask=None if mask is None
                                else torch.from_numpy(mask))
    for g, w, what in zip(got, want, ("decay", "drive", "C")):
        _close(g, w, what)
    if masked:   # padded steps: the identity (decay 1, drive 0)
        assert (got[0][:, 5:] == 1).all() and (got[1][:, 5:] == 0).all()


@pytest.mark.parametrize("length", [1, 2, 5, 8, 13])
def test_chunk_scan(length):
    """Lengths even and odd, the reference pairing them at each level."""
    rng = np.random.default_rng(length)
    decay = rng.uniform(0.5, 1.0, (B, length, 6, 4)).astype(np.float32)
    drive = rng.normal(size=(B, length, 6, 4)).astype(np.float32)
    h0 = rng.normal(size=(B, 6, 4)).astype(np.float32)
    hs, last = jssm._chunk_scan(jnp.asarray(decay), jnp.asarray(drive),
                                jnp.asarray(h0))
    ths, tlast = tssm._chunk_scan(torch.from_numpy(decay),
                                  torch.from_numpy(drive),
                                  torch.from_numpy(h0))
    _close(ths, hs, "hs")
    _close(tlast, last, "h_last")
    # the recurrence written out, in f64
    h = h0.astype(np.float64)
    for t in range(length):
        h = decay[:, t] * h + drive[:, t]
        _close(ths[:, t], h, f"h_{t} against the recurrence")


@pytest.mark.parametrize("seq", [16, 21])
def test_ssm_apply_train_with_state(seq):
    """A whole number of chunks (16 = 2 x 8) and a padded tail (21)."""
    cfg, tcfg = _cfgs()
    jp, tp = _params()
    x = _x(4, B, seq, cfg.d_model)
    want, wst = jax.jit(lambda p, x: jssm.ssm_apply_train(
        p, cfg, x, return_state=True))(jp, jnp.asarray(x))
    got, gst = tssm.ssm_apply_train(tp, tcfg, torch.from_numpy(x),
                                    return_state=True)
    _close(got, want, "y")
    _close(gst.h, wst.h, "state h")
    np.testing.assert_array_equal(gst.conv_buf.numpy(),
                                  np.asarray(wst.conv_buf))
    none = tssm.ssm_apply_train(tp, tcfg, torch.from_numpy(x))[1]
    assert none is None


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [21, 100])
def test_card_ssm_apply_train_against_cpu(seq):
    """The chunked layer on the card against the port on the CPU, the same
    f32 weights: several chunks of 8 carried into each other and a padded
    tail, the output and the state (its conv buffer an f32 product of the
    card's own) within 1e-4 x scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg, tcfg = _cfgs()
    _, tp = _params()
    gp = _params()[1].cuda()
    x = torch.from_numpy(_x(4, B, seq, cfg.d_model))
    want, wst = tssm.ssm_apply_train(tp, tcfg, x, return_state=True)
    got, gst = tssm.ssm_apply_train(gp, tcfg, x.cuda(), return_state=True)
    _close(got.cpu(), want, f"y on the card, S={seq}")
    _close(gst.h.cpu(), wst.h, f"state h on the card, S={seq}")
    _close(gst.conv_buf.cpu(), wst.conv_buf,
           f"conv_buf on the card, S={seq}")


def test_ssm_apply_decode():
    cfg, tcfg = _cfgs()
    jp, tp = _params()
    x1 = _x(5, B, 1, cfg.d_model)
    h, buf = _state(6, cfg)
    want, wst = jssm.ssm_apply_decode(
        jp, cfg, jnp.asarray(x1),
        jssm.SSMState(h=jnp.asarray(h), conv_buf=jnp.asarray(buf)))
    got, gst = tssm.ssm_apply_decode(
        tp, tcfg, torch.from_numpy(x1),
        tssm.SSMState(h=torch.from_numpy(h), conv_buf=torch.from_numpy(buf)))
    _close(got, want, "y")
    _close(gst.h, wst.h, "state h")
    np.testing.assert_array_equal(gst.conv_buf.numpy(),
                                  np.asarray(wst.conv_buf))


def test_init_ssm_state():
    cfg, tcfg = _cfgs()
    want = jssm.init_ssm_state(cfg, B)
    got = tssm.init_ssm_state(tcfg, B, "cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert not g.any()


@pytest.mark.parametrize("n0", [8, 13])
def test_teacher_forcing_one_layer(n0):
    """Prefill n0 tokens for the state, then decode 4 tokens one at a time:
    each output as the full sequence's, within 1e-4 x max(max|y|, 1)."""
    _, tcfg = _cfgs()
    _, tp = _params()
    x = torch.from_numpy(_x(7, B, n0 + 4, tcfg.d_model))
    full, _ = tssm.ssm_apply_train(tp, tcfg, x)
    _, state = tssm.ssm_apply_train(tp, tcfg, x[:, :n0], return_state=True)
    for i in range(n0, n0 + 4):
        y, state = tssm.ssm_apply_decode(tp, tcfg, x[:, i: i + 1], state)
        _close(y, full[:, i: i + 1], f"decode step at {i}")


def _tt(a) -> torch.Tensor:
    """A reference array as a torch tensor; bfloat16 as its 16-bit words."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def test_bf16_conv_rounds_each_tap():
    """In bf16 each tap's product and running sum round to bf16, as the
    reference's (run op by op): bitwise."""
    cfg = dataclasses.replace(_cfgs()[0], dtype="bfloat16")
    jp = jssm.ssm_init(jax.random.key(1), cfg)
    d_in = jssm._dims(cfg)[0]
    x = jnp.asarray(_x(8, B, 9, d_in), jnp.bfloat16)
    b = jnp.asarray(_x(9, d_in, scale=0.1), jnp.bfloat16)
    with jax.disable_jit():
        want = jssm._causal_conv(x, jp["conv_w"], b)
    got = tssm._causal_conv(_tt(x), _tt(jp["conv_w"]), _tt(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def _share(got, want) -> float:
    """The share of elements of ``got`` (rounded to bf16) that differ."""
    g = got.to(torch.bfloat16).float().numpy()
    return float((g != np.asarray(want).astype(np.float32)).mean())


@pytest.mark.parametrize("port_dtype", ["bfloat16", "float32"])
def test_bf16_layer(port_dtype):
    """Prefill 21 tokens (a padded tail) and one decode step from the
    reference's state, the same bf16 inputs on both sides: at most SHARE
    of each output's elements differ; with ``port_dtype="float32"`` (the
    control) the prefill output breaks that bound."""
    cfg = dataclasses.replace(_cfgs()[0], dtype="bfloat16", d_model=96)
    jp = jssm.ssm_init(jax.random.key(0), cfg)
    jp["conv_b"] = jnp.asarray(_x(10, *jp["conv_b"].shape, scale=0.1),
                               jnp.bfloat16)
    tdt = getattr(torch, port_dtype)
    tcfg = dataclasses.replace(cfg, dtype=port_dtype)
    tp = ParamTree(**{k: _tt(v).to(tdt if v.dtype.name == "bfloat16"
                                   else torch.float32)
                      for k, v in jp.items()})
    x = jnp.asarray(_x(11, B, 21, 96), jnp.bfloat16)
    x1 = jnp.asarray(_x(12, B, 1, 96), jnp.bfloat16)
    with jax.disable_jit():
        want, wstate = jssm.ssm_apply_train(jp, cfg, x, return_state=True)
        want1, _ = jssm.ssm_apply_decode(jp, cfg, x1, wstate)
    got, _ = tssm.ssm_apply_train(tp, tcfg, _tt(x).to(tdt))
    got1, _ = tssm.ssm_apply_decode(tp, tcfg, _tt(x1).to(tdt),
                                    tssm.SSMState(*map(_tt, wstate)))
    if port_dtype == "float32":
        assert _share(got, want) > SHARE
    else:
        assert got.dtype == torch.bfloat16 and got1.dtype == torch.bfloat16
        assert _share(got, want) <= SHARE
        assert _share(got1, want1) <= SHARE

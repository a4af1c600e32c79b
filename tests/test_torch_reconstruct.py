"""The port's reconstruction against the JAX reference.

Pieces and symbols come from the reference's ``symed_encode`` on the
``conftest`` streams (and from random draws); both packages reconstruct
from the same numpy inputs.  Integers must be exactly equal, floats bitwise:
the port writes out the reference's compiled prefix-sum order.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_stream

from repro.core import reconstruct as jrec
from repro.core.symed import SymEDConfig as JaxConfig
from repro.core.symed import symed_encode as jax_encode
from repro_torch.core import reconstruct as trec

PARAMS = dict(tol=0.5, alpha=0.02, scl=1.0, k_min=3, k_max=8, len_max=32,
              n_max=64, lloyd_iters=5)
KINDS = ("mixed", "sine", "walk")


def _t(a):
    return torch.from_numpy(np.array(a))


def _encoded(kind, seed, t_len=240):
    ts = make_stream(np.random.default_rng(seed), t_len, kind)
    out = jax_encode(jnp.asarray(ts), JaxConfig(**PARAMS),
                     jax.random.key(seed), reconstruct=False)
    return ts, {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("n", [1, 5, 16, 17, 32, 33, 100, 257, 600, 2049])
def test_cumsum_order_bitwise(n):
    x = np.random.default_rng(n).normal(size=(3, n)).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(jnp.cumsum, axis=-1))(x))
    np.testing.assert_array_equal(trec._cumsum32(_t(x)).numpy(), want)


@pytest.mark.parametrize("kind,seed", [(k, s) for s, k in enumerate(KINDS)])
def test_reconstruct_from_pieces_and_symbols(kind, seed):
    ts, out = _encoded(kind, seed)
    t_len = ts.shape[0]
    want_p = jrec.reconstruct_from_pieces(
        out["pieces_len"], out["pieces_inc"], out["n_pieces"], ts[0], t_len)
    got_p = trec.reconstruct_from_pieces(
        _t(out["pieces_len"]), _t(out["pieces_inc"]), _t(out["n_pieces"]),
        _t(ts[0]), t_len)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    want_s = jrec.reconstruct_from_symbols(
        out["symbols"], out["centers"], out["n_pieces"], ts[0], t_len)
    got_s = trec.reconstruct_from_symbols(
        _t(out["symbols"]), _t(out["centers"]), _t(out["n_pieces"]),
        _t(ts[0]), t_len)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # a total length past the chain's end holds the final endpoint
    longer = trec.reconstruct_from_pieces(
        _t(out["pieces_len"]), _t(out["pieces_inc"]), _t(out["n_pieces"]),
        _t(ts[0]), t_len + 37)
    np.testing.assert_array_equal(
        longer.numpy(), np.asarray(jrec.reconstruct_from_pieces(
            out["pieces_len"], out["pieces_inc"], out["n_pieces"], ts[0],
            t_len + 37)))


def test_inverse_digitization_and_quantize():
    _, out = _encoded("mixed", 7)
    rep_j = jrec.inverse_digitization(out["symbols"], out["centers"])
    rep_t = trec.inverse_digitization(_t(out["symbols"]), _t(out["centers"]))
    np.testing.assert_array_equal(rep_t.numpy(), np.asarray(rep_j))
    live = np.arange(PARAMS["n_max"]) < out["n_pieces"]
    np.testing.assert_array_equal(
        trec.quantize_lengths(rep_t[:, 0], _t(live)).numpy(),
        np.asarray(jrec.quantize_lengths(rep_j[:, 0], live)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_lengths_random_exact(seed):
    """Fractional lengths, sub-unit ones included, with ragged masks: the
    integers equal the reference's and keep the carried total."""
    rng = np.random.default_rng(seed)
    lengths = (rng.gamma(1.5, 6.0, (8, 300)) * (rng.random((8, 300)) > 0.1)
               ).astype(np.float32)
    mask = np.arange(300)[None, :] < rng.integers(0, 301, (8, 1))
    want = np.asarray(jax.vmap(jrec.quantize_lengths)(lengths, mask))
    got = trec.quantize_lengths(_t(lengths), _t(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    for case, expect in (([0.4, 2.6, 0.4, 2.6], [1, 2, 1, 2]),
                         ([0.1] * 10, [1] * 10)):
        arr = torch.tensor(case, dtype=torch.float32)
        q = trec.quantize_lengths(arr, torch.ones(len(case), dtype=torch.bool))
        assert q.tolist() == expect


def test_batched_reconstruction_equals_reference_vmap():
    """A batch of sessions at once (the monitor's shape) against the
    reference's vmap, and against the port one session at a time."""
    encs = [_encoded(k, 10 + i) for i, k in enumerate(KINDS * 2)]
    t_len = encs[0][0].shape[0]
    stack = {k: np.stack([o[k] for _, o in encs]) for k in encs[0][1]}
    t0 = np.array([ts[0] for ts, _ in encs], np.float32)
    want = jax.vmap(lambda l, i, n, t: jrec.reconstruct_from_pieces(
        l, i, n, t, t_len))(stack["pieces_len"], stack["pieces_inc"],
                            stack["n_pieces"], t0)
    got = trec.reconstruct_from_pieces(
        _t(stack["pieces_len"]), _t(stack["pieces_inc"]),
        _t(stack["n_pieces"]), _t(t0), t_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_s = jax.vmap(lambda l, c, n, t: jrec.reconstruct_from_symbols(
        l, c, n, t, t_len))(stack["symbols"], stack["centers"],
                            stack["n_pieces"], t0)
    got_s = trec.reconstruct_from_symbols(
        _t(stack["symbols"]), _t(stack["centers"]), _t(stack["n_pieces"]),
        _t(t0), t_len)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    for i in range(len(encs)):
        one = trec.reconstruct_from_pieces(
            _t(stack["pieces_len"][i]), _t(stack["pieces_inc"][i]),
            _t(stack["n_pieces"][i]), _t(t0[i]), t_len)
        np.testing.assert_array_equal(one.numpy(), got[i].numpy())


# --------------------------------------------------------------- symed


from repro.core import symed as js  # noqa: E402
from repro.data.synthetic import make_fleet  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import symed as ts_  # noqa: E402

CFG, JCFG = ts_.SymEDConfig(**PARAMS), JaxConfig(**PARAMS)
SCORES = ("re_pieces", "re_symbols")


def _key(seed):
    key = jax.random.key(seed)
    return key, prng.as_key(jax.random.key_data(key))


def _assert_outputs(want, got, ctx):
    """Integers exact, every float bitwise but the DTW scores (1e-5)."""
    assert set(want) == set(got), ctx
    for name in want:
        w, g = np.asarray(want[name]), got[name].numpy()
        assert g.dtype == w.dtype, f"{ctx}: {name} {g.dtype} {w.dtype}"
        if name in SCORES:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{ctx}: {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{ctx}: {name}")


def _assert_bitwise(a, b, ctx):
    assert set(a) == set(b), ctx
    for name in a:
        np.testing.assert_array_equal(a[name].numpy(), b[name].numpy(),
                                      err_msg=f"{ctx}: {name}")


def _encode_cpu(ts, tkey):
    """The port's own one-shot encode of ``ts``, on the CPU."""
    return ts_.symed_encode(torch.from_numpy(ts), CFG, tkey, device="cpu")


@pytest.mark.parametrize("kind,seed", [(k, s) for s, k in enumerate(KINDS)])
def test_symed_encode_reconstruct(kind, seed):
    ts = make_stream(np.random.default_rng(seed), 240, kind)
    jkey, tkey = _key(seed)
    want = js.symed_encode(jnp.asarray(ts), JCFG, jkey)
    got = ts_.symed_encode(torch.from_numpy(ts), CFG, tkey, device="cpu")
    _assert_outputs(want, got, f"symed_encode {kind}")
    for name in SCORES:
        assert 0.0 <= float(got[name]) < 1e10, name
    assert got["recon_pieces"].shape == got["recon_symbols"].shape == (240,)


def test_symed_encode_single_stream_rounding():
    """The streams whose last point sits between the two EWMV roundings'
    emit thresholds: the one-shot encode follows the reference's
    single-stream program there too."""
    from test_torch_core import CRAFTED, _crafted

    cfg = dict(PARAMS, alpha=0.01, len_max=512)
    for seed, kind, last in CRAFTED:
        ts = _crafted(seed, kind, last)
        jkey, tkey = _key(seed)
        want = js.symed_encode(jnp.asarray(ts), JaxConfig(**cfg), jkey)
        got = ts_.symed_encode(torch.from_numpy(ts), ts_.SymEDConfig(**cfg),
                               tkey, device="cpu")
        _assert_outputs(want, got, f"crafted {seed}")


@pytest.mark.parametrize("splits", [(240,), (2, 99, 139), (64, 64, 64, 48)])
def test_chunked_finish_equals_reference_and_one_shot(splits):
    ts = make_stream(np.random.default_rng(20), 240, "mixed")
    jkey, tkey = _key(20)
    jstate = tstate = None
    jev, tev, pos = [], [], 0
    for n in splits:
        jstate, e = js.symed_encode_chunk(jnp.asarray(ts[pos: pos + n]), JCFG,
                                          jstate)
        jev.append(e)
        tstate, e = ts_.symed_encode_chunk(torch.from_numpy(ts[pos: pos + n]),
                                           CFG, tstate, device="cpu")
        tev.append(e)
        pos += n
    want = js.symed_finish(
        {k: jnp.concatenate([e[k] for e in jev]) for k in jev[0]}, jstate,
        JCFG, jkey, jnp.asarray(ts))
    got = ts_.symed_finish({k: torch.cat([e[k] for e in tev]) for k in tev[0]},
                           tstate, CFG, tkey, torch.from_numpy(ts),
                           device="cpu")
    _assert_outputs(want, got, f"symed_finish {splits}")
    _assert_bitwise(got, _encode_cpu(ts, tkey),
                    "chunked vs one-shot")


def test_one_point_opening_window():
    """An opening window of one point yields the no-emit event of t_0, so
    the chunked encode stays step for step the one-shot encode.  (The
    reference's ``symed_encode_chunk`` returns no event there and shifts
    every later step by one: ROADMAP Queue C.)"""
    ts = make_stream(np.random.default_rng(21), 120, "walk")
    _, tkey = _key(21)
    state, first = ts_.symed_encode_chunk(torch.from_numpy(ts[:1]), CFG,
                                          device="cpu")
    assert first["emit"].shape == (1,) and not bool(first["emit"][0])
    state, rest = ts_.symed_encode_chunk(torch.from_numpy(ts[1:]), CFG, state,
                                         device="cpu")
    got = ts_.symed_finish({k: torch.cat([first[k], rest[k]]) for k in first},
                           state, CFG, tkey, torch.from_numpy(ts),
                           device="cpu")
    _assert_bitwise(got, _encode_cpu(ts, tkey),
                    "one-point opening window")
    _, jfirst = js.symed_encode_chunk(jnp.asarray(ts[:1]), JCFG)
    assert jfirst["emit"].shape == (0,)


@pytest.mark.parametrize("kind,seed", [("walk", 30), ("sine", 31)])
def test_receive_finish_reconstruct(kind, seed):
    """The streaming receiver closed with ``reconstruct=True``: against the
    reference, and bitwise against the port's own one-shot encode."""
    ts = make_stream(np.random.default_rng(seed), 200, kind)
    jkey, tkey = _key(seed)
    jst = js.receiver_init(JCFG, jkey)
    tst = ts_.receiver_init(CFG, tkey)
    rng = np.random.default_rng(seed)
    pos = 0
    while pos < len(ts):
        n = int(rng.integers(1, 40))
        win = np.zeros(40, np.float32)
        part = ts[pos: pos + n]
        win[: len(part)] = part
        pos += n
        jst, _ = js.symed_receive_masked_chunk(jnp.asarray(win), len(part),
                                               JCFG, jst, digitize_every_k=2)
        tst, _ = ts_.symed_receive_masked_chunk(
            torch.from_numpy(win), len(part), CFG, tst, digitize_every_k=2)
    want = js.symed_receive_finish(jst, JCFG, jnp.asarray(ts), True)
    got = ts_.symed_receive_finish(tst, CFG, torch.from_numpy(ts), True)
    _assert_outputs(want, got, "symed_receive_finish")
    _assert_bitwise(got, _encode_cpu(ts, tkey),
                    "streaming vs one-shot")
    with pytest.raises(ValueError, match="requires the raw stream"):
        ts_.symed_receive_finish(tst, CFG, reconstruct=True)


@pytest.mark.parametrize("b", [3, 5])
def test_symed_batch(b):
    """A ``make_fleet`` slab: the reference's vmapped program (single-stream
    rounding up to three streams, batched above) against the port."""
    slab = make_fleet(b, 160, seed=b)
    jkey, tkey = _key(40 + b)
    want = js.symed_batch(jnp.asarray(slab), JCFG, jkey)
    got = ts_.symed_batch(torch.from_numpy(slab), CFG, tkey, device="cpu")
    _assert_outputs(want, got, f"symed_batch B={b}")
    no_rec = ts_.symed_batch(torch.from_numpy(slab), CFG, tkey,
                             reconstruct=False, device="cpu")
    for name, val in no_rec.items():
        np.testing.assert_array_equal(val.numpy(), got[name].numpy())

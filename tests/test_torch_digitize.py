"""The port's digitizer against the JAX reference, leaf by leaf.

``repro_torch.core.digitize`` on the CPU must equal ``repro.core.digitize``
bitwise on every ``DigitizerState`` leaf (the key as its key data) and on
every emitted symbol, at the ``TestDigitizeSpanTable`` shapes of
``tests/test_kernels.py`` and at the service's test size (n_max 64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_stream

from repro.core import digitize as jd
from repro.core.symed import SymEDConfig as JaxConfig
from repro.core.symed import symed_encode as jax_encode
from repro_torch.core import digitize as td
from repro_torch.core import prng
from repro_torch.core.symed import SymEDConfig, symed_encode

CFGK = dict(tol=0.5, scl=1.0, k_min=3, k_max_active=8, lloyd_iters=5)


def _table(s, n_max, k_max, seed):
    rng = np.random.default_rng(seed)
    keys = jax.random.split(jax.random.key(seed), s)
    state = jax.vmap(lambda kk: jd.digitizer_init(n_max, k_max, kk))(keys)
    port = td.digitizer_init(n_max, k_max,
                             prng.as_key(jax.random.key_data(keys)))
    lengths = rng.integers(1, 9, size=(s, n_max)).astype(np.float32)
    incs = rng.normal(0, 2, size=(s, n_max)).astype(np.float32)
    hi = rng.integers(0, n_max + 1, size=(s,)).astype(np.int32)
    return state, port, lengths, incs, hi


def _assert_state_equal(ref, port, msg):
    for name in ref._fields:
        a, b = getattr(ref, name), getattr(port, name)
        if name == "key":
            a, b = jax.random.key_data(a), prng.key_data(b)
        else:
            b = b.numpy()
        np.testing.assert_array_equal(np.asarray(a), b,
                                      err_msg=f"{msg}: {name}")


@pytest.mark.parametrize("s,n_max", [(1, 12), (4, 24), (6, 16), (4, 64)])
def test_span_table_bitwise(s, n_max):
    state, port, le, ic, hi = _table(s, n_max, 8, 31 + s)
    lo = np.zeros((s,), np.int32)
    st_j, sy_j = jd.digitize_span_table(state, *map(jnp.asarray,
                                                    (le, ic, lo, hi)), **CFGK)
    st_t, sy_t = td.digitize_span_table(port, *map(torch.from_numpy,
                                                   (le, ic, lo, hi)), **CFGK)
    _assert_state_equal(st_j, st_t, f"s={s} n_max={n_max}")
    np.testing.assert_array_equal(sy_t.numpy(), np.asarray(sy_j))


def test_split_spans_resume_bitwise():
    """[0, mid) then [mid, hi) equals one [0, hi) pass and the reference's,
    per lane, with ragged mids (the arrival-cadence property)."""
    s, n_max = 5, 20
    state, port, le, ic, hi = _table(s, n_max, 8, 99)
    rng = np.random.default_rng(7)
    mid = np.array([rng.integers(0, h + 1) for h in hi], np.int32)
    lo = np.zeros((s,), np.int32)
    t = lambda a: torch.from_numpy(np.asarray(a))
    st_one, sy_one = jd.digitize_span_table(
        state, *map(jnp.asarray, (le, ic, lo, hi)), **CFGK)
    st_a, sy_a = td.digitize_span_table(port, t(le), t(ic), t(lo), t(mid),
                                        **CFGK)
    st_b, sy_b = td.digitize_span_table(st_a, t(le), t(ic), t(mid), t(hi),
                                        **CFGK)
    _assert_state_equal(st_one, st_b, "split-resume")
    merged = np.where(np.arange(n_max)[None, :] < mid[:, None],
                      sy_a.numpy(), sy_b.numpy())
    np.testing.assert_array_equal(merged, np.asarray(sy_one))


def test_random_reinit_bitwise(monkeypatch):
    """Spread-out pieces make k grow by several centers in one step, so the
    re-initialization draws (``prng.choice``) decide the clustering: every
    leaf, the key included, still equals the reference's."""
    grew = []
    step = td.digitizer_table_step

    def counting_step(state, piece, live, **kw):
        new, sym = step(state, piece, live, **kw)
        grew.append(int((new.k - state.k.clamp_min(1))[live].max()))
        return new, sym

    monkeypatch.setattr(td, "digitizer_table_step", counting_step)
    cfg = dict(CFGK, k_max_active=16)
    s, n_max = 6, 32
    for seed in range(3):
        rng = np.random.default_rng(1000 + seed)
        keys = jax.random.split(jax.random.key(seed), s)
        state = jax.vmap(lambda kk: jd.digitizer_init(n_max, 16, kk))(keys)
        port = td.digitizer_init(n_max, 16,
                                 prng.as_key(jax.random.key_data(keys)))
        le = rng.integers(1, 30, size=(s, n_max)).astype(np.float32)
        ic = (rng.normal(0, 2, size=(s, n_max))
              * rng.choice([0.1, 1, 10], size=(s, n_max))).astype(np.float32)
        args = (le, ic, np.zeros(s, np.int32), np.full(s, n_max, np.int32))
        st_j, sy_j = jd.digitize_span_table(state, *map(jnp.asarray, args),
                                            **cfg)
        st_t, sy_t = td.digitize_span_table(port, *map(torch.from_numpy, args),
                                            **cfg)
        _assert_state_equal(st_j, st_t, f"seed {seed}")
        np.testing.assert_array_equal(sy_t.numpy(), np.asarray(sy_j))
    assert max(grew) >= 3, grew


def test_kernel_path_emits_the_same_symbols():
    """On the CPU the kernel path runs the kernel's plain version: the same
    centers, k, keys and symbols; labels differ only on masked rows."""
    s, n_max = 4, 24
    _, port, le, ic, hi = _table(s, n_max, 8, 5)
    args = [torch.from_numpy(a) for a in (le, ic, np.zeros(s, np.int32), hi)]
    st_p, sy_p = td.digitize_span_table(port, *args, **CFGK)
    st_k, sy_k = td.digitize_span_table(port, *args, use_kernel=True, **CFGK)
    assert torch.equal(sy_p, sy_k)
    for name in ("pieces", "n", "centers", "k", "key"):
        assert torch.equal(getattr(st_p, name), getattr(st_k, name)), name
    valid = torch.arange(n_max)[None, :] < st_p.n[:, None]
    assert torch.equal(st_p.labels[valid], st_k.labels[valid])


def test_per_slot_span_and_step():
    n_max = 16
    state, port, le, ic, hi = _table(1, n_max, 8, 3)
    one_j = jax.tree.map(lambda x: x[0], state)
    one_t = td.DigitizerState(*(leaf[0] for leaf in port))
    st_j, sy_j = jd.digitize_span(one_j, jnp.asarray(le[0]), jnp.asarray(ic[0]),
                                  0, 14, **CFGK)
    st_t, sy_t = td.digitize_span(one_t, torch.from_numpy(le[0]),
                                  torch.from_numpy(ic[0]), 0, 14, **CFGK)
    _assert_state_equal(st_j, st_t, "digitize_span")
    np.testing.assert_array_equal(sy_t.numpy(), np.asarray(sy_j))
    piece = np.array([3.0, -1.25], np.float32)
    a, sym_a = jd.digitizer_step(st_j, jnp.asarray(piece), **CFGK)
    b, sym_b = td.digitizer_step(st_t, torch.from_numpy(piece), **CFGK)
    _assert_state_equal(a, b, "digitizer_step")
    assert int(sym_a) == int(sym_b)


def test_scale_coords_and_cluster_variance():
    """Against the reference as the service runs it: compiled (its eager
    op-by-op form fuses no multiply-add and rounds differently)."""
    rng = np.random.default_rng(12)
    s, n, k = 5, 64, 8
    pieces = np.stack([rng.integers(1, 9, (s, n)), rng.normal(0, 2, (s, n))],
                      -1).astype(np.float32)
    mask = np.arange(n)[None, :] < rng.integers(1, n + 1, (s, 1))
    sc_j, co_j = jax.jit(jax.vmap(
        lambda p, m: jd.scale_coords(p, m, jnp.float32(1.0))))(pieces, mask)
    sc_t, co_t = td.scale_coords(torch.from_numpy(pieces),
                                 torch.from_numpy(mask), 1.0)
    np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))
    np.testing.assert_array_equal(co_t.numpy(), np.asarray(co_j))
    centers = rng.normal(size=(s, k, 2)).astype(np.float32)
    labels = rng.integers(0, k, (s, n)).astype(np.int32)
    kk = rng.integers(1, k + 1, s).astype(np.int32)
    v_j = jax.jit(jax.vmap(jd.max_cluster_variance))(co_j, mask, centers,
                                                    labels, kk)
    v_t = td.max_cluster_variance(co_t, torch.from_numpy(mask),
                                  *map(torch.from_numpy, (centers, labels, kk)))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


@pytest.mark.parametrize("kind,seed", [("mixed", 0), ("walk", 1),
                                       ("sine", 2)])
def test_symed_encode_bitwise(kind, seed):
    params = dict(tol=0.5, alpha=0.02, scl=1.0, k_min=3, k_max=8,
                  len_max=32, n_max=64, lloyd_iters=5)
    ts = make_stream(np.random.default_rng(seed), 160, kind)
    key = jax.random.key(seed)
    a = jax_encode(jnp.asarray(ts), JaxConfig(**params), key,
                   reconstruct=False)
    b = symed_encode(torch.from_numpy(ts), SymEDConfig(**params),
                     prng.as_key(jax.random.key_data(key)))
    assert set(a) == set(b)
    for name in a:
        np.testing.assert_array_equal(b[name].numpy(), np.asarray(a[name]),
                                      err_msg=name)

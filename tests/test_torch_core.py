"""The port's sender, normalization and wire against the JAX reference.

Same inputs (numpy, from a seed) through both packages; integer and
elementwise float outputs must be bitwise equal, codec bytes identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_stream

from repro.core import compress as jc
from repro.core import normalize as jn
from repro.core import receiver as jr
from repro.data.synthetic import make_fleet as jax_make_fleet
from repro_torch.core import compress as tc
from repro_torch.core import metrics as tm
from repro_torch.core import normalize as tn
from repro_torch.core import receiver as tr
from repro_torch.data.synthetic import make_fleet

KINDS = ("mixed", "sine", "walk")
SENDER = dict(tol=0.5, len_max=512, alpha=0.01)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(_np(a), _np(b), err_msg=msg)


def test_make_fleet_is_the_same_slab():
    for n, t, seed in ((5, 100, 0), (13, 64, 3), (7, 33, 11)):
        _eq(make_fleet(n, t, seed=seed), jax_make_fleet(n, t, seed=seed))


class TestNormalize:
    @pytest.mark.parametrize("alpha", [0.01, 0.02, 0.2])
    def test_ewm_scan_bitwise(self, alpha):
        ts = make_fleet(10, 300, seed=1)
        m1, v1 = jn.ewm_scan(jnp.asarray(ts), alpha)
        m2, v2 = tn.ewm_scan(torch.from_numpy(ts), alpha)
        _eq(m1, m2, "means")
        _eq(v1, v2, "vars")

    def test_ewm_step_bitwise(self):
        rng = np.random.default_rng(0)
        t, m, v = (rng.normal(size=2000).astype(np.float32) for _ in range(3))
        v = np.abs(v)
        a = jax.jit(lambda s, t: jn.ewm_step(s, t, 0.01))(
            jn.EwmState(jnp.asarray(m), jnp.asarray(v)), jnp.asarray(t))
        b = tn.ewm_step(tn.EwmState(torch.from_numpy(m), torch.from_numpy(v)),
                        torch.from_numpy(t), 0.01)
        _eq(a.mean, b.mean)
        _eq(a.var, b.var)

    def test_standardize(self):
        rng = np.random.default_rng(1)
        x, m = (rng.normal(size=500).astype(np.float32) for _ in range(2))
        v = rng.random(500).astype(np.float32) + 0.1
        np.testing.assert_allclose(
            _np(tn.standardize(*(torch.from_numpy(a) for a in (x, m, v)))),
            np.asarray(jn.standardize(x, m, v)), rtol=1e-6, atol=1e-6)


def _state_leaves(state):
    return dict(zip(("mean", "var", "seg_start", "last", "npts", "s0", "s1",
                     "s2"), jax.tree.leaves(tuple(state))))


class TestCompress:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_compress_stream_bitwise(self, seed):
        """The ``make_stream`` kinds as one slab (the batched sender the
        service runs): every output and the final carry bitwise."""
        rng = np.random.default_rng(seed)
        ts = np.stack([make_stream(rng, 600, kind) for kind in KINDS])
        a = jc.compress_stream(jnp.asarray(ts), **SENDER)
        b = tc.compress_stream(torch.from_numpy(ts), **SENDER)
        for name in ("emit", "endpoint", "length", "inc", "n_pieces"):
            _eq(a[name], b[name], name)
        want, got = _state_leaves(a["final_state"]), _state_leaves(
            b["final_state"])
        for name in want:
            _eq(want[name], got[name], f"final_state.{name}")
        for x, y in zip(a["tail"], b["tail"]):
            _eq(x, y, "tail")

    @pytest.mark.parametrize("kind", KINDS)
    def test_unbatched_reference_rounds_ewmv_differently(self, kind):
        """ROADMAP Queue C: the reference's compiled program for a single
        stream (rank-1 ``ts``, traced ``alpha``) fuses the EWMV update as
        ``fma(a, d^2, (1-a) v)``, its batched programs as ``fma(1-a, v,
        a d^2)``; the port computes the batched form everywhere (held
        bitwise by ``test_compress_stream_bitwise``).  On these streams the
        emits and every other leaf still agree bitwise, and the final EWMV
        of the single-stream program is reproduced exactly by its fusion."""
        ts = make_stream(np.random.default_rng(0), 600, kind)
        a = jc.compress_stream(jnp.asarray(ts), **SENDER)
        b = tc.compress_stream(torch.from_numpy(ts), **SENDER)
        for name in ("emit", "endpoint", "length", "inc", "n_pieces"):
            _eq(a[name], b[name], name)
        want, got = _state_leaves(a["final_state"]), _state_leaves(
            b["final_state"])
        for name in want:
            if name != "var":
                _eq(want[name], got[name], f"final_state.{name}")

        def fma(x, y, z):
            return np.float32(np.float64(x) * np.float64(y) + np.float64(z))

        al = np.float32(SENDER["alpha"])
        be = np.float32(1.0 - np.float32(SENDER["alpha"]))
        mean, var = ts[0], np.float32(1.0)
        for t in ts[1:]:
            mean = fma(al, t, be * mean)
            d = np.float32(t - mean)
            var = fma(al, np.float32(d * d), be * var)
        _eq(want["var"], var, "single-stream reference EWMV")
        assert not np.array_equal(np.asarray(want["var"]), got["var"].numpy())

    def test_compress_fleet_slab_bitwise(self):
        ts = make_fleet(40, 700, seed=5)
        for tol, len_max, alpha in ((0.5, 512, 0.01), (0.3, 64, 0.02)):
            kw = dict(tol=tol, len_max=len_max, alpha=alpha)
            a = jc.compress_stream(jnp.asarray(ts), **kw)
            b = tc.compress_stream(torch.from_numpy(ts), **kw)
            for name in ("emit", "endpoint", "length", "inc", "n_pieces"):
                _eq(a[name], b[name], f"{kw} {name}")

    def test_bridge_error_direct(self):
        rng = np.random.default_rng(2)
        for n in (2, 3, 17, 100):
            seg = rng.normal(size=(4, n)).astype(np.float32)
            np.testing.assert_allclose(
                _np(tc.bridge_error_direct(torch.from_numpy(seg))),
                np.asarray(jc.bridge_error_direct(seg)), rtol=1e-5, atol=1e-5)

    def test_pieces_on_wire(self):
        ts = make_stream(np.random.default_rng(3), 300)
        a = jc.compress_stream(jnp.asarray(ts), **SENDER)
        b = tc.compress_stream(torch.from_numpy(ts), **SENDER)
        for x, y in zip(jc.pieces_on_wire(a, 17), tc.pieces_on_wire(b, 17)):
            _eq(x, y)


class TestReceiver:
    @pytest.mark.parametrize("kind", KINDS)
    def test_compact_events_bitwise(self, kind):
        ts = make_stream(np.random.default_rng(4), 500, kind)
        a = jc.compress_stream(jnp.asarray(ts), **SENDER)
        b = tc.compress_stream(torch.from_numpy(ts), **SENDER)
        for n_max in (8, 64):
            wa = jr.compact_events(a, n_max=n_max, t0=jnp.asarray(ts[0]))
            wb = tr.compact_events(b, n_max=n_max, t0=torch.tensor(ts[0]))
            for name in ("endpoints", "steps", "lengths", "incs", "n_pieces"):
                _eq(wa[name], wb[name], f"n_max={n_max} {name}")

    def test_compact_chunk_and_tail(self):
        """Chunk-by-chunk scatter into a table of slots, capacity overflow
        included, then the tail flush."""
        rng = np.random.default_rng(5)
        s, n_max, c = 3, 6, 10
        e_j = np.zeros((s, n_max), np.float32)
        st_j = np.zeros((s, n_max), np.int32)
        n_j = np.zeros((s,), np.int32)
        e_t, st_t, n_t = map(torch.from_numpy, (e_j, st_j, n_j))
        for w in range(4):
            emit = rng.random((s, c)) < 0.3
            ends = np.where(emit, rng.normal(size=(s, c)), 0).astype(np.float32)
            idx = (w * c + np.arange(c, dtype=np.int32))[None].repeat(s, 0)
            e_j, st_j, n_j = jax.vmap(jr.compact_chunk)(e_j, st_j, n_j, emit,
                                                        ends, idx)
            e_t, st_t, n_t = tr.compact_chunk(
                e_t, st_t, n_t, *map(torch.from_numpy, (emit, ends, idx)))
            _eq(e_j, e_t)
            _eq(st_j, st_t)
            _eq(n_j, n_t)
        tail = dict(emit=np.array([True, False, True]),
                    endpoint=np.array([1.5, 0, -2], np.float32),
                    length=np.array([3, 0, 2], np.int32),
                    inc=np.array([0.5, 0, 1], np.float32))
        t_len = np.array([40, 40, 41], np.int32)
        a = jax.vmap(jr.append_tail)(
            e_j, st_j, n_j, jc.PieceEvent(**tail), t_len)
        b = tr.append_tail(e_t, st_t, n_t, tc.PieceEvent(
            **{k: torch.from_numpy(v) for k, v in tail.items()}),
            torch.from_numpy(t_len))
        for x, y in zip(a, b):
            _eq(x, y)
        t0 = np.array([0.25, -1, 3], np.float32)
        for x, y in zip(jax.vmap(jr.pieces_from_wire)(*a, t0),
                        tr.pieces_from_wire(*b, torch.from_numpy(t0))):
            _eq(x, y)

    def test_codecs_byte_equal(self):
        rng = np.random.default_rng(6)
        labels = rng.integers(0, 300, 37).astype(np.int32)
        ends = rng.normal(size=37).astype(np.float32)
        steps = rng.integers(0, 2**31, 37).astype(np.int64)
        buf = tr.pack_delta_frame(labels, ends)
        assert buf == jr.pack_delta_frame(labels, ends)
        assert len(buf) == float(tr.delta_frame_bytes(torch.tensor(37)))
        for x, y in zip(tr.unpack_delta_frame(buf), jr.unpack_delta_frame(buf)):
            _eq(x, y)
        buf = tr.pack_piece_tuples(ends, steps)
        assert buf == jr.pack_piece_tuples(ends, steps)
        assert len(buf) == tr.PIECE_TUPLE_BYTES * 37
        for x, y in zip(tr.unpack_piece_tuples(buf, 37),
                        jr.unpack_piece_tuples(buf, 37)):
            _eq(x, y)
        assert (tr.DELTA_FRAME_HEADER_BYTES, tr.DELTA_SYMBOL_BYTES) == (
            jr.DELTA_FRAME_HEADER_BYTES, jr.DELTA_SYMBOL_BYTES)

    def test_rates(self):
        from repro.core import metrics as jm

        n = np.array([3, 17, 250], np.int32)
        t = np.array([97, 1000, 4001], np.int32)
        _eq(jm.compression_rate_symed(jnp.asarray(n), jnp.asarray(t)),
            tm.compression_rate_symed(torch.from_numpy(n), torch.from_numpy(t)))
        _eq(jm.drr(jnp.asarray(n), jnp.asarray(t)),
            tm.drr(torch.from_numpy(n), torch.from_numpy(t)))

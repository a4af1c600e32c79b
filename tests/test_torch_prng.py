"""``repro_torch.core.prng`` against ``jax.random`` (threefry2x32), bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

SEEDS = [0, 1, 2, 7, 42, 1234, 99991, 2**20 + 3, 2**31 - 1]


def _kd(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    k = jax.random.key(seed)
    kt = prng.key(seed)
    np.testing.assert_array_equal(prng.key_data(kt), _kd(k))
    for num in (2, 3, 8):
        np.testing.assert_array_equal(
            prng.key_data(prng.split(kt, num)), _kd(jax.random.split(k, num)))
    for data in (0, 1, 5, 1000, 2**31 - 1):
        np.testing.assert_array_equal(
            prng.key_data(prng.fold_in(kt, data)),
            _kd(jax.random.fold_in(k, data)))


def test_batched_split_and_chains():
    """Split per lane of a key table (the digitizer's use), and chains of
    fold_in -> split (the service's session keys), over many seeds."""
    keys = jax.random.split(jax.random.key(5), 64)
    kt = prng.as_key(_kd(keys))
    np.testing.assert_array_equal(prng.key_data(prng.split(kt)),
                                  _kd(jax.vmap(jax.random.split)(keys)))
    base, base_t = jax.random.key(11), prng.key(11)
    for serial in range(1, 40):
        a = jax.random.split(jax.random.fold_in(base, serial))[1]
        b = prng.split(prng.fold_in(base_t, serial))[1]
        np.testing.assert_array_equal(prng.key_data(b), _kd(a))


@pytest.mark.parametrize("seed", SEEDS[:5])
def test_uniform_bits(seed):
    k = jax.random.key(seed)
    kt = prng.key(seed)
    np.testing.assert_array_equal(
        prng.uniform(kt, 257).numpy(), np.asarray(jax.random.uniform(k, (257,))))
    tiny = float(np.finfo(np.float32).tiny)
    np.testing.assert_array_equal(
        prng.uniform(kt, 64, tiny).numpy(),
        np.asarray(jax.random.uniform(k, (64,), minval=tiny, maxval=1.0)))


@pytest.mark.parametrize("n,k_cap", [(16, 8), (64, 8), (48, 48)])
def test_choice_without_replacement(n, k_cap):
    """``choice(replace=False, p)`` indices equal, including masks with fewer
    valid entries than ``k_cap``: the ``-inf`` ties of zero-probability
    entries go to the lower index as ``lax.top_k`` breaks them."""
    rng = np.random.default_rng(n + k_cap)
    for trial in range(40):
        n_valid = int(rng.integers(1, n + 1))
        mask = np.arange(n) < n_valid
        p = (mask.astype(np.float32) / np.float32(max(mask.sum(), 1)))
        key = jax.random.fold_in(jax.random.key(trial), n)
        want = np.asarray(jax.random.choice(key, n, shape=(k_cap,),
                                            replace=False, p=jnp.asarray(p)))
        got = prng.choice(prng.as_key(_kd(key)), n, k_cap, torch.from_numpy(p))
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"trial {trial} valid {n_valid}")


def test_batched_choice_matches_vmap():
    rng = np.random.default_rng(3)
    s, n, k_cap = 6, 32, 8
    keys = jax.random.split(jax.random.key(17), s)
    n_valid = rng.integers(1, n + 1, s)
    mask = np.arange(n)[None, :] < n_valid[:, None]
    p = (mask.astype(np.float32)
         / np.maximum(mask.sum(1, keepdims=True), 1).astype(np.float32))
    want = np.asarray(jax.vmap(
        lambda kk, pp: jax.random.choice(kk, n, shape=(k_cap,), replace=False,
                                         p=pp))(keys, jnp.asarray(p)))
    got = prng.choice(prng.as_key(_kd(keys)), n, k_cap, torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), want)


def test_choice_rejects_oversampling():
    with pytest.raises(ValueError):
        prng.choice(prng.key(0), 4, 5, torch.full((4,), 0.25))

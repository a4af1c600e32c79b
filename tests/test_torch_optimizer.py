"""The port's optimizer against the JAX reference, from identical inputs.

The same numpy parameters, gradients and step go through
``repro.train.optimizer.opt_update`` (jitted) and
``repro_torch.train.optimizer.opt_update`` for AdamW (f32 and bf16
moments) and Adafactor, several steps in a row through warmup and decay,
each package carrying its own state.  The leaves are the reference's
shapes: vectors, matrices, a stacked vector ``(n_blocks, d)`` (which
decays and factors as a matrix) and a stacked matrix.  Every parameter
and state element within ``1e-6 x max(|ref|, 1)`` (elementwise f32 code:
the one reduction is Adafactor's means); the schedule and the clipping
likewise.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch.train import optimizer as topt

OPT_REL = 1e-6
SHAPES = {"embed": (40, 16), "blocks/0/ln1": (3, 16),
          "blocks/0/wq": (3, 16, 8), "ln_f": (16,), "tail/0/b": (5,)}
STEPS = 6


def _np(x):
    x = np.asarray(x)
    return x.astype(np.float64) if x.dtype.name != "bfloat16" else \
        x.astype(np.float32).astype(np.float64)


def _t2np(t):
    return t.detach().double().numpy()


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert err.max() <= OPT_REL, f"{what}: {err.max():.3e}"


def _inputs(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(0, 0.5, s).astype(dtype) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(0, 1e-2 * (1 + i), s).astype(np.float32)
              for k, s in SHAPES.items()} for i in range(STEPS)]
    return params, grads


@pytest.mark.parametrize("name,moments", [("adamw", "float32"),
                                          ("adamw", "bfloat16"),
                                          ("adafactor", "float32")])
def test_opt_update_steps(name, moments):
    oc = dict(name=name, moments_dtype=moments, warmup_steps=2,
              total_steps=STEPS - 1, lr=1e-2)
    joc, toc = jopt.OptConfig(**oc), topt.OptConfig(**oc)
    params, grads = _inputs(0)
    keys = list(SHAPES)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jst, tst = jopt.opt_init(jp, joc), topt.opt_init(tp, toc)
    jupd = jax.jit(lambda g, o, p, s: jopt.opt_update(g, o, p, s, joc))
    for i, g in enumerate(grads):
        jp, jst = jupd({k: jnp.asarray(v) for k, v in g.items()}, jst, jp,
                       jnp.asarray(i, jnp.int32))
        tp, tst = topt.opt_update(
            {k: torch.from_numpy(v) for k, v in g.items()}, tst, tp,
            torch.tensor(i, dtype=torch.int32), toc)
        for k in keys:
            _close(_t2np(tp[k]), _np(jp[k]), f"step {i} param {k}")
        for part in tst:
            for k in keys:
                got, want = tst[part][k], jst[part][k]
                if isinstance(want, dict):
                    assert sorted(got) == sorted(want), (part, k)
                    for f in want:
                        _close(_t2np(got[f]), _np(want[f]),
                               f"step {i} {part}/{k}/{f}")
                else:
                    assert str(got.dtype).endswith(moments), got.dtype
                    _close(_t2np(got), _np(want), f"step {i} {part}/{k}")


def test_schedule_through_warmup_and_decay():
    oc = dict(lr=3e-4, warmup_steps=10, total_steps=100)
    joc, toc = jopt.OptConfig(**oc), topt.OptConfig(**oc)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        want = float(jopt._schedule(jnp.asarray(s, jnp.int32), joc))
        got = float(topt._schedule(torch.tensor(s, dtype=torch.int32), toc))
        assert got == pytest.approx(want, rel=OPT_REL, abs=0.0), s


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_clip_by_global_norm(scale):
    """Below and above the clip norm, a bf16 leaf scaled in bf16."""
    rng = np.random.default_rng(3)
    tree = {"a": (scale * rng.normal(size=(7, 5))).astype(np.float32),
            "b": (scale * rng.normal(size=(11,))).astype(np.float32)}
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    jt["c"] = jnp.asarray(scale * rng.normal(size=(4, 3)), jnp.bfloat16)
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    tt["c"] = torch.from_numpy(np.array(jt["c"]).view(np.int16)).view(
        torch.bfloat16)
    jc, jn = jax.jit(lambda t: jopt.clip_by_global_norm(t, 1.0))(jt)
    tc, tn = topt.clip_by_global_norm(tt, 1.0)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    for k in jt:
        assert tc[k].dtype == (torch.bfloat16 if k == "c" else torch.float32)
        _close(_t2np(tc[k]), _np(jc[k]), k)
    assert float(topt.global_norm(tt)) == float(tn)


def test_unknown_optimizer():
    with pytest.raises(ValueError, match="sgd"):
        topt.opt_init({"w": torch.zeros(2)}, topt.OptConfig(name="sgd"))

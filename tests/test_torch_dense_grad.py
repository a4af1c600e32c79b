"""The backward of ``layers.dense`` and ``layers.matmul_f32`` against the
JAX reference's VJPs, op by op.

``dense`` ports the reference's ``_matmul_bf16_grads`` (a ``custom_vjp``):
``dx = g wᵀ`` rounded to ``x.dtype`` and ``dw = xᵀ g`` rounded to
``w.dtype``, each from one f32-accumulated product.  ``matmul_f32``'s
gradients are those of ``dot_general(..., preferred_element_type=f32)``.
The reference runs under ``jax.disable_jit()`` (compiled, XLA's CPU
backend keeps bf16 intermediates in f32: ROADMAP C15).  In f32 the
gradients agree within ``1e-5 x max|ref|``; in bf16 each element lies
within one bf16 ulp of the reference's (the two products sum their f32
terms in different orders before the one rounding) and at least 99% are
equal.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.models import layers as tlayers

SHAPES = [((2, 7, 48), (48, 24)), ((5, 96), (96, 40))]


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _ulps(got: torch.Tensor, want) -> np.ndarray:
    """bf16 ulp distance (same-sign words; both finite)."""
    g = got.view(torch.int16).numpy().astype(np.int64)
    w = np.asarray(want).view(np.int16).astype(np.int64)
    key = lambda v: np.where(v < 0, -(v & 0x7FFF), v)
    return np.abs(key(g) - key(w))


def _inputs(xshape, wshape, xdt, wdt, seed):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=xshape), xdt)
    w = jnp.asarray(rng.normal(size=wshape) * wshape[0] ** -0.5, wdt)
    g = jnp.asarray(rng.normal(size=xshape[:-1] + wshape[1:]), xdt)
    return x, w, g


def _check(got, want, dtype, what):
    if dtype == jnp.bfloat16:
        assert got.dtype == torch.bfloat16, what
        u = _ulps(got, want)
        assert u.max() <= 1 and (u == 0).mean() >= 0.99, (what, u.max(),
                                                           (u == 0).mean())
    else:
        w = np.asarray(want, np.float64)
        err = np.abs(got.double().numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max(), (what, err)


@pytest.mark.parametrize("xshape,wshape", SHAPES)
@pytest.mark.parametrize("xdt,wdt", [(jnp.float32, jnp.float32),
                                     (jnp.bfloat16, jnp.bfloat16),
                                     (jnp.bfloat16, jnp.float32)])
def test_dense_backward(xshape, wshape, xdt, wdt):
    """``_matmul_bf16_grads``' VJP: a bf16 weight gradient from bf16
    inputs, an f32 one (rounded once) where the weight is f32."""
    x, w, g = _inputs(xshape, wshape, xdt, wdt, 0)
    with jax.disable_jit():
        y, vjp = jax.vjp(jlayers.dense, x, w)
        dx, dw = vjp(g)
    tx = _to_torch(x).requires_grad_(True)
    tw = _to_torch(w).requires_grad_(True)
    ty = tlayers.dense(tx, tw)
    ty.backward(_to_torch(g))
    assert ty.dtype == tx.dtype
    _check(ty.detach(), y, xdt, "y")
    _check(tx.grad, dx, xdt, "dx")
    assert tw.grad.dtype == tw.dtype
    _check(tw.grad, dw, wdt, "dw")


@pytest.mark.parametrize("xshape,wshape", SHAPES)
@pytest.mark.parametrize("dt", [jnp.float32, jnp.bfloat16])
def test_matmul_f32_backward(xshape, wshape, dt):
    """The unembedding's product: f32 out, each gradient an f32 product of
    the f32 cotangent rounded to its operand's dtype."""
    x, w, _ = _inputs(xshape, wshape, dt, dt, 1)
    g = jnp.asarray(np.random.default_rng(2).normal(
        size=xshape[:-1] + wshape[1:]), jnp.float32)

    def ref(a, b):
        return jax.lax.dot_general(a, b, (((a.ndim - 1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.float32)

    with jax.disable_jit():
        y, vjp = jax.vjp(ref, x, w)
        dx, dw = vjp(g)
    tx = _to_torch(x).requires_grad_(True)
    tw = _to_torch(w).requires_grad_(True)
    ty = tlayers.matmul_f32(tx, tw)
    ty.backward(_to_torch(g))
    assert ty.dtype == torch.float32
    _check(ty.detach(), y, jnp.float32, "y")
    _check(tx.grad, dx, dt, "dx")
    _check(tw.grad, dw, dt, "dw")


def test_dense_records_no_graph_when_frozen():
    """Frozen parameters and inputs: the plain product, no graph."""
    x = torch.randn(3, 8)
    w = torch.nn.Parameter(torch.randn(8, 4), requires_grad=False)
    assert tlayers.dense(x, w).grad_fn is None

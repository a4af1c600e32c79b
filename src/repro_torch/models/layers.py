"""Common model layers: norms, MLP variants, embeddings, rotary positions.

Port of ``repro.models.layers``.  Parameters live in ``ParamTree``s: an
``nn.Module`` per node of the reference's dict tree, holding its leaves as
``nn.Parameter``s under the reference's names.  They take no gradients
unless made trainable (``requires_grad_()``; the train state's are), so a
served model builds no graph.  Layers are plain functions of such a node
and tensors.

Products follow the reference's precision contract.  ``dense`` multiplies
in the model dtype with f32 accumulation and rounds once back to it (a
bf16 ``matmul`` does so on the CPU and, under cuBLAS's default settings, on
the card: PERF.md's readings found no output that the reduced-precision
reductions setting moves); its backward is the reference's
``_matmul_bf16_grads``: both gradients from f32-accumulated products,
rounded once to the input's and the weight's dtype.  ``matmul_f32`` is the
reference's ``preferred_element_type=float32`` product, f32 out, whose
gradients are f32 products rounded to the operands' dtypes; norms and
softmax run in f32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "ParamTree", "rms_norm", "mlp_apply", "mlp_init", "embed_init", "rope",
    "dense", "init_dense", "model_dtype", "matmul_f32", "normal",
]


class ParamTree(nn.Module):
    """One node of the parameter tree: tensors become ``nn.Parameter``s
    (frozen until ``requires_grad_()``), modules become children, each
    under its key."""

    def __init__(self, **children):
        super().__init__()
        for name, v in children.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(
                    name, nn.Parameter(v, requires_grad=False))
            else:
                self.add_module(name, v)

    def get(self, name: str, default=None):
        return getattr(self, name, default)


def model_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal(gen: Optional[torch.Generator], shape, std: float, dtype,
           device) -> torch.Tensor:
    """``N(0, std^2)`` drawn in f32 from ``gen`` on ``device``, then cast;
    on the ``meta`` device an empty tensor of the shape (no draw).  The
    scale is applied in place: one f32 copy of the leaf at a time (an
    expert leaf of jamba's is 12 GiB in f32)."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(std).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with (1 + scale) gain (gemma convention), f32 internals."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


class _MatmulF32(torch.autograd.Function):
    """The card's ``a @ b`` with an f32 result (``torch.mm``'s
    ``out_dtype``), with the VJP of the reference's ``dot_general(...,
    preferred_element_type=float32)``: each gradient an f32 product of the
    f32 cotangent and the other operand, rounded to its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(a.shape[:-1] + (b.shape[-1],))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        ga = (g2 @ b.float().T).to(a.dtype).reshape(a.shape)
        gb = (a.reshape(-1, a.shape[-1]).float().T @ g2).to(b.dtype)
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an f32 result from operands of one dtype: every
    product exact, the sums in f32 (``preferred_element_type=float32``).
    ``a (..., K)``, ``b (K, N)``."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return _MatmulF32.apply(a, b)
    return a.float() @ b.float()


class _DenseFn(torch.autograd.Function):
    """Port of the reference's ``_matmul_bf16_grads``: ``x @ w`` in
    ``x``'s dtype with f32 accumulation; backward ``dx = g wᵀ`` rounded to
    ``x.dtype`` and ``dw = xᵀ g`` (summed over every leading axis) rounded
    to ``w.dtype``, each from one f32-accumulated product."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x @ w.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ w.to(g.dtype).T
        x2 = x.reshape(-1, x.shape[-1])
        g2 = g.reshape(-1, g.shape[-1])
        if w.dtype == x.dtype:
            dw = x2.T @ g2
        else:  # the f32 sums rounded once to w's dtype, not to x's first
            dw = (x2.float().T @ g2.float()).to(w.dtype)
        return dx, dw


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w with f32 accumulation, output cast back to x.dtype."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        y = _DenseFn.apply(x, w)
    else:  # serving: the same product, no graph
        y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def init_dense(gen, d_in: int, d_out: int, dtype, device,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    return normal(gen, (d_in, d_out), scale, dtype, device)


# ---------------------------------------------------------------------------
# MLP: swiglu (llama/gemma/mixtral), gelu (whisper/paligemma), relu2 (nemotron)
# ---------------------------------------------------------------------------

GATED_MLP = ("swiglu", "geglu")


def mlp_init(gen, cfg, device) -> ParamTree:
    dt = model_dtype(cfg)
    d, f = cfg.d_model, cfg.d_ff
    width = 2 * f if cfg.mlp_kind in GATED_MLP else f
    return ParamTree(wi=init_dense(gen, d, width, dt, device),
                     wo_mlp=init_dense(gen, f, d, dt, device))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_activate(h: torch.Tensor, kind: str, out_dtype) -> torch.Tensor:
    """Shared nonlinearity for dense and MoE FFNs."""
    if kind in GATED_MLP:
        gate, up = torch.chunk(h, 2, dim=-1)
        act = F.silu if kind == "swiglu" else _gelu
        return act(gate.float()).to(out_dtype) * up
    if kind == "gelu":
        return _gelu(h.float()).to(out_dtype)
    if kind == "relu2":  # squared ReLU (nemotron-4)
        r = torch.clamp_min(h, 0.0)
        return (r * r).to(out_dtype)
    raise ValueError(f"unknown mlp kind {kind}")


def mlp_apply(params: ParamTree, x: torch.Tensor, kind: str) -> torch.Tensor:
    h = dense(x, params.wi)
    return dense(mlp_activate(h, kind, x.dtype), params.wo_mlp)


def sinusoid_pos(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Parameter-free sinusoidal positions (whisper-style stand-in)."""
    half = d // 2
    freq = torch.exp(-torch.arange(half, dtype=torch.float32,
                                   device=positions.device)
                     * (9.21034 / max(half - 1, 1)))
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def embed_init(gen, vocab: int, d: int, dtype, device) -> torch.Tensor:
    return normal(gen, (vocab, d), 0.02, dtype, device)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Apply RoPE.  x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq     # (..., S, half)
    cos = torch.cos(ang)[..., None, :]               # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)

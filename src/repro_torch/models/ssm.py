"""Mamba-style selective SSM block (jamba's recurrent layer).

Port of ``repro.models.ssm``.  Selective scan h_t = exp(dt_t * A) h_{t-1}
+ dt_t * (B_t x_t), y_t = C_t h_t + D x_t with input-dependent (B, C, dt)
and A = -exp(a_log).  Prefill runs the reference's two-level scan: a loop
over time chunks of ``cfg.ssm_chunk`` (the padded tail masked to the
identity step), and within a chunk the steps composed one after another
(the reference pairs them in an associative scan), with the carried state
applied after them (``a_acc * h0 + b_acc``).  Decode is the O(1)
recurrent step on a persistent (B, d_in, state) f32 state.

The depthwise causal conv is its 4 taps unrolled and added in the
reference's order, tap 0 first, each product and sum rounded to the model
dtype (``F.conv1d`` sums in its own order, and on the card may use TF32).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (
    ParamTree, dense, init_dense, model_dtype, normal,
)

__all__ = ["ssm_init", "ssm_apply_train", "SSMState", "init_ssm_state",
           "ssm_apply_decode"]


class SSMState(NamedTuple):
    h: torch.Tensor         # (B, d_in, state) f32
    conv_buf: torch.Tensor  # (B, conv-1, d_in) f32: trailing pre-conv inputs


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    dt_rank = max(cfg.d_model // 16, 1)
    return d_in, dt_rank, cfg.ssm_state


def ssm_init(gen, cfg, device) -> ParamTree:
    dt = model_dtype(cfg)
    d, (d_in, dt_rank, st) = cfg.d_model, _dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    a = torch.arange(1, st + 1, **f32)[None, :].expand(d_in, st)
    return ParamTree(
        in_proj=init_dense(gen, d, 2 * d_in, dt, device),
        conv_w=normal(gen, (cfg.ssm_conv, d_in), 0.2, dt, device),
        conv_b=torch.zeros((d_in,), dtype=dt, device=device),
        x_proj=init_dense(gen, d_in, dt_rank + 2 * st, dt, device),
        dt_proj=init_dense(gen, dt_rank, d_in, dt, device),
        dt_bias=torch.full((d_in,), -4.6, **f32),   # softplus^-1(0.01)
        a_log=torch.log(a),                           # (d_in, state) f32
        d_skip=torch.ones((d_in,), **f32),
        out_proj=init_dense(gen, d_in, d, dt, device),
    )


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x (torch's
    ``F.softplus`` returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _silu(x: torch.Tensor, dtype) -> torch.Tensor:
    """``jax.nn.silu`` of ``x`` in f32, rounded to ``dtype``."""
    return F.silu(x.float()).to(dtype)


def _causal_conv(x, w, b, prepend=None):
    """Depthwise causal conv along time.  x: (B, S, d_in); w: (K, d_in);
    ``prepend`` (B, K-1, d_in) the previous inputs (decode), else zeros."""
    k = w.shape[0]
    if prepend is None:
        pad = F.pad(x, (0, 0, k - 1, 0))
    else:
        pad = torch.cat([prepend.to(x.dtype), x], dim=1)
    n = pad.shape[1] - (k - 1)
    out = torch.zeros_like(pad[:, k - 1:])
    for i in range(k):  # K is tiny (4): unrolled taps, tap 0 first
        out = out + pad[:, i: i + n] * w[i][None, None, :]
    return out + b[None, None, :]


def _selective_terms(params, cfg, xs, mask=None):
    """xs: (B, S, d_in) post-conv activations -> decay a_t, drive b_t (B, S,
    d_in, state) f32 and C_t (B, S, state) f32.

    ``mask`` (S,) zeroes dt on padded steps (decay=1, drive=0: identity)."""
    d_in, dt_rank, st = _dims(cfg)
    proj = dense(xs, params.x_proj)
    dt_low, bmat, cmat = torch.split(proj, [dt_rank, st, st], dim=-1)
    dt_full = dense(dt_low, params.dt_proj).float()
    dt_t = _softplus(dt_full + params.dt_bias)                  # (B,S,d_in)
    if mask is not None:
        dt_t = dt_t * mask[None, :, None]
    a = -torch.exp(params.a_log)                                 # (d_in, st)
    decay = torch.exp(dt_t[..., None] * a[None, None])
    # drive[b,s,d,n] = dt[b,s,d] * x[b,s,d] * B[b,s,n]
    drive = ((dt_t * xs.float())[..., None]
             * bmat.float()[:, :, None, :])
    return decay, drive, cmat.float()


def _chunk_scan(decay, drive, h0):
    """Scan within a chunk.  decay/drive: (B, C, d_in, st); h0: (B, d_in,
    st).  The composed steps (a_acc, b_acc) one step at a time, then h0
    applied after them, as the reference does.  Returns (every h_t, the
    last)."""
    a_acc, b_acc = [decay[:, 0]], [drive[:, 0]]
    for t in range(1, decay.shape[1]):
        a_acc.append(a_acc[-1] * decay[:, t])
        b_acc.append(b_acc[-1] * decay[:, t] + drive[:, t])
    hs = torch.stack(a_acc, 1) * h0[:, None] + torch.stack(b_acc, 1)
    return hs, hs[:, -1]


def ssm_apply_train(params: ParamTree, cfg, x: torch.Tensor, *,
                    return_state: bool = False):
    """x: (B, S, d) -> (y, SSMState|None).  Chunked selective scan."""
    b, s, d = x.shape
    d_in, _, st = _dims(cfg)
    xz = dense(x, params.in_proj)
    xs_raw, z = torch.chunk(xz, 2, dim=-1)
    xs = _causal_conv(xs_raw, params.conv_w, params.conv_b)
    xs = _silu(xs, x.dtype)

    chunk = min(cfg.ssm_chunk, s)
    s_pad = (s + chunk - 1) // chunk * chunk
    if s_pad != s:
        xs = F.pad(xs, (0, 0, 0, s_pad - s))
    valid = (torch.arange(s_pad, device=x.device) < s).float()

    h = torch.zeros((b, d_in, st), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s_pad, chunk):
        x_c = xs[:, c0: c0 + chunk]
        dec_c, drv_c, c_c = _selective_terms(params, cfg, x_c,
                                             mask=valid[c0: c0 + chunk])
        hs, h = _chunk_scan(dec_c, drv_c, h)
        y = torch.einsum("bcds,bcs->bcd", hs, c_c)     # C_t . h_t
        ys.append(y + params.d_skip[None, None, :] * x_c.float())
    y = torch.cat(ys, dim=1)[:, :s].to(x.dtype)
    y = y * _silu(z, x.dtype)
    out = dense(y, params.out_proj)
    state = None
    if return_state:
        kc = cfg.ssm_conv - 1
        buf = F.pad(xs_raw.float(), (0, 0, kc, 0))[:, -kc:]
        state = SSMState(h=h, conv_buf=buf)
    return out, state


def init_ssm_state(cfg, batch: int, device) -> SSMState:
    d_in, _, st = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return SSMState(
        h=torch.zeros((batch, d_in, st), **f32),
        conv_buf=torch.zeros((batch, cfg.ssm_conv - 1, d_in), **f32),
    )


def ssm_apply_decode(params: ParamTree, cfg, x1: torch.Tensor,
                     state: SSMState):
    """One-token step.  x1: (B, 1, d) -> (out, new_state)."""
    xz = dense(x1, params.in_proj)
    xs, z = torch.chunk(xz, 2, dim=-1)                         # (B,1,d_in)
    xs_conv = _causal_conv(xs, params.conv_w, params.conv_b,
                           prepend=state.conv_buf)[:, -1:]     # newest step
    xs_act = _silu(xs_conv, x1.dtype)

    decay, drive, cmat = _selective_terms(params, cfg, xs_act)
    h = decay[:, 0] * state.h + drive[:, 0]                    # (B,d_in,st)
    y = torch.einsum("bds,bs->bd", h, cmat[:, 0])[:, None, :]
    y = y + params.d_skip[None, None, :] * xs_act.float()
    y = y.to(x1.dtype) * _silu(z, x1.dtype)

    new_buf = torch.cat([state.conv_buf[:, 1:], xs.float()], dim=1)
    return dense(y, params.out_proj), SSMState(h=h, conv_buf=new_buf)

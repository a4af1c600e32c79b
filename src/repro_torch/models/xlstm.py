"""xLSTM blocks: mLSTM (matrix memory, parallelizable) and sLSTM (scalar
memory, sequential) -- the [ssm]-family arch xlstm-125m.

Port of ``repro.models.xlstm``.  mLSTM exponential gating is *separable*:
with F_t = sum_{s<=t} logsigmoid(f_s) and g_s = i_s - F_s, the gate matrix
is D_ts = F_t + g_s (s <= t) and its row max is m_t = F_t + cummax(g)_t,
both computable in O(S) up front.  The quadratic form then chunks like
flash attention but with *fixed* per-row stabilizers (no online max
rescaling), and weights exp(g_s - M_t) <= 1 by construction.  Prefill's
state is the closed form of the recurrence (``mlstm_prefill_state``);
decode uses the O(1) recurrent form with (C, n, m) state.

sLSTM keeps per-head scalar memories with block-diagonal recurrence and is
inherently sequential: a loop over time.  Both blocks carry their own
up/down projections (``has_mlp=False`` in their LayerSpec).  Exponents are
clamped at ``_CLAMP`` as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (
    ParamTree, _gelu, dense, init_dense, model_dtype, normal,
)
from repro_torch.models.ssm import _causal_conv, _silu, _softplus

__all__ = [
    "mlstm_init", "mlstm_apply_train", "mlstm_prefill_state", "MLSTMState",
    "init_mlstm_state", "mlstm_apply_decode", "slstm_init",
    "slstm_apply_train", "SLSTMState", "init_slstm_state",
    "slstm_apply_decode",
]

_CLAMP = 80.0


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -_softplus(-x)


def _key_scale(k: torch.Tensor, hd: int) -> torch.Tensor:
    """``k * hd ** -0.5`` with the constant rounded to k's dtype first, as
    the reference's product of an array and a Python float."""
    return k * torch.tensor(hd ** -0.5, dtype=k.dtype, device=k.device)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mdims(cfg):
    d_in = 2 * cfg.d_model
    hd = d_in // cfg.n_heads
    return d_in, hd


def mlstm_init(gen, cfg, device) -> ParamTree:
    dt = model_dtype(cfg)
    d, h = cfg.d_model, cfg.n_heads
    d_in, _ = _mdims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return ParamTree(
        up=init_dense(gen, d, 2 * d_in, dt, device),
        conv_w=normal(gen, (4, d_in), 0.2, dt, device),
        conv_b=torch.zeros((d_in,), dtype=dt, device=device),
        wq=init_dense(gen, d_in, d_in, dt, device),
        wk=init_dense(gen, d_in, d_in, dt, device),
        wv=init_dense(gen, d_in, d_in, dt, device),
        wi=init_dense(gen, d_in, h, torch.float32, device, scale=0.01),
        wf=init_dense(gen, d_in, h, torch.float32, device, scale=0.01),
        bi=torch.zeros((h,), **f32),
        bf=torch.full((h,), 3.0, **f32),   # open forget gates
        down=init_dense(gen, d_in, d, dt, device),
    )


def _mlstm_qkv_gates(params, cfg, xm):
    b, s, d_in = xm.shape
    h = cfg.n_heads
    hd = d_in // h
    xc = _causal_conv(xm, params.conv_w, params.conv_b)
    xc = _silu(xc, xm.dtype)
    q = dense(xc, params.wq).reshape(b, s, h, hd)
    k = _key_scale(dense(xc, params.wk).reshape(b, s, h, hd), hd)
    v = dense(xm, params.wv).reshape(b, s, h, hd)
    xf = xm.float()
    i_pre = xf @ params.wi + params.bi                            # (b,s,h)
    f_pre = xf @ params.wf + params.bf
    return q, k, v, i_pre, f_pre


def mlstm_apply_train(params: ParamTree, cfg, x: torch.Tensor, *,
                      chunk: int = 512) -> torch.Tensor:
    b, s, _ = x.shape
    d_in, hd = _mdims(cfg)
    h = cfg.n_heads
    xz = dense(x, params.up)
    xm, z = torch.chunk(xz, 2, dim=-1)

    q, k, v, i_pre, f_pre = _mlstm_qkv_gates(params, cfg, xm)

    logf = _log_sigmoid(f_pre)                         # (b,s,h)
    f_cum = torch.cumsum(logf, dim=1)                  # F_t
    g = i_pre - f_cum                                  # g_s = i_s - F_s
    m_src = torch.cummax(g, dim=1).values              # row stabilizer source
    # m_t = F_t + M_t; normalizer floor exp(-m_t), clamped
    neg_m = torch.clamp(-(f_cum + m_src), max=_CLAMP)

    cq = min(chunk, s)
    if s % cq:
        cq = s  # non-power-of-two smoke shapes: single chunk
    dev = x.device
    # head-major views: (b, h, s, ...)
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2)
    vf = v.transpose(1, 2)
    g_h, m_h, negm_h = (t.transpose(1, 2) for t in (g, m_src, neg_m))
    outs = []
    for q0 in range(0, s, cq):
        qpos = q0 + torch.arange(cq, device=dev)
        qc, mc = qf[:, :, q0: q0 + cq], m_h[:, :, q0: q0 + cq]
        l_run = torch.zeros((b, h, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, cq, hd), dtype=torch.float32, device=dev)
        # key chunks past the query chunk are masked out whole: they add 0
        for k0 in range(0, q0 + cq, cq):
            kpos = k0 + torch.arange(cq, device=dev)
            sc = torch.einsum("bhqd,bhsd->bhqs", qc, kf[:, :, k0: k0 + cq])
            logw = g_h[:, :, None, k0: k0 + cq] - mc[..., None]
            mask = kpos[None, :] <= qpos[:, None]
            wgt = torch.where(mask, torch.exp(torch.clamp(logw, max=0.0)),
                              torch.zeros_like(logw))
            sc = sc * wgt
            l_run = l_run + sc.sum(-1)
            vc = vf[:, :, k0: k0 + cq]
            acc = acc + torch.einsum("bhqs,bhsd->bhqd",
                                     sc.to(vc.dtype).float(), vc.float())
        norm = torch.maximum(l_run.abs(),
                             torch.exp(negm_h[:, :, q0: q0 + cq]))
        outs.append(acc / norm[..., None])             # (b, h, cq, hd)
    y = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s, d_in)
    y = y.to(x.dtype) * _silu(z, x.dtype)
    return dense(y, params.down)


class MLSTMState(NamedTuple):
    c: torch.Tensor         # (B, H, hd, hd) f32 matrix memory
    n: torch.Tensor         # (B, H, hd)
    m: torch.Tensor         # (B, H)
    conv_buf: torch.Tensor  # (B, 3, d_in)


def mlstm_prefill_state(params: ParamTree, cfg, x: torch.Tensor
                        ) -> MLSTMState:
    """Closed-form recurrent state after a full prompt (separable gating):

    C_T = sum_s exp(F_T - F_s + i_s - m_T) v_s k_s^T,   m_T = F_T + M_T.
    """
    xz = dense(x, params.up)
    xm, _ = torch.chunk(xz, 2, dim=-1)
    _, k, v, i_pre, f_pre = _mlstm_qkv_gates(params, cfg, xm)
    logf = _log_sigmoid(f_pre)
    f_cum = torch.cumsum(logf, dim=1)
    g = i_pre - f_cum                            # (b, s, h)
    g_max = g.amax(dim=1)
    m_t = f_cum[:, -1] + g_max                   # (b, h)
    # weight_s = exp(F_T + g_s - m_T) = exp(g_s - max g) <= 1
    w = torch.exp(g - g_max[:, None])
    kf, vf = k.float(), v.float()
    c = torch.einsum("bshv,bshk->bhvk", w[..., None] * vf, kf)
    n = torch.einsum("bsh,bshk->bhk", w, kf)
    buf = F.pad(xm.float(), (0, 0, 3, 0))[:, -3:]
    return MLSTMState(c=c, n=n, m=m_t, conv_buf=buf)


def init_mlstm_state(cfg, batch: int, device) -> MLSTMState:
    d_in, hd = _mdims(cfg)
    h = cfg.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(
        c=torch.zeros((batch, h, hd, hd), **f32),
        n=torch.zeros((batch, h, hd), **f32),
        m=torch.zeros((batch, h), **f32),
        conv_buf=torch.zeros((batch, 3, d_in), **f32),
    )


def mlstm_apply_decode(params: ParamTree, cfg, x1: torch.Tensor,
                       state: MLSTMState):
    b = x1.shape[0]
    d_in, hd = _mdims(cfg)
    h = cfg.n_heads
    xz = dense(x1, params.up)
    xm, z = torch.chunk(xz, 2, dim=-1)

    xc = _causal_conv(xm, params.conv_w, params.conv_b,
                      prepend=state.conv_buf)
    xc = _silu(xc[:, -1:], x1.dtype)
    q = dense(xc, params.wq).reshape(b, h, hd)
    k = _key_scale(dense(xc, params.wk).reshape(b, h, hd), hd)
    v = dense(xm, params.wv).reshape(b, h, hd)
    xf = xm[:, 0].float()
    i_pre = xf @ params.wi + params.bi
    f_pre = xf @ params.wf + params.bf

    logf = _log_sigmoid(f_pre)
    m_new = torch.maximum(logf + state.m, i_pre)
    f_eff = torch.exp(torch.clamp(logf + state.m - m_new, max=_CLAMP))
    i_eff = torch.exp(torch.clamp(i_pre - m_new, max=_CLAMP))

    qf, kf, vf = q.float(), k.float(), v.float()
    c = f_eff[..., None, None] * state.c + i_eff[..., None, None] * (
        vf[..., :, None] * kf[..., None, :])
    n = f_eff[..., None] * state.n + i_eff[..., None] * kf
    num = torch.einsum("bhvk,bhk->bhv", c, qf)
    den = torch.maximum(
        torch.einsum("bhk,bhk->bh", n, qf).abs(),
        torch.exp(torch.clamp(-m_new, max=_CLAMP)),
    )
    hcell = (num / den[..., None]).reshape(b, 1, d_in).to(x1.dtype)
    y = hcell * _silu(z, x1.dtype)
    new_state = MLSTMState(
        c=c, n=n, m=m_new,
        conv_buf=torch.cat([state.conv_buf[:, 1:], xm.float()], dim=1),
    )
    return dense(y, params.down), new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _sdims(cfg):
    hd = cfg.d_model // cfg.n_heads
    pf = (4 * cfg.d_model + 2) // 3  # xLSTM projection factor 4/3
    return hd, pf


def slstm_init(gen, cfg, device) -> ParamTree:
    dt = model_dtype(cfg)
    d, h = cfg.d_model, cfg.n_heads
    hd, pf = _sdims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return ParamTree(
        wx=init_dense(gen, d, 4 * d, dt, device),
        r=normal(gen, (h, hd, 4 * hd), hd ** -0.5, dt, device),
        b=torch.cat([
            torch.zeros((d,), **f32),           # i
            torch.full((d,), 3.0, **f32),       # f (open)
            torch.zeros((2 * d,), **f32),       # z, o
        ]),
        ffn_up=init_dense(gen, d, 2 * pf, dt, device),
        ffn_down=init_dense(gen, pf, d, dt, device),
    )


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, hd)
    n: torch.Tensor  # (B, H, hd)
    m: torch.Tensor  # (B, H, hd)
    h: torch.Tensor  # (B, H, hd)


def init_slstm_state(cfg, batch: int, device) -> SLSTMState:
    hd, _ = _sdims(cfg)
    z = torch.zeros((batch, cfg.n_heads, hd), dtype=torch.float32,
                    device=device)
    return SLSTMState(c=z, n=z, m=z, h=z)


def _slstm_cell(params, cfg, xg, state: SLSTMState) -> SLSTMState:
    """One time step.  xg: (B, 4*d) f32 pre-activations from x (incl. bias)."""
    b = xg.shape[0]
    h, (hd, _) = cfg.n_heads, _sdims(cfg)
    rec = torch.einsum("bhk,hkg->bhg", state.h, params.r.float())
    pre = xg.reshape(b, 4, h, hd).transpose(1, 2).reshape(b, h, 4 * hd) + rec
    i_p, f_p, z_p, o_p = torch.split(pre, hd, dim=-1)    # (b, h, hd) each

    m_new = torch.maximum(f_p + state.m, i_p)
    i_eff = torch.exp(torch.clamp(i_p - m_new, max=_CLAMP))
    f_eff = torch.exp(torch.clamp(f_p + state.m - m_new, max=_CLAMP))
    c = f_eff * state.c + i_eff * torch.tanh(z_p)
    n = f_eff * state.n + i_eff
    h_new = torch.sigmoid(o_p) * c / torch.clamp_min(n, 1e-6)
    return SLSTMState(c=c, n=n, m=m_new, h=h_new)


def _slstm_ffn(params, cfg, y):
    up = dense(y, params.ffn_up)
    gate, u = torch.chunk(up, 2, dim=-1)
    act = _gelu(gate.float()).to(y.dtype) * u
    return dense(act, params.ffn_down)


def slstm_apply_train(params: ParamTree, cfg, x: torch.Tensor, *,
                      return_state: bool = False):
    b, s, d = x.shape
    xg = dense(x, params.wx).float() + params.b
    state = init_slstm_state(cfg, b, x.device)
    hs = []
    for t in range(s):
        state = _slstm_cell(params, cfg, xg[:, t], state)
        hs.append(state.h)
    y = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    return _slstm_ffn(params, cfg, y), (state if return_state else None)


def slstm_apply_decode(params: ParamTree, cfg, x1: torch.Tensor,
                       state: SLSTMState):
    b = x1.shape[0]
    xg = dense(x1, params.wx)[:, 0].float() + params.b
    new = _slstm_cell(params, cfg, xg, state)
    y = new.h.reshape(b, 1, cfg.d_model).to(x1.dtype)
    return _slstm_ffn(params, cfg, y), new

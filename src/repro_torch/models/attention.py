"""Attention: blockwise online-softmax full-sequence path + cached decode.

Port of ``repro.models.attention``.  The full-sequence path (prefill,
encoder, cross-attention) is the reference's flash-style blockwise
formulation: a loop over KV chunks carrying running (max, denom, acc), so
the (S, S) score matrix is never materialized.  Masks: causal,
sliding-window (local), bidirectional prefix (prefix-LM for the VLM), and
full-bidirectional (whisper encoder), all from absolute positions inside
the chunk loop.  Scores and the PV product are f32 from model-dtype
operands, as the reference's ``preferred_element_type=float32``.

Decode uses KV caches: ``global`` layers keep the full (S_max) cache;
``local`` layers keep a ring buffer of ``window`` slots (RoPE is applied
pre-cache at absolute positions, so ring rotation is sound).  The new
token's K/V are written into the cache in place (``index_copy_``) at the
slot a 0-d device tensor names, so a decode step never waits on the host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.layers import (
    ParamTree, dense, init_dense, model_dtype, rope,
)

__all__ = [
    "attn_init", "attn_apply_train", "KVCache", "init_kv_cache",
    "attn_apply_decode",
]

_NEG = -1e30


def attn_init(gen, cfg, device) -> dict:
    """The attention leaves of a layer (the reference merges them into the
    layer's own dict; ``cross`` wraps them in a ``ParamTree``)."""
    dt = model_dtype(cfg)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": init_dense(gen, d, h * hd, dt, device),
        "wk": init_dense(gen, d, kv * hd, dt, device),
        "wv": init_dense(gen, d, kv * hd, dt, device),
        "wo": init_dense(gen, h * hd, d, dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dt, device=device)
        p["bk"] = torch.zeros((kv * hd,), dtype=dt, device=device)
        p["bv"] = torch.zeros((kv * hd,), dtype=dt, device=device)
    return p


def _project_qkv(params, cfg, x, positions):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense(x, params.wq, params.get("bq")).reshape(b, s, h, hd)
    k = dense(x, params.wk, params.get("bk")).reshape(b, s, kv, hd)
    v = dense(x, params.wv, params.get("bv")).reshape(b, s, kv, hd)
    if cfg.pos_kind == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask(qpos, kpos, *, mode: str, window: int, prefix: int):
    """(..., q, k) boolean validity from absolute positions."""
    qp = qpos[..., :, None]
    kp = kpos[..., None, :]
    if mode == "bidir":
        return torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                          dtype=torch.bool, device=qp.device)
    causal = kp <= qp
    if mode == "local":
        causal = causal & ((qp - kp) < window)
    if prefix > 0:  # prefix-LM: fully visible prefix block
        causal = causal | ((qp < prefix) & (kp < prefix))
    return causal


def _blockwise_sdpa(q, k, v, *, mode, window, prefix, q0, k0, chunk_q,
                    chunk_kv, group):
    """Online-softmax attention.

    q: (B, Sq, H, hd); k, v: (B, Sk, Kv, hd); H = Kv * group (head ``h =
    kv * group + g``).  q0/k0: absolute position offsets of q/k element 0.
    Returns (B, Sq, H, hd).
    """
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    cq = min(chunk_q, sq)
    ck = min(chunk_kv, sk)
    if sq % cq:
        cq = sq  # non-power-of-two smoke shapes: single chunk
    if sk % ck:
        ck = sk
    nq, nk = sq // cq, sk // ck
    scale = hd ** -0.5
    dev = q.device

    # f32 operands: products of model-dtype values are exact in f32
    qr = q.reshape(b, nq, cq, kvh, group, hd).float()
    kr = k.reshape(b, nk, ck, kvh, hd).float()
    vr = v.reshape(b, nk, ck, kvh, hd)
    outs = []
    for qi in range(nq):
        qc = qr[:, qi]                                   # (B, cq, Kv, G, hd)
        qpos = q0 + qi * cq + torch.arange(cq, device=dev)
        m_run = torch.full((b, kvh, group, cq), _NEG, device=dev)
        l_run = torch.zeros((b, kvh, group, cq), device=dev)
        acc = torch.zeros((b, kvh, group, cq, hd), device=dev)
        for ki in range(nk):
            kc, vc = kr[:, ki], vr[:, ki]
            kpos = k0 + ki * ck + torch.arange(ck, device=dev)
            s = torch.einsum("bqkgh,bskh->bkgqs", qc, kc) * scale
            valid = _mask(qpos, kpos, mode=mode, window=window, prefix=prefix)
            s = torch.where(valid, s, torch.full_like(s, _NEG))
            m_new = torch.maximum(m_run, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(-1)
            pv = torch.einsum("bkgqs,bskh->bkgqh", p.to(vc.dtype).float(),
                              vc.float())
            acc = acc * corr[..., None] + pv
            m_run = m_new
        out = acc / torch.clamp_min(l_run, 1e-30)[..., None]  # (B,Kv,G,cq,hd)
        outs.append(out.permute(0, 3, 1, 2, 4))          # (B, cq, Kv, G, hd)
    out = torch.cat(outs, dim=1).reshape(b, sq, h, hd)
    return out.to(q.dtype)


def attn_apply_train(
    params: ParamTree,
    cfg,
    x: torch.Tensor,
    *,
    attn_type: str = "global",
    mode_override: Optional[str] = None,
    kv_memory: Optional[torch.Tensor] = None,
    pos0: int = 0,
    chunk_q: int = 512,
    chunk_kv: int = 512,
    return_kv: bool = False,
):
    """Full-sequence attention (prefill / encoder / cross).

    ``kv_memory``: if given (B, S_enc, d), keys/values come from it
    (cross-attention) and the mask is bidirectional.  Returns
    ``(out, (k, v) if return_kv else None)``.
    """
    b, s, _ = x.shape
    positions = pos0 + torch.arange(s, device=x.device)[None, :]
    group = cfg.n_heads // cfg.n_kv_heads
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    if kv_memory is not None:
        sm = kv_memory.shape[1]
        q = dense(x, params.wq, params.get("bq")).reshape(b, s, h, hd)
        k = dense(kv_memory, params.wk, params.get("bk")).reshape(b, sm, kvh,
                                                                  hd)
        v = dense(kv_memory, params.wv, params.get("bv")).reshape(b, sm, kvh,
                                                                  hd)
        mode = "bidir"
        k0 = 0
    else:
        q, k, v = _project_qkv(params, cfg, x, positions)
        mode = mode_override or ("local" if attn_type == "local" else "causal")
        k0 = pos0

    out = _blockwise_sdpa(
        q, k, v, mode=mode, window=cfg.window, prefix=cfg.prefix_lm,
        q0=pos0, k0=k0, chunk_q=chunk_q, chunk_kv=chunk_kv, group=group,
    )
    proj = dense(out.reshape(b, s, h * hd), params.wo)
    return proj, ((k, v) if return_kv else None)


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, C, Kv, hd) -- C = S_max (global) or window (ring)
    v: torch.Tensor


class QuantKVCache(NamedTuple):
    """int8 KV cache with per-(position, head) scales -- SymED's
    bounded-error compression idea applied to serving state: halves decode
    memory vs bf16, and the dequant folds into the attention products
    (scale factors out of the hd contraction), so no full-precision copy of
    the cache is kept."""

    k_q: torch.Tensor   # (B, C, Kv, hd) int8
    v_q: torch.Tensor
    k_s: torch.Tensor   # (B, C, Kv, 1) bf16 scales
    v_s: torch.Tensor


def _quantize(x: torch.Tensor):
    """(..., hd) -> int8 values + bf16 scale over the hd dim."""
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def init_kv_cache(cfg, batch: int, max_len: int, attn_type: str, dtype,
                  device, quant: bool = False):
    c = min(max_len, cfg.window) if attn_type == "local" else max_len
    shape = (batch, c, cfg.n_kv_heads, cfg.head_dim)
    if quant:
        sshape = shape[:-1] + (1,)
        return QuantKVCache(
            k_q=torch.zeros(shape, dtype=torch.int8, device=device),
            v_q=torch.zeros(shape, dtype=torch.int8, device=device),
            k_s=torch.zeros(sshape, dtype=torch.bfloat16, device=device),
            v_s=torch.zeros(sshape, dtype=torch.bfloat16, device=device),
        )
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _write(buf: torch.Tensor, slot: torch.Tensor, val: torch.Tensor) -> None:
    """``buf[:, slot] = val[:, 0]`` in place; ``slot`` a 1-element device
    tensor (no host read)."""
    buf.index_copy_(1, slot, val.to(buf.dtype))


def attn_apply_decode(
    params: ParamTree,
    cfg,
    x1: torch.Tensor,         # (B, 1, d)
    cache,
    pos: torch.Tensor,        # () int32 -- position of the new token
    *,
    attn_type: str = "global",
    kv_memory=None,
):
    """One-token attention against the cache; returns (out, cache), the
    cache updated in place."""
    b = x1.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    group = h // kvh
    positions = pos.reshape(1, 1).expand(b, 1)

    quant = (isinstance(cache, QuantKVCache)
             or isinstance(kv_memory, QuantKVCache))
    if kv_memory is not None:
        # cross-attention: static memory, no cache update
        q = dense(x1, params.wq, params.get("bq")).reshape(b, 1, h, hd)
        kc = kv_memory
        c = (kc.k_q if quant else kc.k).shape[1]
        valid = torch.ones((c,), dtype=torch.bool, device=x1.device)
    else:
        q, k1, v1 = _project_qkv(params, cfg, x1, positions)
        c = (cache.k_q if quant else cache.k).shape[1]
        slot = (pos % c if attn_type == "local" else pos).reshape(1).long()
        if quant:
            k1q, k1s = _quantize(k1)
            v1q, v1s = _quantize(v1)
            for buf, val in zip(cache, (k1q, v1q, k1s, v1s)):
                _write(buf, slot, val)
        else:
            _write(cache.k, slot, k1)
            _write(cache.v, slot, v1)
        kc = cache
        idx = torch.arange(c, device=x1.device)
        if attn_type == "local":
            valid = (idx <= pos % c) | (pos >= c)   # occupied ring slots
        else:
            valid = idx <= pos

    qr = q.reshape(b, kvh, group, hd).float()
    if quant:
        # dequant folds into the products: scale factors out of the hd dot
        kq = kc.k_q.to(x1.dtype).float()
        s = torch.einsum("bkgh,bskh->bkgs", qr, kq)
        s = s * kc.k_s[..., 0].float().transpose(1, 2)[:, :, None, :]
    else:
        s = torch.einsum("bkgh,bskh->bkgs", qr, kc.k.float())
    s = s * (hd ** -0.5)
    s = torch.where(valid, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    if quant:
        pv = p * kc.v_s[..., 0].float().transpose(1, 2)[:, :, None, :]
        out = torch.einsum("bkgs,bskh->bkgh", pv.to(x1.dtype).float(),
                           kc.v_q.to(x1.dtype).float()).to(x1.dtype)
    else:
        out = torch.einsum("bkgs,bskh->bkgh", p.to(kc.v.dtype).float(),
                           kc.v.float()).to(x1.dtype)
    out = out.reshape(b, 1, h * hd)
    return dense(out, params.wo), cache

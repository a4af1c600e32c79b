"""Model assembly: superblock stacks, prefill and decode paths, for every
assigned architecture family.

Port of ``repro.models.transformer``: layer kinds ``attn`` (dense, MoE,
local/global, prefix-LM, encoder-decoder), ``mamba`` (jamba's selective
SSM, with a dense or MoE FFN), ``mlstm`` and ``slstm`` (xLSTM blocks, which
carry their own projections).  A model is one ``ParamTree``
whose children carry the reference's names: ``embed``, ``ln_f``,
``blocks`` (``n_blocks`` superblocks, each a ``ModuleList`` over the
pattern's positions, where the reference stacks every leaf on a leading
axis), ``tail``, ``lm_head``, ``enc_blocks`` and ``enc_ln_f``.  The
superblocks run in a Python loop where the reference scans them.

Two execution modes share one layer dispatcher:
  * ``prefill`` -- full-sequence compute (``forward(collect=True)``) that
                   also fills the decode caches (``forward`` alone gives
                   ``loss_fn``'s next-token loss),
  * ``decode``  -- one token against the caches (``serve_step``): KV
                   caches for attention layers, recurrent states (SSM,
                   mLSTM, sLSTM) for the others.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (
    ParamTree, embed_init, init_dense, matmul_f32, mlp_apply, mlp_init,
    model_dtype, rms_norm, sinusoid_pos,
)
from repro_torch.sharding import constrain

__all__ = [
    "init_params", "forward", "loss_fn", "chunked_xent", "init_decode_state",
    "decode_step", "prefill",
]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _layer_init(gen, cfg, spec, decoder: bool, device) -> ParamTree:
    d = cfg.d_model
    zeros = lambda: torch.zeros((d,), dtype=torch.float32, device=device)
    p: Dict[str, Any] = {"ln1": zeros()}
    if spec.kind == "attn":
        p.update(attn_mod.attn_init(gen, cfg, device))
        if decoder and cfg.cross_attention:
            p["lnx"] = zeros()
            p["cross"] = ParamTree(**attn_mod.attn_init(gen, cfg, device))
    elif spec.kind == "mamba":
        p["mamba"] = ssm_mod.ssm_init(gen, cfg, device)
    elif spec.kind == "mlstm":
        p["mlstm"] = xlstm_mod.mlstm_init(gen, cfg, device)
    elif spec.kind == "slstm":
        p["slstm"] = xlstm_mod.slstm_init(gen, cfg, device)
    else:
        raise ValueError(spec.kind)
    if spec.has_mlp:
        p["ln2"] = zeros()
        if spec.moe:
            p["moe"] = moe_mod.moe_init(gen, cfg, device)
        else:
            p["mlp"] = mlp_init(gen, cfg, device)
    return ParamTree(**p)


def _superblock_init(gen, cfg, pattern, decoder: bool, device):
    return nn.ModuleList(_layer_init(gen, cfg, spec, decoder, device)
                         for spec in pattern)


def _enc_pattern(cfg):
    return (type(cfg.block_pattern[0])(kind="attn"),)


def init_params(gen: Optional[torch.Generator], cfg, *,
                device=None) -> ParamTree:
    """Random parameters drawn from ``gen`` on its device (or ``device``),
    one tensor at a time in the model dtype.  ``gen=None`` with
    ``device="meta"`` builds the tree without allocating."""
    device = torch.device(device) if device is not None else gen.device
    dt = model_dtype(cfg)
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab, d, dt, device),
        "ln_f": torch.zeros((d,), dtype=torch.float32, device=device),
    }
    if cfg.n_blocks > 0:
        params["blocks"] = nn.ModuleList(
            _superblock_init(gen, cfg, cfg.block_pattern, True, device)
            for _ in range(cfg.n_blocks))
    if cfg.tail_pattern:
        params["tail"] = _superblock_init(gen, cfg, cfg.tail_pattern, True,
                                          device)
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense(gen, d, cfg.vocab, dt, device,
                                       scale=0.02)
    if cfg.enc_blocks > 0:
        params["enc_blocks"] = nn.ModuleList(
            _superblock_init(gen, cfg, _enc_pattern(cfg), False, device)
            for _ in range(cfg.enc_blocks))
        params["enc_ln_f"] = torch.zeros((d,), dtype=torch.float32,
                                         device=device)
    return ParamTree(**params)


# ---------------------------------------------------------------------------
# Layer dispatch (prefill)
# ---------------------------------------------------------------------------

def _layer_fwd(p, cfg, spec, x, aux, *, enc_mem, mode_override, collect,
               pos0=0):
    """Returns (x, aux, cache_or_None)."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    cache = None
    if spec.kind == "attn":
        out, kv = attn_mod.attn_apply_train(
            p, cfg, h, attn_type=spec.attn_type, mode_override=mode_override,
            pos0=pos0, return_kv=collect,
        )
        x = x + out
        if enc_mem is not None and cfg.cross_attention:
            hx = rms_norm(x, p.lnx, cfg.norm_eps)
            xo, xkv = attn_mod.attn_apply_train(
                p.cross, cfg, hx, kv_memory=enc_mem, return_kv=collect)
            x = x + xo
            cache = (kv, xkv) if collect else None
        else:
            cache = (kv, None) if collect else None
    elif spec.kind == "mamba":
        out, cache = ssm_mod.ssm_apply_train(p.mamba, cfg, h,
                                             return_state=collect)
        x = x + out
    elif spec.kind == "mlstm":
        out = xlstm_mod.mlstm_apply_train(p.mlstm, cfg, h)
        if collect:
            cache = xlstm_mod.mlstm_prefill_state(p.mlstm, cfg, h)
        return x + out, aux, cache
    elif spec.kind == "slstm":
        out, cache = xlstm_mod.slstm_apply_train(p.slstm, cfg, h,
                                                 return_state=collect)
        return x + out, aux, cache
    else:
        raise ValueError(spec.kind)
    if spec.has_mlp:
        h2 = rms_norm(x, p.ln2, cfg.norm_eps)
        if spec.moe:
            y, a = moe_mod.moe_apply(p.moe, cfg, h2)
            aux = aux + a
        else:
            y = mlp_apply(p.mlp, h2, cfg.mlp_kind)
        x = x + y
    x = constrain(x, "batch", "seq_block", "embed")
    return x, aux, cache


def _stack_fwd(blocks, cfg, pattern, x, *, enc_mem, mode_override, collect,
               remat: bool = False):
    """Run the superblocks in order; returns (x, aux, caches), ``caches`` a
    list over superblocks of tuples over the pattern (None unless
    ``collect``).  ``remat`` (taken only while autograd records) keeps
    each superblock's boundary alone and recomputes its inside in the
    backward, the reference's block-level checkpoint."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat and torch.is_grad_enabled()
    caches = []

    def block_body(block, x, aux):
        block_caches = []
        for p, spec in zip(block, pattern):
            x, aux, c = _layer_fwd(p, cfg, spec, x, aux, enc_mem=enc_mem,
                                   mode_override=mode_override,
                                   collect=collect)
            block_caches.append(c)
        return x, aux, tuple(block_caches)

    for block in blocks:
        if remat:
            x, aux, block_caches = checkpoint(block_body, block, x, aux,
                                              use_reentrant=False)
        else:
            x, aux, block_caches = block_body(block, x, aux)
        caches.append(block_caches)
    return x, aux, (caches if collect else None)


def _embed_tokens(params, cfg, tokens, pos0=0):
    x = params.embed[tokens].to(model_dtype(cfg))
    # the constant rounded to the model dtype first, as the reference's
    # jnp.asarray(d ** 0.5, x.dtype)
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if cfg.pos_kind == "sinusoid":
        pos = pos0 + torch.arange(tokens.shape[1], device=x.device)[None, :]
        x = x + sinusoid_pos(pos, cfg.d_model).to(x.dtype)
    return x


def _encode(params, cfg, enc_frames, remat: bool = False):
    """Whisper-style encoder over (stubbed) frame embeddings."""
    x = enc_frames.to(model_dtype(cfg))
    x, _, _ = _stack_fwd(params.enc_blocks, cfg, _enc_pattern(cfg), x,
                         enc_mem=None, mode_override="bidir", collect=False,
                         remat=remat)
    return rms_norm(x, params.enc_ln_f, cfg.norm_eps)


def forward(params, cfg, tokens, *, prefix_embeds=None, enc_frames=None,
            collect: bool = False, remat: bool = True):
    """Full-sequence forward.

    Returns (activations (B, S_total, d), aux_loss, caches, enc_mem).
    ``S_total`` includes the VLM prefix if present.  ``remat`` changes
    memory, not numbers (see ``_stack_fwd``).
    """
    x = _embed_tokens(params, cfg, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    x = constrain(x, "batch", "seq_block", "embed")

    enc_mem = (_encode(params, cfg, enc_frames, remat)
               if enc_frames is not None else None)

    caches = None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.n_blocks:
        x, aux, caches = _stack_fwd(
            params.blocks, cfg, cfg.block_pattern, x, enc_mem=enc_mem,
            mode_override=None, collect=collect, remat=remat)
    caches_tail = []
    for p, spec in zip(params.get("tail", ()), cfg.tail_pattern):
        x, aux, c = _layer_fwd(p, cfg, spec, x, aux, enc_mem=enc_mem,
                               mode_override=None, collect=collect)
        caches_tail.append(c)
    x = rms_norm(x, params.ln_f, cfg.norm_eps)
    return x, aux, (caches, tuple(caches_tail)), enc_mem


def _unembed(params, cfg, x):
    """f32 logits from the model-dtype activations and head."""
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    return constrain(matmul_f32(x, w.to(x.dtype)), "batch", "seq", "vocab")


def chunked_xent(params, cfg, x, labels, *, chunk: int = 512):
    """Mean next-token NLL.  labels < 0 are ignored.  x: (B, S, d).  The
    f32 logits are made one chunk of positions at a time (the largest
    divisor of S up to ``chunk``), never for the whole sequence."""
    b, s, _ = x.shape
    c = min(chunk, s)
    while s % c:  # e.g. vlm prefix makes S=4352: largest divisor <= chunk
        c -= 1
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, c):
        lc = labels[:, c0: c0 + c]
        logits = _unembed(params, cfg, x[:, c0: c0 + c])      # (b, c, V) f32
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1,
                           torch.clamp_min(lc, 0)[..., None].long())[..., 0]
        mask = (lc >= 0).float()
        tot = tot + torch.sum((lse - tgt) * mask)
        cnt = cnt + torch.sum(mask)
    return tot / torch.clamp_min(cnt, 1.0)


def loss_fn(params, cfg, batch, *, remat: bool = True):
    """batch: tokens (B,S) int, plus optional prefix_embeds / enc_frames.
    Returns (loss + aux, {"xent": loss, "aux": aux}).  ``remat``: the
    superblocks' insides are recomputed in the backward (memory only)."""
    tokens = batch["tokens"]
    x, aux, _, _ = forward(
        params, cfg, tokens,
        prefix_embeds=batch.get("prefix_embeds"),
        enc_frames=batch.get("enc_frames"), remat=remat,
    )
    prefix = (0 if batch.get("prefix_embeds") is None
              else batch["prefix_embeds"].shape[1])
    # next-token labels; never predict across the prefix boundary
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)],
                       dim=1)
    if prefix:
        pad = torch.full((tokens.shape[0], prefix), -1, dtype=labels.dtype,
                         device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    loss = chunked_xent(params, cfg, x, labels)
    return loss + aux, {"xent": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _layer_cache_template(cfg, spec, batch, max_len, dtype, with_cross,
                          device):
    if spec.kind == "mamba":
        return ssm_mod.init_ssm_state(cfg, batch, device)
    if spec.kind == "mlstm":
        return xlstm_mod.init_mlstm_state(cfg, batch, device)
    if spec.kind == "slstm":
        return xlstm_mod.init_slstm_state(cfg, batch, device)
    if spec.kind != "attn":
        raise ValueError(spec.kind)
    self_c = attn_mod.init_kv_cache(cfg, batch, max_len, spec.attn_type,
                                    dtype, device, quant=cfg.kv_quant)
    cross_c = (
        attn_mod.init_kv_cache(cfg, batch, cfg.num_prefix_embeds or 1,
                               "global", dtype, device)
        if with_cross else None
    )
    return (self_c, cross_c)


def init_decode_state(cfg, batch: int, max_len: int,
                      device=None) -> Dict[str, Any]:
    """Zeroed decode state on ``device`` (``cuda`` unless told otherwise):
    ``pos`` a 0-d int32 tensor, ``blocks`` a list over superblocks of
    tuples over the pattern, each an attention layer's ``(self cache, cross
    cache or None)`` or a recurrent layer's state, ``tail`` such a tuple,
    ``enc_mem`` for encoder-decoder configs."""
    device = resolve_device(device)
    dtype = model_dtype(cfg)
    with_cross = cfg.cross_attention

    def caches(pattern):
        return tuple(_layer_cache_template(cfg, s, batch, max_len, dtype,
                                           with_cross, device)
                     for s in pattern)

    state: Dict[str, Any] = {
        "pos": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.n_blocks:
        state["blocks"] = [caches(cfg.block_pattern)
                           for _ in range(cfg.n_blocks)]
    if cfg.tail_pattern:
        state["tail"] = caches(cfg.tail_pattern)
    if cfg.enc_blocks:
        state["enc_mem"] = torch.zeros(
            (batch, cfg.num_prefix_embeds or 1, cfg.d_model), dtype=dtype,
            device=device)
    return state


def _layer_decode(p, cfg, spec, x1, cache, pos):
    h = rms_norm(x1, p.ln1, cfg.norm_eps)
    if spec.kind == "attn":
        self_c, cross_c = cache
        out, self_c = attn_mod.attn_apply_decode(
            p, cfg, h, self_c, pos, attn_type=spec.attn_type)
        x1 = x1 + out
        if cross_c is not None:
            hx = rms_norm(x1, p.lnx, cfg.norm_eps)
            xo, _ = attn_mod.attn_apply_decode(
                p.cross, cfg, hx, self_c, pos, kv_memory=cross_c)
            x1 = x1 + xo
        new_cache = (self_c, cross_c)
    elif spec.kind == "mamba":
        out, new_cache = ssm_mod.ssm_apply_decode(p.mamba, cfg, h, cache)
        x1 = x1 + out
    elif spec.kind == "mlstm":
        out, new_cache = xlstm_mod.mlstm_apply_decode(p.mlstm, cfg, h, cache)
        return x1 + out, new_cache
    elif spec.kind == "slstm":
        out, new_cache = xlstm_mod.slstm_apply_decode(p.slstm, cfg, h, cache)
        return x1 + out, new_cache
    else:
        raise ValueError(spec.kind)
    if spec.has_mlp:
        h2 = rms_norm(x1, p.ln2, cfg.norm_eps)
        if spec.moe:
            y, _ = moe_mod.moe_apply(p.moe, cfg, h2, group_size=x1.shape[0])
        else:
            y = mlp_apply(p.mlp, h2, cfg.mlp_kind)
        x1 = x1 + y
    return x1, new_cache


def decode_step(params, cfg, state, token):
    """One serve step: token (B, 1) int -> (logits (B, 1, V) f32, new state).

    The KV caches are updated in place (the new state shares them with
    ``state``, as the reference's serve loop donates its state); the
    recurrent states and ``pos`` are new tensors, and nothing here reads
    ``pos`` on the host.
    """
    pos = state["pos"]
    x1 = _embed_tokens(params, cfg, token, pos0=pos)
    x1 = constrain(x1, "batch", None, "embed")

    new_state = dict(state)
    if cfg.n_blocks:
        new_blocks = []
        for block, block_cache in zip(params.blocks, state["blocks"]):
            new_caches = []
            for p, spec, c in zip(block, cfg.block_pattern, block_cache):
                x1, nc = _layer_decode(p, cfg, spec, x1, c, pos)
                new_caches.append(nc)
            new_blocks.append(tuple(new_caches))
        new_state["blocks"] = new_blocks
    if cfg.tail_pattern:
        new_tail = []
        for p, spec, c in zip(params.tail, cfg.tail_pattern, state["tail"]):
            x1, nc = _layer_decode(p, cfg, spec, x1, c, pos)
            new_tail.append(nc)
        new_state["tail"] = tuple(new_tail)

    x1 = rms_norm(x1, params.ln_f, cfg.norm_eps)
    logits = _unembed(params, cfg, x1)
    new_state["pos"] = pos + 1
    return logits, new_state


def prefill(params, cfg, tokens, *, prefix_embeds=None, enc_frames=None,
            max_len: Optional[int] = None):
    """Process a prompt; returns (last-position logits, ready decode state)."""
    s_total = tokens.shape[1] + (
        prefix_embeds.shape[1] if prefix_embeds is not None else 0
    )
    max_len = max_len or s_total
    x, _, (caches, tail_caches), enc_mem = forward(
        params, cfg, tokens, prefix_embeds=prefix_embeds,
        enc_frames=enc_frames, collect=True)
    batch = tokens.shape[0]
    state = init_decode_state(cfg, batch, max_len, device=tokens.device)
    state["pos"] = torch.tensor(s_total, dtype=torch.int32,
                                device=tokens.device)

    if cfg.n_blocks:
        state["blocks"] = [
            tuple(_fill_cache(cfg, spec, t, g, s_total)
                  for spec, t, g in zip(cfg.block_pattern, temps, got))
            for temps, got in zip(state["blocks"], caches)]
    if cfg.tail_pattern:
        state["tail"] = tuple(
            _fill_cache(cfg, spec, t, g, s_total)
            for spec, t, g in zip(cfg.tail_pattern, state["tail"], tail_caches)
        )
    if enc_mem is not None:
        state["enc_mem"] = enc_mem
    logits = _unembed(params, cfg, x[:, -1:])
    return logits, state


def _fill_kv(cfg, attn_type, template, got, s_total):
    k, v = got
    quant = isinstance(template, attn_mod.QuantKVCache)
    c = (template.k_q if quant else template.k).shape[1]
    if attn_type == "local" and s_total > c:
        # ring buffer: keep the last ``window`` entries at their ring slots
        start = s_total - c
        roll = s_total % c  # ring offset: slot(p) = p mod c
        k = torch.roll(k[:, start:start + c], roll, dims=1)
        v = torch.roll(v[:, start:start + c], roll, dims=1)
    else:
        pad = (0, 0, 0, 0, 0, c - k.shape[1])
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    if quant:
        k_q, k_s = attn_mod._quantize(k)
        v_q, v_s = attn_mod._quantize(v)
        return attn_mod.QuantKVCache(k_q=k_q, v_q=v_q, k_s=k_s, v_s=v_s)
    return KVCache(k=k.to(template.k.dtype).contiguous(),
                   v=v.to(template.v.dtype).contiguous())


def _fill_cache(cfg, spec, template, got, s_total):
    if spec.kind != "attn":
        return got  # recurrent states pass through
    kv, xkv = got
    self_t, cross_t = template
    self_c = _fill_kv(cfg, spec.attn_type, self_t, kv, s_total)
    cross_c = cross_t
    if cross_t is not None and xkv is not None:
        cross_c = KVCache(k=xkv[0].to(cross_t.k.dtype),
                          v=xkv[1].to(cross_t.v.dtype))
    return (self_c, cross_c)

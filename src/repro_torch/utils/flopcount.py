"""Analytic FLOP / HBM-byte model per (arch x shape) cell.

Port of ``repro.utils.flopcount``, term for term and in the same order of
arithmetic, so every float equals the reference's.  Why analytic: the
reference's compiler counts a scan body once, not times its trip count, so
the dry run's roofline rests on this model; the port's dry run keeps it
beside its own count (``FlopCounterMode``).  The matmul FLOPs below
are exact per layer; pointwise work is ignored (<2% for these shapes).  The
HBM model is a documented approximation: weight traffic (per model-axis
shard), optimizer state traffic, and major activation operand traffic at bf16,
with the standard full-remat multiplier.

Conventions:
  * fwd FLOPs = 2 * MACs; train executes fwd + bwd (2x fwd) + remat re-fwd
    => executed = 4x fwd.  MODEL_FLOPS uses the 6*N*D convention (no remat),
    so useful_ratio ~ 6/8 = 0.75 is the expected remat tax for dense archs.
  * decode counts one token against a cache of ``seq_len``.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import SHAPES, ModelConfig

__all__ = ["cell_flops", "cell_hbm_bytes", "analytic_cell"]


def _attn_flops_tok(cfg: ModelConfig, attn_type: str, ctx: float) -> float:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    proj = 2 * d * (h + 2 * kv) * hd + 2 * d * h * hd
    sdpa = 2 * 2 * ctx * h * hd
    return proj + sdpa


def _mlp_flops_tok(cfg: ModelConfig) -> float:
    gated = cfg.mlp_kind in ("swiglu", "geglu")
    return (6 if gated else 4) * cfg.d_model * cfg.d_ff


def _moe_flops_tok(cfg: ModelConfig) -> float:
    gated = cfg.mlp_kind in ("swiglu", "geglu")
    expert = (6 if gated else 4) * cfg.d_model * cfg.d_ff
    router = 2 * cfg.d_model * cfg.n_experts
    dispatch = 4 * cfg.capacity_factor * cfg.top_k * cfg.d_model
    return router + cfg.top_k * expert + dispatch


def _mamba_flops_tok(cfg: ModelConfig) -> float:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    st = cfg.ssm_state
    dtr = max(d // 16, 1)
    return (
        2 * d * 2 * di              # in_proj
        + 2 * cfg.ssm_conv * di     # depthwise conv
        + 2 * di * (dtr + 2 * st)   # x_proj
        + 2 * dtr * di              # dt_proj
        + 10 * di * st              # selective scan update + C.h
        + 2 * di * d                # out_proj
    )


def _mlstm_flops_tok(cfg: ModelConfig, ctx: float) -> float:
    d = cfg.d_model
    di = 2 * d
    return (
        2 * d * 2 * di              # up
        + 2 * 4 * di                # conv
        + 3 * 2 * di * di           # q, k, v
        + 2 * di * 2 * cfg.n_heads  # gates
        + 2 * 2 * ctx * di          # quadratic form (scores + weighted V)
        + 2 * di * d                # down
    )


def _slstm_flops_tok(cfg: ModelConfig) -> float:
    d = cfg.d_model
    hd = d // cfg.n_heads
    pf = (4 * d + 2) // 3
    return (
        2 * d * 4 * d               # wx
        + 2 * cfg.n_heads * hd * 4 * hd  # block-diag recurrence
        + 2 * d * 2 * pf + 2 * pf * d    # GeGLU FFN
    )


def _layer_flops_tok(cfg: ModelConfig, spec, ctx: float, cross_ctx: float = 0.0) -> float:
    if spec.kind == "attn":
        f = _attn_flops_tok(cfg, spec.attn_type, ctx if spec.attn_type != "local"
                            else min(ctx, cfg.window))
        if cfg.cross_attention and cross_ctx:
            f += 2 * cfg.d_model * cfg.n_heads * cfg.head_dim  # q proj
            f += 2 * 2 * cross_ctx * cfg.n_heads * cfg.head_dim
    elif spec.kind == "mamba":
        f = _mamba_flops_tok(cfg)
    elif spec.kind == "mlstm":
        f = _mlstm_flops_tok(cfg, ctx)
    elif spec.kind == "slstm":
        f = _slstm_flops_tok(cfg)
    else:
        raise ValueError(spec.kind)
    if spec.has_mlp:
        f += _moe_flops_tok(cfg) if spec.moe else _mlp_flops_tok(cfg)
    return f


def _stack_flops_tok(cfg: ModelConfig, ctx: float, cross_ctx: float) -> float:
    per_block = sum(
        _layer_flops_tok(cfg, s, ctx, cross_ctx) for s in cfg.block_pattern
    )
    tail = sum(_layer_flops_tok(cfg, s, ctx, cross_ctx) for s in cfg.tail_pattern)
    return per_block * cfg.n_blocks + tail


def cell_flops(cfg: ModelConfig, shape_name: str) -> Dict[str, float]:
    """Executed + model FLOPs (totals across all chips)."""
    shape = SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    unembed = 2 * cfg.d_model * cfg.vocab

    if shape.step == "decode":
        ctx = float(s)
        tokens = float(b)  # one new token per sequence
        fwd = tokens * (_stack_flops_tok(cfg, ctx, cfg.num_prefix_embeds) + unembed)
        executed = fwd
        model = 2.0 * _active_params(cfg) * tokens
    else:
        ctx = (s + 1) / 2.0  # causal average context
        tokens = float(b * s)
        fwd = tokens * (_stack_flops_tok(cfg, ctx, cfg.num_prefix_embeds) + unembed)
        if cfg.enc_blocks:
            enc_tokens = float(b * cfg.num_prefix_embeds)
            enc_fwd = enc_tokens * cfg.enc_blocks * _layer_flops_tok(
                cfg, cfg.block_pattern[0].__class__(kind="attn"),
                cfg.num_prefix_embeds,
            )
            fwd += enc_fwd
        if shape.step == "train":
            executed = 4.0 * fwd   # fwd + 2x bwd + remat re-fwd
            model = 6.0 * _active_params(cfg) * tokens
        else:  # prefill
            executed = fwd
            model = 2.0 * _active_params(cfg) * tokens
    return {"fwd": fwd, "executed": executed, "model": model}


def _active_params(cfg: ModelConfig) -> int:
    from repro_torch.models.params import count_params

    return count_params(cfg, active_only=True)


def _total_params(cfg: ModelConfig) -> int:
    from repro_torch.models.params import count_params

    return count_params(cfg)


def cell_hbm_bytes(cfg: ModelConfig, shape_name: str, n_chips: int,
                   model_shards: int = 16) -> float:
    """Approximate per-device HBM traffic for one step (documented model).

    weights: each device streams its 1/model_shards slice of all params for
    fwd, bwd and the remat re-fwd (FSDP gathers cross the interconnect, not
    HBM, but the gathered tiles are read from HBM once per use).
    optimizer: AdamW moments read+write (f32/bf16 per config) + param update.
    activations: ~12 * d bytes/token/layer at bf16 (block in/out, norms, qkv,
    mlp operands), divided across batch shards; x3 for train passes.
    """
    shape = SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    n_params = _total_params(cfg)
    p_bytes = 2  # bf16
    w_slice = n_params * p_bytes / model_shards

    if shape.step == "decode":
        tokens_dev = max(b / (n_chips / model_shards), 1)
        act = 12 * cfg.d_model * 2 * tokens_dev * cfg.n_layers
        cache = _decode_cache_bytes(cfg, b, s) / n_chips
        return w_slice + act + cache

    tokens_dev = b * s / (n_chips / model_shards)
    passes = 3 if shape.step == "train" else 1
    weights = w_slice * (3 if shape.step == "train" else 1)
    opt = 0.0
    if shape.step == "train":
        m_bytes = 4 if n_params < 3e10 else 2
        opt = n_params / n_chips * (4 * m_bytes + 2 * 2 + 4)  # m,v rw + p rw + g
    act = 12 * cfg.d_model * 2 * tokens_dev * cfg.n_layers * passes / model_shards
    return weights + opt + act


def _decode_cache_bytes(cfg: ModelConfig, b: int, s: int) -> float:
    total = 0.0
    for spec in list(cfg.block_pattern) * cfg.n_blocks + list(cfg.tail_pattern):
        if spec.kind == "attn":
            c = min(s, cfg.window) if spec.attn_type == "local" else s
            total += 2 * b * c * cfg.n_kv_heads * cfg.head_dim * 2
        elif spec.kind == "mamba":
            total += b * cfg.ssm_expand * cfg.d_model * cfg.ssm_state * 4
        elif spec.kind == "mlstm":
            di = 2 * cfg.d_model
            total += b * cfg.n_heads * (di // cfg.n_heads) ** 2 * 4
        elif spec.kind == "slstm":
            total += 4 * b * cfg.d_model * 4
    return total


def analytic_cell(cfg: ModelConfig, shape_name: str, n_chips: int,
                  model_shards: int = 16) -> Dict[str, float]:
    fl = cell_flops(cfg, shape_name)
    hbm = cell_hbm_bytes(cfg, shape_name, n_chips, model_shards)
    return {
        "flops_per_dev": fl["executed"] / n_chips,
        "model_flops": fl["model"],
        "fwd_flops": fl["fwd"],
        "hbm_bytes_per_dev": hbm,
    }

"""Mixture-of-Experts FFN with top-k routing and grouped one-hot dispatch.

Port of ``repro.models.moe``: GShard/Switch-style capacity-bounded
dispatch.  Tokens are cut into groups of ``group_size``; each group queues
its tokens per expert (cumsum positions), drops those past the capacity
``max(int(cf * g * k / e), 1)``, and dispatches and combines with dense
one-hot products.  The groups run one after the other, as the reference's
scan does, so that one group's dispatch and combine tensors are the largest
buffers whatever the number of tokens.  The combine tensor ``(g, e, cap)``
is written by index: each token's gate value lands at its expert's queue
slot, the one nonzero term of the reference's sum of one-hots over the k
choices (top-k experts are distinct), so the values are the same and the
``(g, k, e, cap)`` one-hot is never built.  The router runs in f32; top-k
breaks ties by the lower expert index, as ``lax.top_k`` does.

Load-balancing auxiliary loss follows Switch/Mixtral: sum(frac_tokens *
frac_router_prob) * E * coef, computed over all tokens.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import (
    GATED_MLP, ParamTree, init_dense, mlp_activate, model_dtype, normal,
)
from repro_torch.sharding import constrain

__all__ = ["moe_init", "moe_apply"]


def moe_init(gen, cfg, device) -> ParamTree:
    dt = model_dtype(cfg)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    width = 2 * f if cfg.mlp_kind in GATED_MLP else f
    return ParamTree(
        router=init_dense(gen, d, e, torch.float32, device),  # router kept f32
        wi_moe=normal(gen, (e, d, width), d ** -0.5, dt, device),
        wo_moe=normal(gen, (e, f, d), f ** -0.5, dt, device),
    )


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of indices in ``[0, n)``."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, ties to the lower
    index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_ffn(params, cfg, buf):
    """buf: (e, cap, d) -> (e, cap, d), each expert's FFN in the model dtype
    with f32 accumulation.  The constraints pin the reference's expert
    layout (experts over ``model``, d_ff over ``data``)."""
    buf = constrain(buf, "experts_act", None, None)
    h = torch.bmm(buf, params.wi_moe)
    h = constrain(h, "experts_act", None, "moe_f_act")
    h = mlp_activate(h, cfg.mlp_kind, buf.dtype)
    h = constrain(h, "experts_act", None, "moe_f_act")
    return constrain(torch.bmm(h, params.wo_moe), "experts_act", None, None)


def _per_group(params, cfg, xg, gi, gv, cap: int):
    """One group: ``xg (g, d)``, ``gi``/``gv (g, k)`` -> ``(g, d)``."""
    g, k = gi.shape
    e, d = cfg.n_experts, xg.shape[-1]
    onehot = _one_hot(gi, e)                                   # (g, k, e)
    flat = onehot.reshape(g * k, e)
    pos = ((torch.cumsum(flat, dim=0) - 1.0) * flat).reshape(g, k, e)
    # each choice's queue position at its own expert; past the capacity it
    # is dropped (written to a spare slot ``cap`` that is cut off)
    slot = pos.gather(-1, gi[..., None].long())[..., 0].long()  # (g, k)
    slot = torch.clamp_max(slot, cap)
    # made from ``gv`` (f32 on its device), so that a DTensor trace writes
    # into a DTensor (``utils.collectives``)
    comb = gv.new_zeros((g, e, cap + 1), dtype=torch.float32)
    comb[torch.arange(g, device=xg.device)[:, None], gi.long(), slot] = gv
    comb = comb[..., :cap]                                     # (g, e, cap)
    disp = (comb > 0).to(xg.dtype)

    # dispatch: each (expert, slot) holds at most one token, so the product
    # selects rows exactly
    buf = disp.reshape(g, e * cap).T @ xg
    out_e = _expert_ffn(params, cfg, buf.reshape(e, cap, d))
    return comb.to(xg.dtype).reshape(g, e * cap) @ out_e.reshape(e * cap, d)


def moe_apply(params: ParamTree, cfg, x: torch.Tensor, *,
              group_size: int = 4096):
    """x: (B, S, d) -> (y, aux_loss).  Capacity-dropped tokens contribute 0."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = b * s
    g = min(group_size, n)
    if n % g:
        g = n  # odd smoke shapes: single group
    n_groups = n // g
    cap = max(int(cfg.capacity_factor * g * k / e), 1)

    xt = x.reshape(n_groups, g, d)
    logits = torch.einsum("Ggd,de->Gge", xt.float(), params.router)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, k)                     # (G, g, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)

    y = torch.stack([_per_group(params, cfg, xt[i], gate_idx[i],
                                gate_vals[i], cap)
                     for i in range(n_groups)])

    # --- Switch-style load-balance aux loss (over all tokens) --------------
    frac_tokens = _one_hot(gate_idx.reshape(-1, k)[:, 0], e).mean(0)
    frac_probs = probs.reshape(-1, e).mean(0)
    aux = (frac_tokens * frac_probs).sum() * e * cfg.router_aux_coef

    return y.reshape(b, s, d), aux

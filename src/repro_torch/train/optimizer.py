"""Optimizers: AdamW (configurable moment dtype) and Adafactor (factored
second moments for the 100B+ configs), plus global-norm clipping and a
warmup+cosine schedule.

Port of ``repro.train.optimizer``.  Pure functions over the reference's
leaves: a dict from the leaf's path string to its tensor
(``models.params.stack_named``), the superblocks stacked as the reference
scans them, so every rule that reads a leaf's rank (weight decay on
matrices, Adafactor's factoring and its update RMS) sees the reference's
shapes.  The optimizer state mirrors that dict under the same names.

The arithmetic is the reference's f32: the step is a 0-d int32 tensor on
the device, and the schedule, the bias correction and Adafactor's decay are
0-d f32 tensors made from it (Python constants enter as f32, as JAX's weak
types do), so a step reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

__all__ = ["OptConfig", "opt_init", "opt_update", "global_norm",
           "clip_by_global_norm"]

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"              # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moments_dtype: str = "float32"   # bfloat16 halves optimizer HBM at >=100B
    warmup_steps: int = 100
    total_steps: int = 10_000


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _schedule(step: torch.Tensor, oc: OptConfig) -> torch.Tensor:
    """Warmup then cosine to 10% of ``lr``: the int32 step divided in f32."""
    s = step.float()
    warm = torch.clamp_max(s / _f32(max(oc.warmup_steps, 1), s), 1.0)
    t = (step - oc.warmup_steps).float() / _f32(
        max(oc.total_steps - oc.warmup_steps, 1), s)
    t = torch.clamp(t, 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return oc.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's f32 sum of
    squares."""
    total = 0
    for leaf in tree.values():
        total = total + torch.sum(leaf.float() ** 2)
    return torch.sqrt(total)


def clip_by_global_norm(tree: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    gn = global_norm(tree)
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-9), 1.0)
    return {k: g * scale.to(g.dtype) for k, g in tree.items()}, gn


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _adamw_init(params: Tree, oc: OptConfig):
    dt = getattr(torch, oc.moments_dtype)
    z = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"m": {k: z(p) for k, p in params.items()},
            "v": {k: z(p) for k, p in params.items()}}


def _adamw_update(grads: Tree, opt, params: Tree, step, oc: OptConfig):
    lr = _schedule(step, oc)
    b1, b2 = oc.b1, oc.b2
    t = step.float() + 1.0
    corr = (torch.sqrt(1.0 - torch.pow(_f32(b2, t), t))
            / (1.0 - torch.pow(_f32(b1, t), t)))
    new_p, new_m, new_v = {}, {}, {}
    for k, g in grads.items():
        m, v, p = opt["m"][k], opt["v"][k], params[k]
        gf = g.float()
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf * gf
        u = corr * m_new / (torch.sqrt(v_new) + oc.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            u = u + oc.weight_decay * p.float()
        new_p[k] = (p.float() - lr * u).to(p.dtype)
        new_m[k] = m_new.to(m.dtype)
        new_v[k] = v_new.to(v.dtype)
    return new_p, {"m": new_m, "v": new_v}


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; first moment omitted, as in t5x default)
# ---------------------------------------------------------------------------

def _adafactor_init(params: Tree, oc: OptConfig):
    def per_leaf(p):
        z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                      device=p.device)
        if p.ndim >= 2:
            return {"vr": z(p.shape[:-1]),
                    "vc": z(p.shape[:-2] + p.shape[-1:])}
        return {"v": z(p.shape)}

    return {"f": {k: per_leaf(p) for k, p in params.items()}}


def _adafactor_update(grads: Tree, opt, params: Tree, step, oc: OptConfig):
    lr = _schedule(step, oc)
    b2 = 1.0 - torch.pow(step.float() + 1.0, -0.8)
    new_p, new_f = {}, {}
    for k, g in grads.items():
        st, p = opt["f"][k], params[k]
        gf = g.float()
        g2 = gf * gf + 1e-30
        if p.ndim >= 2:
            vr = b2 * st["vr"] + (1 - b2) * torch.mean(g2, dim=-1)
            vc = b2 * st["vc"] + (1 - b2) * torch.mean(g2, dim=-2)
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp_min(
                         torch.mean(vr, dim=-1, keepdim=True)[..., None],
                         1e-30))
            u = gf * torch.rsqrt(denom + 1e-30)
            new_f[k] = {"vr": vr, "vc": vc}
        else:
            v = b2 * st["v"] + (1 - b2) * g2
            u = gf * torch.rsqrt(v + 1e-30)
            new_f[k] = {"v": v}
        # update clipping (Adafactor's d=1.0 RMS rule)
        rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp_min(rms_u, 1.0)
        if p.ndim >= 2:
            u = u + oc.weight_decay * p.float()
        new_p[k] = (p.float() - lr * u).to(p.dtype)
    return new_p, {"f": new_f}


def opt_init(params: Tree, oc: OptConfig):
    if oc.name == "adamw":
        return _adamw_init(params, oc)
    if oc.name == "adafactor":
        return _adafactor_init(params, oc)
    raise ValueError(oc.name)


@torch.no_grad()
def opt_update(grads: Tree, opt, params: Tree, step: torch.Tensor,
               oc: OptConfig):
    """One update: ``(new params, new state)``, new tensors throughout.
    ``step`` is the 0-d int32 count of updates made so far."""
    if oc.name == "adamw":
        return _adamw_update(grads, opt, params, step, oc)
    if oc.name == "adafactor":
        return _adafactor_update(grads, opt, params, step, oc)
    raise ValueError(oc.name)

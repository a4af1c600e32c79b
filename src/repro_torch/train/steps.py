"""Train and serve steps, and the train state.

Port of ``repro.train.steps``.  A train step is a pure function ``(state,
batch) -> (new state, metrics)``: the state is ``{"params", "opt",
"step"}`` (plus ``"error_fb"`` for the compressed step), the batch a dict
of tensors (``tokens (B, S)`` and the frontend inputs), and the step makes
new tensors throughout (the caller drops the old state, as the reference's
launcher donates it).  ``params`` is the model's ``ParamTree``, trainable;
``opt`` and ``error_fb`` hold the reference's leaves (``stack_named``:
path strings, superblocks stacked), so the optimizer reads every leaf at
the reference's shape.  ``step`` is a 0-d int32 tensor; the step reads
nothing back to the host.

``make_compressed_train_step`` is the int8 cross-pod gradient exchange,
run by one process over the mesh's pods as the fleet runtime runs its
shards: each pod takes the gradient of its slice of the batch, the pods
agree on a per-leaf scale (the max of their ``amax``), sum their int8
codes in int32 and keep their own bf16 residual (``error_fb``, one dict
per pod).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.models import decode_step as _decode_step
from repro_torch.models import init_params, loss_fn
from repro_torch.models.params import stack_named, with_leaves
from repro_torch.train.optimizer import (OptConfig, clip_by_global_norm,
                                         opt_init, opt_update)

__all__ = [
    "init_train_state", "make_train_step", "make_compressed_train_step",
    "make_serve_step", "quantized_psum_mean", "init_error_fb",
    "param_leaves",
]


def param_leaves(params) -> Dict[str, torch.Tensor]:
    """The model's parameters as the reference's leaves (detached; the
    superblocks stacked into new tensors)."""
    with torch.no_grad():
        return stack_named((n, p.detach())
                           for n, p in params.named_parameters())


def init_train_state(gen: torch.Generator, cfg, oc: OptConfig,
                     device=None) -> Dict[str, Any]:
    """Random parameters from ``gen`` (``models.init_params``), trainable,
    zeroed optimizer state and step 0."""
    params = init_params(gen, cfg, device=device).requires_grad_(True)
    dev = next(params.parameters()).device
    return {
        "params": params,
        "opt": opt_init(param_leaves(params), oc),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _grads(params, cfg, batch, remat: bool):
    """(loss, metrics, gradients by port name) of ``loss_fn`` at
    ``params``; a parameter the loss does not reach gets zeros."""
    names, leaves = zip(*params.named_parameters())
    if not all(p.requires_grad for p in leaves):
        params = with_leaves(params, param_leaves(params), requires_grad=True)
        names, leaves = zip(*params.named_parameters())
    with torch.enable_grad():
        loss, metrics = loss_fn(params, cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(names, grads)))


def _apply(state, grads: Dict[str, torch.Tensor], oc: OptConfig):
    """Clip the reference-named ``grads`` and update: (new state without
    ``error_fb``, grad norm)."""
    params = state["params"]
    grads, gnorm = clip_by_global_norm(grads, oc.clip_norm)
    new_leaves, new_opt = opt_update(grads, state["opt"],
                                     param_leaves(params), state["step"], oc)
    new_state = {
        "params": with_leaves(params, new_leaves, requires_grad=True),
        "opt": new_opt, "step": state["step"] + 1,
    }
    return new_state, gnorm


def make_train_step(cfg, oc: OptConfig, *, remat: bool = True,
                    accum_steps: int = 1):
    """``accum_steps`` > 1 runs the microbatches in turn, accumulating f32
    gradients divided by ``accum_steps`` (the reference's scan)."""

    def train_step(state, batch):
        params = state["params"]
        if accum_steps == 1:
            loss, metrics, grads = _grads(params, cfg, batch, remat)
        else:
            micro = {k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                                  + v.shape[1:]) for k, v in batch.items()}
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.named_parameters()}
            losses, ms = [], []
            for i in range(accum_steps):
                l, m, g = _grads(params, cfg,
                                 {k: v[i] for k, v in micro.items()}, remat)
                grads = {n: a + g[n].float() / accum_steps
                         for n, a in grads.items()}
                losses.append(l)
                ms.append(m)
            loss = torch.mean(torch.stack(losses))
            metrics = {k: torch.mean(torch.stack([m[k] for m in ms]))
                       for k in ms[0]}
        with torch.no_grad():
            new_state, gnorm = _apply(state, stack_named(grads.items()), oc)
        return new_state, {"loss": loss, "grad_norm": gnorm, **metrics}

    return train_step


# ---------------------------------------------------------------------------
# int8 cross-pod gradient exchange (beyond-paper; SymED's tolerance idea
# generalized to the collective layer: bounded-error lossy wire format)
# ---------------------------------------------------------------------------

@torch.no_grad()
def quantized_psum_mean(pod_trees: List[Dict[str, torch.Tensor]],
                        error_fb=None):
    """Mean over pods in int8 with a shared per-leaf scale.

    ``pod_trees``: one reference-named gradient dict per pod (the pods of
    the reference's ``axis_name``); ``error_fb``: ``None``, one dict that
    every pod starts from, or one dict per pod.  The pods agree on
    ``scale = max(max over pods of amax, 1e-12) / 127`` (the reference's
    ``pmax``), quantize, and sum their codes in int32 (its ``psum``).
    Returns ``(mean dict, [new error_fb dict per pod])``: the mean in each
    gradient's dtype, each pod's local residual in bf16.
    """
    n = len(pod_trees)
    if error_fb is None or isinstance(error_fb, dict):
        error_fb = [error_fb] * n
    mean, resid = {}, [{} for _ in range(n)]
    for k, g0 in pod_trees[0].items():
        gf = [t[k].float() + (0.0 if e is None else e[k].float())
              for t, e in zip(pod_trees, error_fb)]
        amax = torch.amax(torch.stack([torch.amax(torch.abs(g))
                                       for g in gf]))
        scale = torch.clamp_min(amax, 1e-12) / 127.0
        total = None
        for i, g in enumerate(gf):
            q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
            resid[i][k] = (g - q.float() * scale).to(torch.bfloat16)
            q32 = q.to(torch.int32)
            total = q32 if total is None else total + q32
        mean[k] = (total.float() * scale / n).to(g0.dtype)
    return mean, resid


def _pod_devices(mesh) -> List[torch.device]:
    from repro_torch.launch.mesh import mesh_devices

    if "pod" not in mesh.axis_names:
        raise AssertionError("compressed step needs the multi-pod mesh")
    return [torch.device(d) for d in mesh_devices(mesh, ("pod",))]


def _on(tree: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in tree.items()}


def make_compressed_train_step(cfg, oc: OptConfig, mesh, *,
                               remat: bool = True):
    """Train step with an explicit int8 cross-pod gradient mean.

    ``mesh`` needs a ``pod`` axis; pod ``i`` runs on its first shard's
    device over rows ``[i * B / pods, (i + 1) * B / pods)`` of the batch.
    The state's ``error_fb`` is one dict per pod (``init_error_fb``'s dict
    stands for every pod at the first step); the metrics are the pods'
    means."""
    pod_devs = _pod_devices(mesh)
    npods = len(pod_devs)

    def train_step(state, batch):
        params = state["params"]
        home = next(params.parameters()).device
        per = next(iter(batch.values())).shape[0] // npods
        pod_grads, pod_metrics = [], []
        for i, dev in enumerate(pod_devs):
            p_i = params if dev == home else with_leaves(
                params, _on(param_leaves(params), dev), requires_grad=True)
            b_i = {k: v[i * per:(i + 1) * per].to(dev)
                   for k, v in batch.items()}
            loss, metrics, grads = _grads(p_i, cfg, b_i, remat)
            pod_grads.append(_on(stack_named(grads.items()), home))
            pod_metrics.append({"loss": loss.to(home),
                                **{k: v.to(home) for k, v in metrics.items()}})
        efb = state.get("error_fb")
        if isinstance(efb, (list, tuple)):
            efb = [_on(e, home) for e in efb]
        grads, new_efb = quantized_psum_mean(pod_grads, efb)
        with torch.no_grad():
            new_state, gnorm = _apply(state, grads, oc)
        new_state["error_fb"] = new_efb
        mean = lambda k: torch.mean(torch.stack([m[k] for m in pod_metrics]))
        return new_state, {"loss": mean("loss"), "grad_norm": gnorm,
                           "xent": mean("xent"), "aux": mean("aux")}

    return train_step


def init_error_fb(params) -> Dict[str, torch.Tensor]:
    """Zeroed error-feedback buffers (bf16) for the compressed step, as the
    reference's leaves."""
    return {k: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
            for k, p in param_leaves(params).items()}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def make_serve_step(cfg, *, temperature: float = 0.0):
    """``serve_step(params, state, token, generator=None) -> (next token
    (B, 1) int32, new state)``: greedy, or with ``temperature > 0`` and a
    ``generator`` (where the reference takes a key) a sample from the
    tempered softmax.  It records no graph, whatever the parameters."""

    @torch.no_grad()
    def serve_step(params, state, token, generator=None):
        logits, new_state = _decode_step(params, cfg, state, token)
        if temperature > 0.0 and generator is not None:
            probs = torch.softmax(logits[:, -1] / temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=generator)
            next_tok = next_tok.to(torch.int32)
        else:
            next_tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return next_tok, new_state

    return serve_step

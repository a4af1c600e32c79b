"""Shared by the port's train-step tests: one step of a reduced config in
both packages from the reference's state, and the acceptance tolerances
(``tests/test_torch_train.py`` states them)."""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS
from repro.models import loss_fn as jloss
from repro.sharding.partition import _path_str
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.models import loss_fn
from repro_torch.models.params import stack_named
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps

LOSS_REL, GRAD_REL, OPT_REL, LEFT_OUT = 1e-5, 1e-4, 1e-6, 1e-3
AT_STEP = 5  # past warmup (2): the schedule's lr is not 0
BATCH, SEQ = 4, 24


def _oc(mod, **kw):
    return mod.OptConfig(warmup_steps=2, total_steps=10, **kw)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)}
    shape = (BATCH, cfg.num_prefix_embeds, cfg.d_model)
    if cfg.frontend == "patches":
        b["prefix_embeds"] = (0.1 * rng.normal(size=shape)).astype(np.float32)
    if cfg.frontend == "frames":
        b["enc_frames"] = (0.1 * rng.normal(size=shape)).astype(np.float32)
    return b


def _jstate(cfg, oc):
    st = jsteps.init_train_state(jax.random.key(0), cfg, oc)
    st["step"] = jnp.asarray(AT_STEP, jnp.int32)
    return st


@functools.lru_cache(maxsize=None)
def _reference(arch, opt="adamw", accum=1):
    """The reference's state before the step, its gradients (accumulated
    over ``accum`` microbatches as its step does), the state after one
    step and its metrics, as numpy trees."""
    cfg = ARCHS[arch].reduced()
    oc = _oc(jopt, name=opt)
    st = _jstate(cfg, oc)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    step = jsteps.make_train_step(cfg, oc, remat=False, accum_steps=accum)

    def both(st, b):
        grads = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                             st["params"])
        per = BATCH // accum
        for i in range(accum):  # the step's microbatches, accumulated alike
            mb = {k: v[i * per:(i + 1) * per] for k, v in b.items()}
            g = jax.grad(lambda p: jloss(p, cfg, mb, remat=False)[0])(
                st["params"])
            grads = jax.tree.map(lambda a, gi: a + gi / accum, grads, g)
        return grads, step(st, b)

    grads, (new, metrics) = jax.jit(both)(st, batch)
    as_np = lambda t: jax.tree.map(np.asarray, t)
    grads = {_path_str(p): np.asarray(g) for p, g in
             jax.tree_util.tree_flatten_with_path(grads)[0]}
    return as_np(st), grads, as_np(new), as_np(metrics)


def _port_grads(params, cfg, batch, accum):
    names, leaves = zip(*params.named_parameters())
    total = [torch.zeros_like(p) for p in leaves]
    per = BATCH // accum
    for i in range(accum):
        mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        loss, _ = loss_fn(params, cfg, mb, remat=False)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        total = [a + g / accum for a, g in zip(total, grads)]
    return {k: v.detach().double().numpy()
            for k, v in stack_named(zip(names, total)).items()}


def _port_step(arch, opt="adamw", accum=1, remat=False, own=False):
    """The port's gradients, new state and metrics from the reference's
    state, or (``own``) from its own ``init_train_state``."""
    tcfg = TARCHS[arch].reduced()
    if own:
        state = tsteps.init_train_state(torch.Generator().manual_seed(0),
                                        tcfg, _oc(topt, name=opt))
        state["step"] = torch.tensor(AT_STEP, dtype=torch.int32)
    else:
        state = train_state_from_numpy(_reference(arch, opt, accum)[0], tcfg,
                                       device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    grads = _port_grads(state["params"], tcfg, batch, accum)
    new, metrics = tsteps.make_train_step(
        tcfg, _oc(topt, name=opt), remat=remat, accum_steps=accum)(
        state, batch)
    return grads, new, metrics


def _flat(tree):
    return {_path_str(p): np.asarray(v, np.float64) if v.dtype.itemsize != 2
            else v for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _check(arch, opt="adamw", accum=1):
    _, jgrads, jnew, jmet = _reference(arch, opt, accum)
    grads, new, metrics = _port_step(arch, opt, accum)
    for k in ("loss", "grad_norm", "xent", "aux"):
        want, got = float(jmet[k]), float(metrics[k])
        rel = LOSS_REL * max(abs(want), 1e-30) if k in ("loss", "grad_norm") \
            else LOSS_REL * max(abs(want), 1.0)
        assert abs(got - want) <= rel, f"{arch} {k}: {got} vs {want}"
    for k, g in jgrads.items():
        tol = GRAD_REL * max(float(np.abs(g).max()), 1e-6)
        err = float(np.abs(grads[k] - g).max())
        assert err <= tol, f"{arch} grad {k}: {err:.3e} > {tol:.3e}"
    want, got = _flat(jnew), _flat(train_state_to_numpy(new))
    assert sorted(got) == sorted(want)
    assert int(got["step"]) == AT_STEP + 1
    for name, w in want.items():
        if name == "step":
            continue
        pname = name.split("/", 2)[-1] if name.startswith("opt/") else \
            name.split("/", 1)[1]
        if opt == "adafactor" and name.startswith("opt/"):
            pname = pname.rsplit("/", 1)[0]
        g = jgrads[pname]
        e = np.abs(got[name] - w) / np.maximum(np.abs(w), 1.0)
        out = e > OPT_REL
        if out.shape != g.shape:  # Adafactor's factored rows and columns
            assert not out.any(), f"{arch} {name}: {e.max():.3e}"
            continue
        small = np.abs(g) <= 100 * GRAD_REL * max(float(np.abs(g).max()),
                                                 1e-6)
        assert not (out & ~small).any(), (
            f"{arch} {name}: {e[~small].max():.3e} where |g| is not small")
        assert out.mean() <= LEFT_OUT, f"{arch} {name}: {out.mean():.3%}"



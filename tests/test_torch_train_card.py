"""The training path on the card against the CPU port (``-m cuda``; skipped
without a card).  This file imports no JAX: the CPU port, which the other
``test_torch_train*`` files hold to the reference, is the reference here.

* ``dense``'s bf16 backward (the port of ``_matmul_bf16_grads``): every
  gradient element within one bf16 ulp of the CPU's, at least 99% equal
  (cuBLAS and the CPU sum their f32 terms in different orders before the
  one rounding);
* one ``make_train_step`` step of reduced configs in f32: the loss and the
  grad norm within 1e-5 relative, the parameters and moments after it
  within ``1e-6 x max(|cpu|, 1)`` except where the gradient is at most
  ``1e-2 x`` its leaf's largest (at most 0.1% of a leaf left out).
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.models import loss_fn
from repro_torch.models import layers
from repro_torch.models.params import stack_named
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.steps import (init_train_state, make_train_step,
                                     param_leaves)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ulps(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    key = lambda t: (lambda v: np.where(v < 0, -(v & 0x7FFF), v))(
        t.cpu().view(torch.int16).numpy().astype(np.int64))
    return np.abs(key(a) - key(b))


@pytest.mark.cuda
@pytest.mark.parametrize("xshape,wshape", [((4, 64, 768), (768, 3072)),
                                           ((256, 96), (96, 40))])
def test_dense_bf16_backward_card_against_cpu(xshape, wshape):
    dev = _cuda()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(xshape, generator=gen).to(torch.bfloat16)
    w = (torch.randn(wshape, generator=gen) * wshape[0] ** -0.5).to(
        torch.bfloat16)
    g = torch.randn(xshape[:-1] + wshape[1:], generator=gen).to(
        torch.bfloat16)
    out = []
    for d in ("cpu", dev):
        tx = x.to(d).requires_grad_(True)
        tw = w.to(d).requires_grad_(True)
        layers.dense(tx, tw).backward(g.to(d))
        out.append((tx.grad, tw.grad))
    for (a, b), name in zip(zip(*out), ("dx", "dw")):
        assert b.dtype == torch.bfloat16, name
        u = _ulps(a, b)
        assert u.max() <= 1 and (u == 0).mean() >= 0.99, (name, u.max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "olmoe-1b-7b",
                                  "xlstm-125m"])
def test_train_step_card_against_cpu(arch):
    dev = _cuda()
    cfg = get_config(arch).reduced()
    oc = OptConfig(warmup_steps=2, total_steps=10)
    cpu = init_train_state(torch.Generator().manual_seed(0), cfg, oc)
    cpu["step"] = torch.tensor(5, dtype=torch.int32)
    card = train_state_from_numpy(train_state_to_numpy(cpu), cfg, dev)
    toks = torch.randint(0, cfg.vocab, (4, 25), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    names, leaves = zip(*cpu["params"].named_parameters())
    grads = stack_named(zip(names, torch.autograd.grad(
        loss_fn(cpu["params"], cfg, {"tokens": toks})[0], leaves)))
    step = make_train_step(cfg, oc)
    want, wm = step(cpu, {"tokens": toks})
    got, gm = step(card, {"tokens": toks.to(dev)})
    for k in ("loss", "grad_norm"):
        assert abs(float(gm[k]) - float(wm[k])) <= 1e-5 * abs(float(wm[k]))
    gp, wp = param_leaves(got["params"]), param_leaves(want["params"])
    for k, g in grads.items():
        small = g.abs() <= 1e-2 * max(float(g.abs().max()), 1e-6)
        for a, b in ((gp[k], wp[k]), (got["opt"]["m"][k], want["opt"]["m"][k]),
                     (got["opt"]["v"][k], want["opt"]["v"][k])):
            e = (a.cpu().double() - b.double()).abs() / b.double().abs(
            ).clamp_min(1.0)
            out = e > 1e-6
            assert not (out & ~small).any(), (arch, k, float(e.max()))
            assert float(out.float().mean()) <= 1e-3, (arch, k)

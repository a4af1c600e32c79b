"""The teacher-forcing gap of the port's LM serving path in bf16.

For each architecture at a mid width (d_model 512, 8 heads of
64, d_ff 1024, vocab 8192, 2 superblocks, window 32, at most 16 experts
top-4 at no-drop capacity) in bf16: the last logits of ``prefill(n0)``
plus 4 ``decode_step``s against ``prefill(n0 + 4)``, as max |diff| and
relative to max(max |logits|, 1).  ``chip_smoke.py`` phase 10 (c) holds
the full-width gap to a bound; this estimates it where a run is cheap.

  PYTHONPATH=src python examples/torch_serve_bf16_gap.py --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.serve import frontend_inputs
from repro_torch.models import decode_step, init_params, prefill


def gap(arch: str, device, n0: int = 32, steps: int = 4, batch: int = 4):
    full = get_config(arch)
    cfg = dataclasses.replace(
        full.reduced(), dtype="bfloat16", d_model=512, head_dim=64,
        n_heads=8, n_kv_heads=(min(full.n_kv_heads, 8)
                               if full.n_kv_heads < full.n_heads else 8),
        d_ff=1024 if full.d_ff else 0, vocab=8192,
        n_experts=min(full.n_experts, 16), top_k=min(full.top_k, 4),
        n_blocks=2, window=32)
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=float(cfg.n_experts) / cfg.top_k)
    params = init_params(torch.Generator(device).manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (batch, n0 + steps)).astype(np.int32)).to(device)
    kw, prefix_len = frontend_inputs(cfg, batch, device)
    gen = torch.Generator(device).manual_seed(3)
    kw = {k: 0.1 * torch.randn(v.shape, generator=gen, device=device)
          for k, v in kw.items()}
    max_len = n0 + steps + prefix_len + 8
    with torch.inference_mode():
        want, _ = prefill(params, cfg, toks, max_len=max_len, **kw)
        got, state = prefill(params, cfg, toks[:, :n0], max_len=max_len, **kw)
        for i in range(n0, n0 + steps):
            got, state = decode_step(params, cfg, state, toks[:, i: i + 1])
    err = float((want - got).abs().max())
    return err, err / max(float(want.abs().max()), 1.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for arch in sorted(ARCHS):
        err, rel = gap(arch, device)
        print(f"{arch}: max |diff| {err:.4f}, {rel:.4f} of max(max|logits|, 1)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

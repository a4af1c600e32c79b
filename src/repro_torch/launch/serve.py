"""Batched serving: prefill a prompt batch, decode greedily.

Port of ``repro.launch.serve``.  Reduced configs run anywhere; ``--full``
builds the public configuration at full width and depth, its random
weights drawn straight onto the device in the model dtype.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
      --batch 4 --prompt-len 32 --gen 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --full     # on cuda
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import init_params, prefill
from repro_torch.train.steps import make_serve_step


def frontend_inputs(cfg, batch: int, device=None):
    """Stub modality inputs + the decoder-sequence prefix they prepend.

    Returns ``(kw, prefix_len)``.  ``prefix_len`` is derived from the input
    that actually gets *prepended* to the decoder sequence
    (``prefix_embeds``; encoder memories consumed via cross-attention add
    no decoder positions) -- the one rule ``prefill`` itself applies when it
    computes ``s_total``.  Deriving the KV allocation from the same kw dict,
    instead of re-matching on the frontend name, keeps the two accountings
    from drifting: a frontend whose prefix is miscounted makes decode write
    past the KV allocation on long generations.
    """
    device = resolve_device(device)
    kw = {}
    shape = (batch, cfg.num_prefix_embeds, cfg.d_model)
    if cfg.frontend == "patches":
        kw["prefix_embeds"] = torch.zeros(shape, dtype=torch.float32,
                                          device=device)
    if cfg.frontend == "frames":
        kw["enc_frames"] = torch.zeros(shape, dtype=torch.float32,
                                       device=device)
    prefix_len = sum(v.shape[1] for k, v in kw.items() if k == "prefix_embeds")
    return kw, prefix_len


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve(cfg, *, batch: int, prompt_len: int, gen: int,
          temperature: float = 0.0, seed: int = 0, device=None):
    """Random weights from ``seed``, a random prompt batch from ``seed +
    1``; prefill, then ``gen - 1`` decode steps.  The loop passes no
    generator to the step, so it is greedy at any ``temperature``, as the
    reference's.  ``device``: ``cuda`` unless ``"cpu"`` is passed.
    Returns ``(tokens (batch, gen) int32, stats)``."""
    device = resolve_device(device)
    params = init_params(torch.Generator(device).manual_seed(seed), cfg)
    prompts = torch.randint(
        0, cfg.vocab, (batch, prompt_len), device=device,
        generator=torch.Generator(device).manual_seed(seed + 1))
    kw, prefix_len = frontend_inputs(cfg, batch, device)

    max_len = prompt_len + prefix_len + gen
    _sync(device)
    t0 = time.perf_counter()
    logits, state = prefill(params, cfg, prompts, max_len=max_len, **kw)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    # the decode loop writes KV at positions [pos, pos + gen - 2]; if the
    # prefix accounting above ever disagrees with prefill's s_total, fail
    # loudly here instead of writing past the cache
    pos0 = int(state["pos"])
    if pos0 != prompt_len + prefix_len or pos0 + gen - 1 > max_len:
        raise AssertionError(
            f"KV allocation mismatch: prefill starts decode at pos {pos0} "
            f"with {gen - 1} steps but max_len={max_len}")

    step = make_serve_step(cfg, temperature=temperature)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        tok, state = step(params, state, tok)
        out.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    tokens = torch.cat(out, dim=1)
    return tokens, {
        "prefill_s": t_prefill,
        "decode_s_per_token": t_decode / max(gen - 1, 1),
        "tokens_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tokens, stats = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                          gen=args.gen, temperature=args.temperature,
                          device=args.device)
    print(f"[serve] {args.arch}{' (reduced)' if args.reduced else ''}: "
          f"generated {tuple(tokens.shape)} tokens")
    print(f"[serve] prefill {stats['prefill_s']:.3f}s, "
          f"decode {1e3 * stats['decode_s_per_token']:.1f}ms/tok, "
          f"{stats['tokens_per_s']:.1f} tok/s")
    print(f"[serve] sample row: {np.asarray(tokens[0].cpu())[:16]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Training launcher: data pipeline -> train loop with checkpointing,
SymED telemetry, straggler watchdog, and elastic restart.

Port of ``repro.launch.train``: the same loop, flags and output, on one
device (``cuda`` unless ``--device cpu``).  The step is the port's
``make_train_step``, run eagerly; the pipeline symbolizes on the same
device in its background thread.  The report also holds each step's
seconds and the seconds it waited on the batcher (the port's own
measurements; the CLI prints them after the reference's lines).  An
elastic restart onto a new mesh is ``launch.elastic.resume_on_mesh``.  The CLI
also takes ``--ckpt-every`` and ``--log-every``, ``train_loop``'s own
parameters at its defaults, which the reference's CLI does not expose.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
      --reduced --steps 50 --batch 8 --seq 256 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train      # symlm-100m, cuda
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, attn
from repro_torch.core.symed import SymEDConfig
from repro_torch.data import SymbolPipeline, SymbolTokenizer, TokenBatcher
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.train.telemetry import StepWatchdog, TelemetryHub

__all__ = ["train_loop", "lm100m_config", "cli_config", "main"]


def lm100m_config(vocab: int) -> ModelConfig:
    """~100M-param decoder-only LM for the end-to-end example."""
    return ModelConfig(
        name="symlm-100m", family="dense", d_model=768, n_heads=12,
        n_kv_heads=12, d_ff=3072, vocab=vocab, head_dim=64,
        block_pattern=(attn("global"),), n_blocks=12, mlp_kind="swiglu",
        tie_embeddings=True, supports_long_ctx=False, dtype="float32",
    )


def train_loop(
    cfg: ModelConfig,
    *,
    steps: int = 50,
    batch: int = 8,
    seq: int = 256,
    lr: float = 3e-4,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 25,
    symed: Optional[SymEDConfig] = None,
    resume: bool = True,
    log_every: int = 5,
    fail_at_step: Optional[int] = None,
    device=None,
):
    """Runs the full production loop on ``device`` (``cuda`` unless told
    otherwise)."""
    device = resolve_device(device)
    symed = symed or SymEDConfig(tol=0.5, alpha=0.02, n_max=256, k_max=64,
                                 len_max=128)
    tok = SymbolTokenizer(k_max=symed.k_max)
    assert cfg.vocab >= tok.vocab_size, "config vocab must cover the tokenizer"

    pipe = SymbolPipeline(symed, tok, stream_len=1024, slab=32, device=device)
    batcher = TokenBatcher(pipe, batch, seq + 1)
    batches = iter(batcher)  # its thread starts at the first batch

    oc = OptConfig(lr=lr, warmup_steps=max(steps // 10, 1), total_steps=steps)
    step_fn = make_train_step(cfg, oc)

    state = init_train_state(torch.Generator(device).manual_seed(0), cfg, oc)
    mgr = CheckpointManager(ckpt_dir, every=ckpt_every) if ckpt_dir else None
    start = 0
    if mgr and resume:
        restored, manifest = mgr.restore_latest(state)
        if restored is not None:
            state = restored
            start = int(manifest["step"])
            print(f"[train] resumed from step {start}")

    hub = TelemetryHub(tol=0.3, alpha=0.05)
    dog = StepWatchdog()
    history, step_s, wait_s = [], [], []
    try:
        for step in range(start, steps):
            t_wait = time.perf_counter()
            toks = next(batches)
            wait_s.append(time.perf_counter() - t_wait)
            dog.start_step()
            t_step = time.perf_counter()
            tokens = torch.from_numpy(toks[:, :seq + 1]).to(device)
            state, metrics = step_fn(state, {"tokens": tokens})
            names = sorted(metrics)  # the reference's (jitted) dict order
            values = dict(zip(names, torch.stack(
                [metrics[k].float() for k in names]).tolist()))  # one sync
            step_s.append(time.perf_counter() - t_step)
            ev = dog.end_step(step)
            if ev:
                print(f"[watchdog] {ev['kind']} at step {ev['step']}: "
                      f"{ev['dt']:.2f}s (z={ev['z']:.1f})")
            hub.record_metrics("host0", values)
            history.append(values["loss"])
            if step % log_every == 0:
                print(f"[train] step {step}: loss={history[-1]:.4f} "
                      f"grad_norm={values['grad_norm']:.3f}")
            if mgr:
                mgr.maybe_save(step + 1, state)
            if fail_at_step is not None and step + 1 == fail_at_step:
                raise RuntimeError(
                    f"simulated node failure at step {step + 1}")
    finally:  # no symbolizing thread outlives the loop
        batcher.close()

    report = hub.traffic_report()
    tele_raw = sum(r["raw_bytes"] for r in report.values())
    tele_wire = sum(r["wire_bytes"] for r in report.values())
    print(f"[telemetry] raw={tele_raw}B wire={tele_wire}B "
          f"cr={tele_wire / max(tele_raw, 1):.3f} across {len(report)} streams")
    return state, {"loss_history": history, "telemetry": report,
                   "watchdog_events": dog.events, "step_seconds": step_s,
                   "wait_seconds": wait_s}


def cli_config(arch: Optional[str], reduced: bool) -> ModelConfig:
    """The CLI's model: ``arch`` (``reduced()`` if asked) or symlm-100m,
    its vocab grown to cover the tokenizer's."""
    tok_vocab = SymbolTokenizer(k_max=64).vocab_size
    if arch:
        cfg = get_config(arch)
        if reduced:
            cfg = cfg.reduced()
    else:
        cfg = lm100m_config(vocab=max(tok_vocab, 128))
    return dataclasses.replace(cfg, vocab=max(cfg.vocab, tok_vocab))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id; default: symlm-100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="raise a simulated node failure at this step")
    ap.add_argument("--ckpt-every", type=int, default=25,
                    help="checkpoint every N steps (train_loop's default)")
    ap.add_argument("--log-every", type=int, default=5,
                    help="print the loss every N steps (train_loop's default)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)

    cfg = cli_config(args.arch, args.reduced)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    _, report = train_loop(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        log_every=args.log_every, fail_at_step=args.fail_at_step,
        device=device,
    )
    print(f"[train] done in {time.perf_counter() - t0:.1f}s; "
          f"final loss {report['loss_history'][-1]:.4f}")
    step_s, wait_s = report["step_seconds"], report["wait_seconds"]
    after = step_s[1:] or step_s
    ms = 1e3 * sum(after) / len(after)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    print(f"[train] {ms:.1f} ms/step after the first, "
          f"{args.batch * args.seq / (ms / 1e3):.0f} tokens/s, "
          f"data wait {sum(wait_s) / len(wait_s):.3f} s/batch "
          f"(first {wait_s[0]:.3f} s), peak memory {peak} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())

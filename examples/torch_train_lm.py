"""End to end: train a language model ON SymED SYMBOL STREAMS.

The port's counterpart of ``examples/train_lm.py``: the same presets and
output, through ``repro_torch.launch.train.train_loop`` on ``--device``
(default cuda).

The paper's pitch is analytics directly on symbols; the framework's flagship
analytic is sequence modeling: fleets of sensors are SymED-compressed, the
symbol streams become tokens, and the model zoo trains on them.

Default preset is CPU-friendly (~6M params, 60 steps, visibly falling loss).
``--full`` switches to the ~100M-param config of the deliverable (same code
path; a few hundred steps is a TPU-or-overnight run on this container):

  PYTHONPATH=src python examples/torch_train_lm.py            # quick preset
  PYTHONPATH=src python examples/torch_train_lm.py --full --steps 300
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 6
"""
import argparse

from repro_torch.configs.base import ModelConfig, attn
from repro_torch.data.tokenizer import SymbolTokenizer
from repro_torch.launch.train import lm100m_config, train_loop


def small_config(vocab: int) -> ModelConfig:
    return ModelConfig(
        name="symlm-6m", family="dense", d_model=192, n_heads=4, n_kv_heads=4,
        d_ff=768, vocab=vocab, head_dim=48, block_pattern=(attn("global"),),
        n_blocks=6, mlp_kind="swiglu", tie_embeddings=True,
        supports_long_ctx=False, dtype="float32",
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="~100M-param config")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)

    vocab = SymbolTokenizer(k_max=64).vocab_size
    cfg = lm100m_config(vocab) if args.full else small_config(vocab)
    n = cfg.param_count()
    print(f"[train_lm] {cfg.name}: {n / 1e6:.1f}M params, vocab={cfg.vocab} "
          f"(SymED symbols), {args.steps} steps @ batch={args.batch} seq={args.seq}")

    _, report = train_loop(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, device=args.device,
    )
    hist = report["loss_history"]
    print(f"[train_lm] loss {hist[0]:.3f} -> {hist[-1]:.3f} "
          f"({100 * (1 - hist[-1] / hist[0]):.1f}% reduction)")


if __name__ == "__main__":
    main()

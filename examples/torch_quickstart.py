"""Quickstart in PyTorch: the paper's running example (Fig. 3).

The port's counterpart of ``examples/quickstart.py``.  A ~230-point stream
is pushed through the full SymED pipeline -- sender (online normalization
+ O(1) compression), one-float-per-piece wire, receiver (piece
construction + online k-means digitization) -- then reconstructed both
ways and scored with DTW.  On the card the digitizer's Lloyd loop runs in
the k-means kernel and the scores in the DTW kernel.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs.symed_paper import PAPER_RUNNING_EXAMPLE
from repro_torch.core import prng, symed_encode, symbols_to_string


def make_series(n=230, seed=7):
    """Noisy two-regime series, qualitatively like the paper's Fig. 1/3."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n)
    base = np.where(t < 0.35, 2.2 * t / 0.35, 2.2 - 1.4 * (t - 0.35) / 0.3)
    base = np.where(t > 0.65, 0.8 + 2.0 * (t - 0.65), base)
    return (base + rng.normal(0, 0.08, n)).astype(np.float32)


def ascii_plot(series, recon, width=72, height=12):
    lo, hi = min(series.min(), recon.min()), max(series.max(), recon.max())
    rows = [[" "] * width for _ in range(height)]
    for arr, ch in ((series, "."), (recon, "#")):
        idx = np.linspace(0, len(arr) - 1, width).astype(int)
        for x, i in enumerate(idx):
            y = int((arr[i] - lo) / (hi - lo + 1e-9) * (height - 1))
            rows[height - 1 - y][x] = ch
    return "\n".join("".join(r) for r in rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where the pipeline runs (default: cuda)")
    args = ap.parse_args(argv)
    ts = make_series()
    cfg = PAPER_RUNNING_EXAMPLE  # tol=0.4, alpha=0.02, scl=0 (1D), paper Sec. 4.2
    out = symed_encode(ts, cfg, prng.key(0), device=args.device)

    n = int(out["n_pieces"])
    print(f"stream length        : {len(ts)} points ({4 * len(ts)} raw bytes)")
    print(f"pieces transmitted   : {n}  ({int(out['wire_bytes'])} wire bytes)")
    print(f"compression rate     : {float(out['cr']):.3f}  (paper avg 0.095)")
    print(f"dimension reduction  : {float(out['drr']):.3f}")
    print(f"alphabet size k      : {int(out['k'])}")
    print(f"symbols              : {symbols_to_string(out['symbols'], out['n_pieces'])}")
    print(f"DTW error (pieces)   : {float(out['re_pieces']):.3f}   <- online reconstruction")
    print(f"DTW error (symbols)  : {float(out['re_symbols']):.3f}   <- offline reconstruction")
    print()
    print("original (.) vs online reconstruction (#):")
    print(ascii_plot(ts, out["recon_pieces"].cpu().numpy()))


if __name__ == "__main__":
    main()

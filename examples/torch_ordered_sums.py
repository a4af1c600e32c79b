"""What the digitizer's reductions in the CPU's order cost on the card.

``core.digitize.scale_coords`` and ``max_cluster_variance`` sum in the
order the reference's compiled CPU program does when asked
(``ordered=True``, about 50 small launches for 512 rows) and with one
``torch.sum`` otherwise.  ABBA asks for the order on every device; the
stream service's table step does not.  This times one call of each, both
ways, at the service's table shapes (``--slots`` slots of the paper's
``n_max`` pieces and ``k_max`` clusters), on the card, each call synced:
the median over ``--reps`` calls.  The service calls
``max_cluster_variance`` once per pass of its k-search loop (one host sync
each) and ``scale_coords`` once per table step.

  PYTHONPATH=src python examples/torch_ordered_sums.py --slots 256
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import PAPER_SYMED
from repro_torch.core import digitize as dg


def _table(slots: int, device, seed: int = 0):
    """A digitizer table: pieces, mask, labels and centers per slot."""
    n_max, k_max = PAPER_SYMED.n_max, PAPER_SYMED.k_max
    gen = torch.Generator(device).manual_seed(seed)
    pieces = torch.rand((slots, n_max, 2), generator=gen, device=device)
    n = torch.randint(PAPER_SYMED.k_min, n_max + 1, (slots,), generator=gen,
                      device=device)
    mask = torch.arange(n_max, device=device)[None, :] < n[:, None]
    k = torch.randint(PAPER_SYMED.k_min, k_max + 1, (slots,), generator=gen,
                      device=device).to(torch.int32)
    labels = (torch.randint(0, k_max, (slots, n_max), generator=gen,
                            device=device) % k[:, None]).to(torch.int32)
    centers = torch.rand((slots, k_max, 2), generator=gen, device=device)
    return pieces, mask, labels, centers, k


def _median_ms(fn, device, reps: int) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def measure(slots: int, device, reps: int) -> dict:
    pieces, mask, labels, centers, k = _table(slots, device)
    out = {"slots": slots, "n_max": PAPER_SYMED.n_max,
           "k_max": PAPER_SYMED.k_max, "reps": reps}
    for ordered in (False, True, False, True):
        key = "ordered" if ordered else "torch_sum"

        def mcv():
            return dg.max_cluster_variance(pieces, mask, centers, labels, k,
                                           ordered=ordered)

        def sc():
            return dg.scale_coords(pieces, mask, PAPER_SYMED.scl,
                                   ordered=ordered)

        mcv(), sc()   # warm up
        # the second pass of each way is the one kept
        out[f"max_cluster_variance_ms_{key}"] = _median_ms(mcv, device, reps)
        out[f"scale_coords_ms_{key}"] = _median_ms(sc, device, reps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--slots", type=int, default=256)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("times the card: run with --device cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi)
    print(json.dumps(measure(args.slots, device, args.reps)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

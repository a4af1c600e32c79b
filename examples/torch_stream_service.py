"""Resident SymED session service in PyTorch, in miniature.

The port's counterpart of ``examples/stream_service.py``.  Three sensor
streams connect to one ``StreamServer``; their windows arrive interleaved
and ragged, and symbols leave the service *while the streams are still
running* -- each ``ingest`` returns the symbol-delta frame the paper's
downstream consumers would read off the wire.  At the end, each session's
closing output is what the offline ``symed_encode`` would have produced.
On the card the slot table's Lloyd loops run in the k-means kernel and the
online DTW monitor in the DTW kernel.

Run:  PYTHONPATH=src python examples/torch_stream_service.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.symed import SymEDConfig, symbols_to_string
from repro_torch.launch.stream import StreamServer


def make_streams(n, length, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 14, length)
    return [
        (np.cumsum(rng.normal(0, 0.3, length))
         + 2.0 * np.sin(t + i)).astype(np.float32)
        for i in range(n)
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where the slot table lives (default: cuda)")
    args = ap.parse_args(argv)
    length, window = 384, 48
    cfg = SymEDConfig(tol=0.4, alpha=0.02, n_max=128, k_max=16, len_max=128)
    server = StreamServer(cfg, max_sessions=4, window_cap=window,
                          digitize_every_k=1, dtw_every=4,
                          device=args.device)
    streams = make_streams(3, length, seed=7)
    sids = [f"sensor-{i}" for i in range(3)]
    for sid in sids:
        server.open(sid)

    rng = np.random.default_rng(1)
    cursors = [0] * 3
    print(f"{'tick':>4}  {'session':<9} {'arrived':>7} {'delta':>5}  symbols")
    tick = 0
    while any(c < length for c in cursors):
        tick += 1
        batch = {}
        for i, sid in enumerate(sids):
            if cursors[i] >= length or rng.random() < 0.3:
                continue  # this sensor is quiet this tick
            n = int(rng.integers(16, 2 * window))
            batch[sid] = streams[i][cursors[i]: cursors[i] + n]
            cursors[i] = min(cursors[i] + n, length)
        for sid, delta in server.ingest_many(batch).items():
            if delta["n_new"]:
                syms = symbols_to_string(delta["labels"], delta["n_new"])
                print(f"{tick:>4}  {sid:<9} {len(batch[sid]):>7} "
                      f"{delta['n_new']:>5}  +{syms!r}")

    print("\n-- closing sessions " + "-" * 40)
    for sid in sids:
        res = server.close(sid)
        print(f"{sid}: {res['n_pieces']} pieces -> {res['symbols']!r}"
              + (f"  (DTW monitor {res['dtw']:.2f})" if res["dtw"] else ""))

    rep = server.report(1.0)
    print(f"\nwire in  : {int(rep['bytes_in'])} bytes "
          f"({int(rep['points_in'])} points)")
    print(f"wire out : {int(rep['bytes_out'])} bytes "
          f"({int(rep['symbols_out'])} symbols in "
          f"{int(rep['frames_out'])} delta frames, "
          f"{int(rep['steps'])} batched table steps)")


if __name__ == "__main__":
    main()

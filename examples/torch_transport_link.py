"""Minimal real sender->receiver link over a loopback socket, in PyTorch.

The port's counterpart of ``examples/transport_link.py``: a
``TransportServer`` (edge node) in a background thread, and two
``SenderClient``s (IoT nodes) in the same process -- one shipping raw
windows, one running the SymED compressor locally and shipping only
finished piece tuples.  Both receive the edge's symbol-delta frames back
over the socket; the pieces sender shows the paper's wire saving.  The
server and the pieces sender run on ``--device``.

    PYTHONPATH=src python examples/torch_transport_link.py [--device cpu]
"""
import argparse
import threading

import numpy as np

from repro_torch.core.symed import SymEDConfig
from repro_torch.data import make_fleet
from repro_torch.launch.stream import StreamServer
from repro_torch.launch.transport import (SenderClient, TransportServer,
                                          session_seed)

N_STREAMS, LENGTH, WINDOW = 3, 256, 32


def run_sender(port: int, cfg: SymEDConfig, mode: str, data: np.ndarray,
               device):
    client = SenderClient("127.0.0.1", port, cfg, mode=mode, device=device)
    sids = [f"{mode}-{i}" for i in range(len(data))]
    for sid in sids:
        client.open(sid, session_seed(sid, 0))
    for c in range(0, LENGTH, WINDOW):          # interleave the sessions
        for i, sid in enumerate(sids):
            client.send(sid, data[i, c: c + WINDOW])
    results = {sid: client.close(sid) for sid in sids}
    symbols = sum(r["n_pieces"] for r in results.values())
    points = sum(r["t_seen"] for r in results.values())
    print(f"  {mode:>6} sender: {len(sids)} sessions, {points} points -> "
          f"{symbols} symbols, {int(client.payload_bytes)} payload B "
          f"({client.payload_bytes / (4 * points):.3f} of raw)")
    client.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where the server and the compressor run "
                         "(default: cuda)")
    args = ap.parse_args(argv)
    cfg = SymEDConfig(tol=0.5, alpha=0.01, n_max=256, k_max=32, len_max=256)
    server = StreamServer(cfg, max_sessions=8, window_cap=WINDOW,
                          digitize_every_k=1, autoscale=True, min_slots=1,
                          device=args.device)
    transport = TransportServer(server, port=0)
    thread = threading.Thread(
        target=transport.serve,
        kwargs={"expect_sessions": 2 * N_STREAMS}, daemon=True)
    thread.start()
    print(f"edge receiver listening on 127.0.0.1:{transport.port}")

    data = make_fleet(N_STREAMS, LENGTH, seed=4)
    for mode in ("pieces", "raw"):
        run_sender(transport.port, cfg, mode, data, args.device)
    thread.join(timeout=60)

    rep = server.report(1.0)
    print(f"edge totals: {int(rep['points_in'])} points in, "
          f"{int(rep['wire_in_bytes'])} wire-in B "
          f"(ratio {rep['wire_in_ratio']:.3f}), "
          f"{int(rep['bytes_out'])} wire-out B in "
          f"{int(rep['frames_out'])} delta frames; "
          f"table grew {int(rep['grows'])}x, shrank {int(rep['shrinks'])}x")


if __name__ == "__main__":
    main()

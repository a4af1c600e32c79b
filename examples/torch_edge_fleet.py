"""Fleet-scale SymED in PyTorch: symbolize many streams, sharded over a mesh.

The port's counterpart of ``examples/edge_fleet.py``, driven through the
``repro_torch.launch.fleet`` runtime: every shard owns a slab of
sender+receiver pairs (the ``data`` axis, or the flattened ``pod x data``
grid with ``--pods``), ingestion is the streaming receiver (``--chunk``
windows with ``--digitize-every`` cadence, so symbols stream out online),
and wire traffic / compression rate are reduced fleet-wide in the
reference's hierarchical order.  Every stream is rebuilt from its pieces
and from its symbols and scored in DTW space: on the card through the DTW
kernel, with the shards' Lloyd loops in the k-means kernel.

Run:  PYTHONPATH=src python examples/torch_edge_fleet.py --streams 256 \
          --length 1024 --device cuda
(``--device cpu`` runs the plain versions on host shards; ``--devices N``
asks for N shards, round-robin over the cards on CUDA)
"""
import argparse
import time

from repro_torch.core import prng
from repro_torch.core.symed import SymEDConfig
from repro_torch.data.synthetic import make_fleet
from repro_torch.launch.fleet import (
    describe_ingestion, fleet_report, resolve_fleet_mesh, run_fleet,
    validate_cli_args,
)
from repro_torch.launch.mesh import describe_devices, device_count


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--length", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=None,
                    help="streaming ingestion window; 0 = whole-stream "
                         "(default: min(256, length))")
    ap.add_argument("--digitize-every", type=int, default=1,
                    help="digitize cadence k (symbols stream out every k "
                         "windows; 0 = once at end-of-stream)")
    ap.add_argument("--pods", type=int, default=1,
                    help="shard over a (pod, data) mesh with this many pods")
    ap.add_argument("--devices", type=int, default=None,
                    help="shards (default: one per device of the kind)")
    ap.add_argument("--tol", type=float, default=0.5)
    ap.add_argument("--alpha", type=float, default=0.01)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where the shards run")
    args = ap.parse_args()

    if args.chunk is None:
        args.chunk = min(256, args.length)  # default adapts to short streams
    if not args.chunk:
        args.digitize_every = 0  # cadence default is meaningless whole-stream
    validate_cli_args(ap, args)
    n_dev = args.devices or device_count(args.device)
    try:
        mesh, mesh_axes, layout = resolve_fleet_mesh(args.pods, n_dev,
                                                     device=args.device)
    except ValueError as e:
        ap.error(str(e))
    streams = max(args.streams - args.streams % n_dev, n_dev)
    fleet = make_fleet(streams, args.length, seed=0)
    cfg = SymEDConfig(tol=args.tol, alpha=args.alpha, n_max=256, k_max=32,
                      len_max=256)

    t0 = time.perf_counter()
    out, tele = run_fleet(
        fleet, cfg, prng.key(0), mesh,
        chunk_len=args.chunk or None,
        digitize_every_k=args.digitize_every or None,
        reconstruct=True, axis=mesh_axes,
    )
    rep = fleet_report(tele, time.perf_counter() - t0)

    n_pieces = out["n_pieces"].float()
    mode = describe_ingestion(args.chunk, args.digitize_every)
    print(f"devices                 : {n_dev}  ({layout}; "
          f"{describe_devices(mesh.devices.flat)})")
    print(f"ingestion               : {mode}")
    print(f"streams                 : {streams} x {args.length} points")
    print(f"wall time               : {rep['wall_seconds']:.2f}s "
          f"({rep['points_per_s'] / 1e6:.2f} Mpoints/s)")
    print(f"symbol latency          : {rep['ms_per_symbol']:.3f} ms/symbol "
          f"(paper: 42ms single-CPU)")
    print(f"mean pieces/stream      : {n_pieces.mean().item():.1f}")
    print(f"mean compression rate   : {rep['compression_rate']:.4f} "
          f"(paper avg 0.095)")
    print(f"fleet raw bytes         : {int(rep['raw_bytes']):,}")
    print(f"fleet wire bytes        : {int(rep['wire_bytes']):,} "
          f"({100 * rep['compression_rate']:.1f}% of raw)")
    print(f"fleet wire-out bytes    : {int(rep['wire_out_bytes']):,} "
          f"(symbol-delta frames, {rep['wire_out_ratio']:.2f}x wire in)")
    print(f"mean DTW err (pieces)   : {out['re_pieces'].mean().item():.3f}")
    print(f"mean DTW err (symbols)  : {out['re_symbols'].mean().item():.3f}")
    print(f"mean alphabet size      : {out['k'].float().mean().item():.1f}")


if __name__ == "__main__":
    main()

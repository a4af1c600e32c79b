"""Sharded SymED fleet runtime: distributed senders -> edge receivers at scale.

Port of ``repro.launch.fleet``.  A slab of ``(n_streams, T)`` sensor
streams is split over the shards of a mesh (``repro_torch.launch.mesh``);
every shard owns a sub-slab of sender+receiver pairs, lives on its mesh
device and runs the batched SymED pipeline there; fleet-level telemetry
(wire bytes, pieces, compression rate) is reduced hierarchically.  One
process drives every shard, as the reference's one controller drives its
devices: shard ``i`` runs on ``mesh.devices.flat[i]``, and on one card
every shard shares it.

Ingestion modes:

  * **whole-stream** (``chunk_len=None``): one batched sender and one
    receiver pass per shard;
  * **streaming receiver** (``chunk_len=C``): the stream is processed in
    ``C``-point windows through the resumable ``ReceiverState``.  What
    crosses each window boundary is O(n_max) per stream: the O(1) sender
    ``CompressorState``, the padded wire buffers and the resumable
    ``DigitizerState``.  ``digitize_every_k = k`` digitizes the newly
    arrived pieces every ``k`` windows (resolved on the host per window, as
    the reference does), so symbols stream out while points arrive;
    ``k=0``/``None`` defers digitization to end-of-stream.

Telemetry reduction (the reference's ``psum`` tree): each shard makes its
local totals; they are stacked on the first mesh device, laid out as the
mesh over the sharded axes, and summed innermost axis first, then each
enclosing axis, in float32.  Per-stream keys are split before sharding, so
every layout gives the same outputs and totals.

On a CUDA mesh the shards' Lloyd loops run in the CUDA k-means kernel and
their DTW scores (``reconstruct=True``) in the DTW kernel; on the CPU the
plain versions run, bitwise equal to the reference.  The sender rounds EWMV
in the batched form at every shard width: the reference's sharded program
takes that form at every width it was measured at (1-8 streams per shard,
on 1 and 4 devices).

CLI (``--device cpu``: host shards, the dry run; ``cuda``: shards
round-robin over the cards):

    PYTHONPATH=src python -m repro_torch.launch.fleet --streams 256 \
        --length 1024 --chunk 128 --digitize-every 2 --devices 8 --pods 2
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import prng
from repro_torch.core.receiver import delta_frame_bytes
from repro_torch.core.symed import (
    SymEDConfig, _encode_batch, _receive_chunk_table, symed_receive_finish,
)
from repro_torch.launch.mesh import (
    Mesh, describe_devices, device_count, make_pod_data_mesh, make_test_mesh,
    mesh_devices,
)

__all__ = [
    "fleet_data_mesh", "resolve_fleet_mesh", "describe_ingestion",
    "validate_cli_args", "run_fleet", "fleet_report", "main",
]

AxisSpec = Union[str, Sequence[str]]
TELEMETRY = ("streams", "points", "pieces", "wire_bytes", "raw_bytes",
             "wire_out_bytes")


def fleet_data_mesh(n_devices: Optional[int] = None, *, device=None) -> Mesh:
    """1-D ``(data,)`` mesh of ``n_devices`` shards (default: one per device
    of the kind: every card on CUDA, one host shard on the CPU)."""
    n = n_devices or device_count(device)
    return make_test_mesh((n,), ("data",), device=device)


def resolve_fleet_mesh(n_pods: int, n_dev: int, *, device=None):
    """CLI helper: ``(mesh, axis, layout string)`` for a pods-aware run.

    Shared by ``repro_torch.launch.fleet`` and
    ``examples/torch_edge_fleet.py`` so the two CLIs map ``--pods`` to a
    mesh alike.
    """
    if n_dev % n_pods:
        raise ValueError(f"{n_dev} devices must divide over {n_pods} pods")
    if n_pods > 1:
        mesh = make_pod_data_mesh(n_pods, n_dev // n_pods, device=device)
        return mesh, ("pod", "data"), f"pod x data = {n_pods} x {n_dev // n_pods}"
    return fleet_data_mesh(n_dev, device=device), "data", f"data = {n_dev}"


def describe_ingestion(chunk: Optional[int], digitize_every: int) -> str:
    """Human-readable ingestion mode for the CLI reports."""
    if not chunk:
        return "whole-stream"
    cadence = (f", digitize every {digitize_every}" if digitize_every
               else ", digitize at finish")
    return f"streaming({chunk}{cadence})"


def validate_cli_args(ap: argparse.ArgumentParser, args) -> None:
    """Early validation of the streaming/fleet flags both CLIs share: exit
    2 via ``ap.error`` before any torch work, with the reference's
    messages."""
    from repro_torch.launch.cli import validate_shared_args

    validate_shared_args(ap, args)
    if args.chunk is not None and args.chunk < 0:
        ap.error(f"--chunk must be >= 0 (0 = whole-stream), got {args.chunk}")
    if args.chunk and args.chunk > args.length:
        ap.error(f"--chunk {args.chunk} exceeds --length {args.length}: "
                 "the ingestion window cannot outgrow the stream")
    if args.digitize_every and not args.chunk:
        ap.error("--digitize-every requires --chunk (streaming mode)")
    if args.pods < 1:
        ap.error(f"--pods must be >= 1, got {args.pods}")


def _encode_slab(slab, keys, cfg: SymEDConfig, chunk_len, digitize_every_k,  # symlint-torch: entry(drive=fleet, budget=127, cpu_budget=314, shapes=encode-slab)
                 reconstruct, use_kernel: bool = False):  # symlint-torch: hot-path
    """Per-shard body: batched SymED over a local ``(b, T)`` sub-slab and
    its ``(b, 2)`` keys.

    Returns ``(out, wire_out)``: ``wire_out (b,)`` is the outbound
    symbol-delta traffic each stream's receiver would put on the wire --
    one frame per digitize pass plus the closing frame (whole-stream
    ingestion degenerates to a single closing frame carrying every symbol).
    """
    if chunk_len is None:
        out = _encode_batch(slab, keys, cfg, single=False,
                            reconstruct=reconstruct, use_kernel=use_kernel)
        return _rates(out, slab.shape[-1]), delta_frame_bytes(out["n_pieces"])

    # the cadence is resolved here, per window: ``(i + 1) % k`` mirrors the
    # in-state ``chunks`` counter, so outputs are those of the in-state
    # cadence
    t_len = slab.shape[-1]
    dk = digitize_every_k or 0
    state = None
    wire_out = torch.zeros((slab.shape[0],), dtype=torch.float32,
                           device=slab.device)
    for i, c in enumerate(range(0, t_len, chunk_len)):
        dk_i = 1 if dk and (i + 1) % dk == 0 else 0
        state, info = _receive_chunk_table(
            slab[:, c: c + chunk_len], cfg, state, keys,
            digitize_every_k=dk_i, use_kernel=use_kernel, single=False)
        wire_out = wire_out + info["symbol_delta"]["frame_bytes"]
    n_dig_before_finish = state.dig.n
    out = symed_receive_finish(state, cfg, slab if reconstruct else None,
                               reconstruct=reconstruct,
                               use_kernel=use_kernel)
    # the closing frame: whatever the final flush digitized
    wire_out = wire_out + delta_frame_bytes(
        out["n_pieces"] - n_dig_before_finish)
    return _rates(out, t_len), wire_out


def _rates(out, t_len: int):
    """``cr`` and ``drr`` as the reference's sharded program rounds them:
    its stream length is a constant there, so the division becomes a
    multiply by the f32 reciprocal (one ulp from a true division on some
    streams; Queue C 11)."""
    n = out["n_pieces"].to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=n.device)
    inv = one / torch.tensor(float(t_len), dtype=torch.float32,
                             device=n.device)
    out["cr"] = n * inv
    out["drr"] = n * inv
    return out


def _shard_totals(out, wire_out, b: int, t_len: int) -> torch.Tensor:
    """One shard's local telemetry, in ``TELEMETRY`` order (float32)."""
    dev = out["n_pieces"].device
    f32 = lambda v: torch.tensor(float(v), dtype=torch.float32, device=dev)
    n_pts = f32(b * t_len)
    return torch.stack([
        f32(b), n_pts, torch.sum(out["n_pieces"].to(torch.float32)),
        torch.sum(out["wire_bytes"]), n_pts * 4.0, torch.sum(wire_out)])


def _hier_sum(totals: torch.Tensor, sizes: Tuple[int, ...]) -> torch.Tensor:
    """The reference's ``hier_psum`` tree: shard totals ``(n_shards, m)``
    laid out as the mesh over the sharded axes, summed innermost axis
    first, then each enclosing axis."""
    v = totals.reshape(sizes + totals.shape[1:])
    for ax in reversed(range(len(sizes))):
        v = torch.sum(v, dim=ax)
    return v


def run_fleet(
    fleet,
    cfg: SymEDConfig,
    key,
    mesh=None,
    *,
    chunk_len: Optional[int] = None,
    digitize_every_k: Optional[int] = None,
    reconstruct: bool = False,
    axis: AxisSpec = "data",
    obs=None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Run the SymED pipeline over ``fleet`` (n_streams, T), sharded on ``axis``.

    ``axis`` may be a single mesh axis (``"data"``) or a sequence
    (``("pod", "data")``) -- streams then shard over the flattened grid of
    those axes and telemetry reduces hierarchically (innermost axis first).
    ``mesh`` defaults to ``fleet_data_mesh()`` (every card).

    Each stream gets its own key (``prng.split(key, n_streams)``), so
    results do not depend on the layout: a (2, 2) pod x data mesh, a (4,)
    data mesh and a single shard give the same outputs (tested).

    ``chunk_len=C`` switches to the streaming receiver (windows of ``C``
    points, O(n_max) carry); ``digitize_every_k=k`` additionally digitizes
    every ``k`` windows so symbols stream out online (requires
    ``chunk_len``).

    Returns ``(out, telemetry)``: ``out`` the per-stream ``symed_encode``
    outputs, concatenated in shard order on the first mesh device;
    ``telemetry`` the fleet-wide totals as 0-d float32 tensors there:
    ``streams``, ``points``, ``pieces``, ``wire_bytes``, ``raw_bytes`` and
    ``wire_out_bytes`` (one frame per digitize pass plus the closing frame,
    ``repro_torch.launch.stream``'s wire format).

    ``obs``: optional ``repro_torch.obs.Observability``; when given, the
    run is recorded as a ``fleet.dispatch`` span and a
    ``fleet_dispatch_seconds`` sample (host time: the digitize loops wait
    for the device, the last kernels may still be in flight).
    """
    mesh = mesh if mesh is not None else fleet_data_mesh()
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if not axes:
        raise ValueError("axis must name at least one mesh axis")
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    for a in axes:
        if a not in sizes:
            raise ValueError(
                f"unknown mesh axis {a!r}; mesh has axes {tuple(sizes)}"
            )
    n_shards = 1
    for a in axes:
        n_shards *= sizes[a]
    fleet = torch.as_tensor(fleet, dtype=torch.float32)
    n_streams = fleet.shape[0]
    if n_streams % n_shards:
        raise ValueError(
            f"n_streams={n_streams} must divide over {n_shards} "
            f"{'x'.join(axes)} shards"
        )
    if chunk_len is not None and chunk_len < 1:
        raise ValueError(f"chunk_len must be >= 1, got {chunk_len}")
    if digitize_every_k is not None and digitize_every_k < 0:
        raise ValueError(
            f"digitize_every_k must be >= 0, got {digitize_every_k}")
    if digitize_every_k and chunk_len is None:
        raise ValueError("digitize_every_k requires chunk_len (streaming mode)")
    devices = mesh_devices(mesh, axes)
    first = devices[0]
    keys = prng.split(prng.as_key(key, first), n_streams)

    obs_on = obs is not None and obs.enabled
    t_disp = time.perf_counter_ns() if obs_on else 0
    b = n_streams // n_shards
    outs, totals = [], []
    for i, dev in enumerate(devices):
        slab = fleet[i * b: (i + 1) * b].to(dev)
        out, wire_out = _encode_slab(
            slab, keys[i * b: (i + 1) * b].to(dev), cfg, chunk_len,
            digitize_every_k, reconstruct, use_kernel=dev.type == "cuda")
        outs.append(out)
        totals.append(_shard_totals(out, wire_out, b, fleet.shape[1]))
    out = {k: torch.cat([o[k].to(first) for o in outs]) for k in outs[0]}
    reduced = _hier_sum(torch.stack([t.to(first) for t in totals]),
                        tuple(sizes[a] for a in axes))
    tele = dict(zip(TELEMETRY, reduced.unbind()))
    if obs_on:
        obs.metrics.histogram(
            "fleet_dispatch_seconds", "run_fleet dispatch latency "
            "(trace/compile on first call at a shape)", unit="ns"
        ).observe(time.perf_counter_ns() - t_disp)
        obs.tracer.add("fleet.dispatch", t_disp,
                       {"streams": n_streams, "shards": n_shards})
    return out, tele


def fleet_report(tele: Dict[str, object], wall_seconds: float,
                 obs=None) -> Dict[str, object]:
    """Host-side summary: telemetry totals + wall-clock rates.

    ``obs``: optional ``repro_torch.obs.Observability``.  When given, the
    fleet totals are published as gauges on its registry and its JSON
    snapshot is merged under the report's ``"obs"`` key.

    Robust to empty fleets (zero streams / zero points): every ratio is
    clamped, so the report never divides by zero.  ``ms_per_symbol`` is the
    paper's per-symbol conversion latency metric (42ms/symbol in the paper's
    single-CPU setup; amortized here over the whole fleet run).

    ``wire_in_bytes``/``wire_in_ratio`` is the sender->receiver traffic
    against the raw stream (``wire_bytes``), ``wire_out_bytes``/
    ``wire_out_ratio`` the receiver's outbound symbol-delta frames; both
    ratios share the ``raw_bytes`` denominator, as in the reference.
    """
    t = {k: float(v) for k, v in tele.items()}
    dt = max(wall_seconds, 1e-9)
    rep: Dict[str, object] = {
        **t,
        "wall_seconds": wall_seconds,
        "points_per_s": t["points"] / dt,
        "pieces_per_s": t["pieces"] / dt,
        "streams_per_s": t["streams"] / dt,
        "ms_per_symbol": 1e3 * dt / max(t["pieces"], 1.0),
        "compression_rate": t["wire_bytes"] / max(t["raw_bytes"], 1.0),
        "mean_pieces_per_stream": t["pieces"] / max(t["streams"], 1.0),
        "wire_in_bytes": t["wire_bytes"],
        "wire_in_ratio": t["wire_bytes"] / max(t["raw_bytes"], 1.0),
        # wire-out telemetry is absent from pre-delta callers' dicts
        "wire_out_bytes": t.get("wire_out_bytes", 0.0),
        "wire_out_ratio": t.get("wire_out_bytes", 0.0) / max(t["raw_bytes"], 1.0),
    }
    if obs is not None and obs.enabled:
        m = obs.metrics
        for key in TELEMETRY:
            if key in t:
                m.gauge(f"fleet_{key}", "fleet telemetry total").set(t[key])
        rep["obs"] = obs.snapshot()
    return rep


def main(argv=None):
    from repro_torch.data.synthetic import make_fleet
    from repro_torch.launch.cli import (
        add_devices_arg, add_metrics_args, add_symed_args)
    from repro_torch.obs import Observability
    from repro_torch.obs.export import start_exporter

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--length", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=None,
                    help="streaming-receiver ingestion window "
                         "(default / 0: whole stream)")
    ap.add_argument("--digitize-every", type=int, default=0,
                    help="digitize cadence k: run the receiver's clustering "
                         "every k windows so symbols stream out online "
                         "(0: once at end-of-stream; requires --chunk)")
    ap.add_argument("--pods", type=int, default=1,
                    help="shard over a (pod, data) mesh with this many pods "
                         "(hierarchical telemetry reduction)")
    ap.add_argument("--reconstruct", action="store_true",
                    help="also reconstruct + score DTW error (slower)")
    add_devices_arg(ap, default=None,
                    help="data shards (default: 8 host shards with --device "
                         "cpu, the dry run; one per card with cuda); shards "
                         "go round-robin over the cards")
    add_symed_args(ap)
    add_metrics_args(ap)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where the shards run")
    args = ap.parse_args(argv)
    if args.devices is None:
        # the reference shards over every device it sees: 8 forced host
        # devices in its CPU dry run, else the accelerators
        args.devices = 8 if args.device == "cpu" else device_count(args.device)

    validate_cli_args(ap, args)
    if args.devices % args.pods:
        ap.error(f"--devices {args.devices} must divide over "
                 f"--pods {args.pods}")

    n_dev = args.devices
    mesh, mesh_axes, layout = resolve_fleet_mesh(args.pods, n_dev,
                                                 device=args.device)
    streams = max(args.streams - args.streams % n_dev, n_dev)
    cfg = SymEDConfig(tol=args.tol, alpha=args.alpha, n_max=256, k_max=32,
                      len_max=256)
    fleet = make_fleet(streams, args.length, seed=args.seed)

    obs = Observability()
    exporter = start_exporter(obs, args.metrics_port)
    if exporter is not None:
        print(f"metrics exporter        : {exporter.url}/metrics")
    t0 = time.perf_counter()
    out, tele = run_fleet(
        fleet, cfg, prng.key(args.seed), mesh,
        chunk_len=args.chunk or None,
        digitize_every_k=args.digitize_every or None,
        reconstruct=args.reconstruct, axis=mesh_axes, obs=obs,
    )
    rep = fleet_report(tele, time.perf_counter() - t0, obs=obs)

    mode = describe_ingestion(args.chunk, args.digitize_every)
    print(f"devices / data shards   : {n_dev}")
    print(f"shard devices           : {describe_devices(mesh.devices.flat)}")
    print(f"mesh layout             : {layout}")
    print(f"ingestion               : {mode}")
    print(f"streams                 : {streams} x {args.length} points")
    print(f"wall time               : {rep['wall_seconds']:.2f}s")
    print(f"throughput              : {rep['points_per_s'] / 1e6:.2f} Mpoints/s, "
          f"{rep['pieces_per_s']:.0f} pieces/s")
    print(f"symbol latency          : {rep['ms_per_symbol']:.3f} ms/symbol "
          f"(paper: 42ms single-CPU)")
    print(f"fleet pieces            : {int(rep['pieces'])} "
          f"({rep['mean_pieces_per_stream']:.1f}/stream)")
    print(f"fleet raw bytes         : {int(rep['raw_bytes']):,}")
    print(f"fleet wire-in bytes     : {int(rep['wire_in_bytes']):,} "
          f"(ratio {rep['wire_in_ratio']:.4f})")
    print(f"fleet wire-out bytes    : {int(rep['wire_out_bytes']):,} "
          f"(symbol-delta frames)")
    print(f"compression rate        : {rep['compression_rate']:.6f} "
          f"(paper avg 0.095)")
    if args.reconstruct:
        print(f"mean DTW err (pieces)   : "
              f"{out['re_pieces'].mean().item():.3f}")
        print(f"mean DTW err (symbols)  : "
              f"{out['re_symbols'].mean().item():.3f}")
    if args.trace_out:
        obs.tracer.write(args.trace_out)
        print(f"trace written           : {args.trace_out} "
              f"({obs.tracer.recorded} events, load at ui.perfetto.dev)")
    if exporter is not None:
        if args.metrics_linger:
            print(f"metrics exporter        : lingering "
                  f"{args.metrics_linger:.0f}s for scrapes", flush=True)
            time.sleep(args.metrics_linger)
        exporter.close()
    return rep


if __name__ == "__main__":
    main()

"""Shared argparse surface for the port's launch CLIs.

Port of ``repro.launch.cli``: the same flags, defaults and checks, and the
same error messages letter for letter, so that the port's CLIs (stream,
transport and ``repro_torch.workload``) accept and reject what the
reference's accept and reject.  Only the groups and checks of flags that a
port CLI mounts are here.  ``--devices N`` asks for N shards of a data mesh
(``repro_torch.launch.mesh``): host shards with ``--device cpu``, shards
round-robin over the cards with ``cuda``.  Torch pins no device count at
import, so nothing here has to run before ``import torch`` (the reference's
``prescan_host_devices`` has no counterpart).
"""
from __future__ import annotations

import argparse

__all__ = ["add_devices_arg", "add_symed_args", "add_metrics_args",
           "add_slot_table_args", "validate_shared_args"]


def add_devices_arg(ap: argparse.ArgumentParser, *, default: int = 1,
                    help: str = "forced host device count; >1 shards "
                                "over a data mesh") -> None:
    ap.add_argument("--devices", type=int, default=default, help=help)


def add_symed_args(ap: argparse.ArgumentParser) -> None:
    """The compressor/digitizer knobs every driver threads into SymEDConfig,
    and the seed."""
    ap.add_argument("--tol", type=float, default=0.5,
                    help="compression tolerance (paper's tol)")
    ap.add_argument("--alpha", type=float, default=0.01,
                    help="digitizer EWMA smoothing in (0, 1]")
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed: synthetic data + per-session "
                         "digitizer keys")


def add_metrics_args(ap: argparse.ArgumentParser) -> None:
    """Flight-recorder export: Prometheus endpoint + Perfetto span trace."""
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus /metrics (+ /metrics.json, "
                         "/trace) on this port for the run's duration")
    ap.add_argument("--metrics-linger", type=float, default=0.0,
                    help="keep the metrics endpoint up this many seconds "
                         "after the run finishes (scrape window)")
    ap.add_argument("--trace-out", default=None,
                    help="write the span ring as Chrome trace-event JSON "
                         "(load at ui.perfetto.dev)")


def add_slot_table_args(ap: argparse.ArgumentParser, *,
                        max_slots: int = 4) -> None:
    """The resident ``StreamServer`` table shape (stream + transport serve)."""
    ap.add_argument("--max-slots", type=int, default=max_slots,
                    help="resident slot-table capacity")
    ap.add_argument("--min-slots", type=int, default=None,
                    help="autoscale floor (default: --devices)")
    ap.add_argument("--autoscale", action="store_true",
                    help="grow/shrink the slot table between steps "
                         "(power-of-two ladder from --min-slots)")
    ap.add_argument("--evict", action="store_true",
                    help="LRU-evict when sessions exceed slots")
    ap.add_argument("--digitize-every", type=int, default=1,
                    help="digitize cadence in ingest windows")
    ap.add_argument("--shrink-patience", type=int, default=3,
                    help="consecutive low-occupancy ticks before the table "
                         "walks down the ladder (1: shrink immediately)")
    ap.add_argument("--pretrace", action="store_true",
                    help="step every ladder capacity once at server init "
                         "(no serving round is the first at its capacity)")


def validate_shared_args(ap: argparse.ArgumentParser, args) -> None:
    """Fail fast (exit 2 via ``ap.error``) before any torch work.

    Checks every shared flag the namespace carries (``getattr`` guards), in
    the reference's order and with its messages.
    """
    def has(name):
        return getattr(args, name, None) is not None

    if has("streams") and args.streams < 1:
        ap.error(f"--streams must be >= 1, got {args.streams}")
    if has("sessions") and args.sessions < 1:
        ap.error(f"--sessions must be >= 1, got {args.sessions}")
    if has("length") and args.length < 2:
        ap.error(f"--length must be >= 2, got {args.length}")
    if has("window"):
        if args.window < 1:
            ap.error(f"--window must be >= 1, got {args.window}")
        if has("length") and args.window > args.length:
            ap.error(f"--window {args.window} exceeds --length {args.length}")
    if has("digitize_every") and args.digitize_every < 0:
        ap.error(f"--digitize-every must be >= 0, got {args.digitize_every}")
    if has("tol") and args.tol <= 0:
        ap.error(f"--tol must be > 0, got {args.tol}")
    if has("alpha") and not 0 < args.alpha <= 1:
        ap.error(f"--alpha must be in (0, 1], got {args.alpha}")
    if has("devices") and args.devices < 1:
        ap.error(f"--devices must be >= 1, got {args.devices}")
    if has("max_slots"):
        if args.max_slots < 1:
            ap.error(f"--max-slots must be >= 1, got {args.max_slots}")
        if has("devices") and args.max_slots % args.devices:
            ap.error(f"--max-slots {args.max_slots} must divide over "
                     f"--devices {args.devices}")
    if has("min_slots"):
        if has("max_slots") and not 1 <= args.min_slots <= args.max_slots:
            ap.error(f"--min-slots {args.min_slots} must be in "
                     f"[1, --max-slots {args.max_slots}]")
        if has("devices") and args.min_slots % args.devices:
            ap.error(f"--min-slots {args.min_slots} must divide over "
                     f"--devices {args.devices}")
    if has("shrink_patience") and args.shrink_patience < 1:
        ap.error(f"--shrink-patience must be >= 1, got {args.shrink_patience}")
    if has("metrics_port") and not 0 <= args.metrics_port <= 65535:
        ap.error(f"--metrics-port must be in [0, 65535], got "
                 f"{args.metrics_port}")
    if has("metrics_linger") and args.metrics_linger < 0:
        ap.error(f"--metrics-linger must be >= 0, got {args.metrics_linger}")

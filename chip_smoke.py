#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SymED on one GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Thirteen
phases, each raising on failure:

1. environment: the card's name and power limit, torch/CUDA/nvcc versions;
2. build: the k-means, DTW and EWMA kernels from
   ``src/repro_torch/kernels/csrc``, one ``nvcc`` each, started together;
3. the k-means kernels against their plain PyTorch versions on the card,
   at the shapes of ``tests/test_kernels.py`` and at the service's shape
   (S=256 slots, N=512 pieces, D=2, K=100 centers).  The half-step: labels
   and counts exact, masked labels 0, sums within rtol=atol=1e-5, and one
   call of its entry point ``ops.kmeans_assign`` counted.  The Lloyd kernel
   (10 iterations; 0 and 1 at one shape; also at N=30000, staged a tile at
   a time): bitwise equal to the half-step kernel iterated with the eager
   center update, two calls bitwise equal, labels exact and centers within
   rtol=atol=1e-5 of its plain version.  Device times from CUDA graphs;
4. the DTW kernel against its plain version, bitwise, at the shapes of
   ``tests/test_kernels.py``, at a length whose buffers need the global
   scratch (B=2, N=20000) and at the monitor's four shapes (B=256
   sessions, N=512, 1024, 1536 and 2048 points, full band) and at band 64;
   device time from a CUDA graph at those five, each beside its bound, and
   the monitor's device time per service run (the sum of its four);
5. the EWMA kernel's entry point, ``kernels.ops.ewma_scan``, on the paper's
   fleet slab (``make_fleet(256, 2048, seed=0)``, alpha 0.01) and the
   z-scores ``normalize.standardize`` makes of it; then the kernel against
   its plain version at the shapes of ``tests/test_kernels.py``, at alpha
   0.5 and 1.0, on a row of 10 chunks (B=2, T=20000), at the 64 x 2048
   slab of ``benchmarks/kernels_bench.py``, at T=2047 (4-byte copies), on
   rows one float off a 16-byte boundary, on a chunk whose last warps lie
   past T, on streams offset by 1000 and on the fleet slab: point 0 exact,
   two calls bitwise equal, means within rtol=atol=2e-5, vars within 2e-4
   (the offset streams: 1e-4 and 1e-3/1e-2); the plain version on the card
   bitwise equal to the CPU's on the fleet slab; device time from a CUDA
   graph at 64 x 2048 and 256 x 2048 beside the bound;
6. end to end: ``StreamServer`` on cuda with the paper's settings serves 256
   sessions x 2048 points in 64-point windows with the online DTW monitor
   every 8 windows, and closes them, through the Lloyd kernel (and no
   half-step launch); every 16th
   of those sessions again through its plain version (16 sessions, to keep
   the call short); 8 of the final DTW readings are recomputed with the
   plain DTW on the card.  Then 8 of those sessions (every 32nd) served by
   the CPU port (which the CPU tests hold to the JAX reference) against
   the cuda run, a small config on cuda against the CPU port, and
   ``symed_encode(reconstruct=True)`` on 4 paper-config streams, cuda
   against the CPU port (run after phase 8: the CPU port's side runs in a
   worker process beside the card's phases);
7. compressed-in, the paper's own deployment: (a) the same 256 sessions as
   senders that compress on the card (one batched ``symed_encode_chunk``
   per 64-point window, ``pieces_on_wire`` per session) and a
   ``StreamServer`` that only digitizes (``ingest_pieces_many`` per
   window, then the tails, then close), through the Lloyd kernel; each
   session held against phase 6's raw-in run (pieces, endpoints and
   ``n_pieces`` bitwise, at least 99% of symbols equal); (b) over loopback
   TCP: a ``TransportServer`` on the card (16 slots, autoscaled from 4)
   in a thread, and one ``SenderClient`` compressing on the card that
   interleaves 8 sessions (4 pieces, 4 raw) on one socket, each held
   against ``symed_encode`` on the card;
8. trace-driven replay through the flight recorder
   (``repro_torch.workload.replay_trace``, ``repro_torch.obs``): (a) the
   five scenarios of the zoo at their defaults, each replayed twice on the
   card (fingerprints equal), verified against ``symed_encode`` by the rule
   of ``transport.check_deltas`` and held to the CPU port's replay of the
   same trace (every counter equal, pieces bitwise, at least 99% of
   symbols equal), ``mixed_fleet`` once more with ``obs=False`` (the same
   fingerprint and host syncs), each scenario's symbol latency, queue
   depths, evict rate and SLO verdict printed; (b) ``flash_crowd`` at the
   paper's fleet (256 sessions x 512 points in 64-point windows, the
   paper's config, a 256-slot table autoscaled from 32 with ``pretrace``),
   its rounds, latency, syncs, launches, resizes and retraces printed and 8
   sessions held against ``symed_encode``; (c) ``mixed_fleet`` over
   loopback TCP with an ``ObsHTTPServer``: ``/metrics`` against
   ``report()`` and the transport's counts, ``/trace`` as Chrome trace
   JSON, the delta hash and schedule-determined counters against (a)'s; (d)
   the stream CLI on the card with ``--workload bursty --verify
   --dtw-every 2``, through the DTW kernel;
9. the sharded fleet runtime and the sharded slot table, every shard on
   the one card: (a) ``run_fleet`` whole-stream with ``reconstruct=True``
   on the paper's fleet (256 streams of ``make_fleet(256, FLEET_POINTS,
   seed=0)``, the paper's config) on one shard, through the Lloyd kernel
   and the DTW kernel, against ``symed_batch`` on the card (its plain
   k-means): telemetry and pieces bitwise, at least 99% of symbols equal,
   ``re_pieces`` within 1e-5 relative, and on the streams whose labels
   agree ``k`` and the centers bitwise and ``re_symbols`` within 1e-5
   relative; (b) the same slab streaming
   (``FLEET_CHUNK``-point windows, a digitize every ``FLEET_EVERY``) over a
   (pod, data) = (2, 2) and a (4,) mesh against one shard: telemetry
   equal, pieces bitwise, at least 99% of symbols equal; (c) the stream CLI
   with ``--devices 4 --workload flash_crowd --max-slots 16 --min-slots 4
   --autoscale --verify --pretrace`` against ``--devices 1``: one
   ``stream_summary`` and one fingerprint; (d) 8 of phase 6's sessions
   (``SHARD_POINTS`` points each, the DTW monitor every
   ``SHARD_DTW_EVERY`` windows) in a ``SHARD_BLOCKS``-block
   ``StreamServer`` against one block, frame by frame: ``n_new`` exact,
   endpoints and pieces bitwise, DTW readings equal, at least 99% of
   symbols equal, and the closes through the Lloyd kernel.  Each part
   prints its wall time, host syncs and kernel launches, counted from 0
   just before it.  (a)-(b) run in a worker process of their own on the
   card (``FleetCard``), started after phase 7 and read here, so they run
   beside phase 8;
10. the ABBA baseline and the LM serving path: (a) ``abba_encode`` on the
   card (its k-search through the Lloyd kernel) on the five families of
   ``make_dataset`` at the Fig. 5 settings (4 series x 1000 points, seed
   11, ``n_max=256``, ``len_max=256``, ``k_max=64``) at tol 0.5, 0.1 and
   1.9, each tol's reconstructions scored in one DTW kernel launch (the
   card's side in a process of its own, beside phase 9), against
   the CPU port (run in the worker): lengths, incs, n_pieces, mean and std
   bitwise, at least 99% of labels equal, DTW within 1e-4 relative where
   the labels agree; its launches, host syncs and wall time printed; (b)
   ``python -m repro_torch.launch.serve --full`` on olmoe-1b-7b and on
   xlstm-125m (bf16, the CLI's defaults otherwise) exits 0 with its three
   ``[serve]`` lines; (c) the 10 archs at full width in bf16
   (olmoe-1b-7b and xlstm-125m at full depth, jamba-1.5-large-398b cut
   to layers 2-4 of its superblock (``JAMBA_CUT``: a mamba layer with its
   dense FFN, one with MoE, the attention layer), the others cut to one
   superblock plus the tail and one encoder block): two
   runs from one seed bitwise equal, tokens in range, logits finite,
   ``count_params`` the reference's, and the teacher-forcing contract of
   ``tests/test_models.py`` within ``TF_BOUND`` x max(max|logits|, 1)
   (for the recurrent layers: prefill's chunk scan and mLSTM closed form
   against their decode recurrences); the full-depth archs' peak memory
   printed; one of olmoe-1b-7b's MoE layers at
   full width on 4 x 8192 tokens (8 groups of 4096, run one after the
   other): finite, the first group as the layer on that group alone (at
   most 1% of its outputs differ: the router's f32 product may sum in
   another order at another row count), the memory the call adds under
   ``MOE_GROUPS_BYTES``; (d) the 10 reduced configs and one int8-cache
   variant in f32 on the card against the CPU port on the same weights:
   logits within 1e-4 x max(max|cpu|, 1), greedy tokens equal;
11. training: (a) ``python -m repro_torch.launch.train`` at its defaults
   (symlm-100m at full size, f32, batch 8, seq 256) with a checkpoint
   every ``TRAIN_FAIL`` steps, failed at step ``TRAIN_FAIL`` (exit
   non-zero), then run again to ``TRAIN_STEPS``, resuming from the
   checkpoint: every logged loss finite, the last three's mean below the
   first three's by 0.1; its ms per step, tokens/s, peak memory and the
   seconds each batch waited on the pipeline printed (the two runs go in
   a background thread beside phases 8-10, all host-bound); (b) xlstm-125m
   at its published config in bf16, 3 AdamW steps in process: finite
   loss and grad norm, every leaf moved, 155,634,512 parameters, ms per
   step and peak memory; then symlm-100m the same way (the train step
   timed without the pipeline beside it); (c) one ``make_train_step`` step of a dense, an
   MoE and two recurrent reduced configs in f32 on the card against the
   CPU port on the same state and batch: loss and grad norm within 1e-5
   relative, every gradient within 1e-4 x max(max|g|, 1e-6), parameters
   and moments after it within 1e-6 x max(|cpu|, 1) except where the
   gradient is small (at most 0.1% of a leaf); (d) the compressed step,
   two pods on the one card: the pods' int8 mean of the gradients within
   each leaf's quantization step (amax / 127) plus the gradient tolerance
   of the whole batch's gradients, the loss the plain step's, one
   error-feedback buffer per pod; (e) ``examples/torch_anomaly_monitor.py``
   on the card flags the injected straggler (host 7, steps 200-220) and
   the hang (host 3, step 350).  The kernels' launches are counted in the
   train steps of (b)-(d) (none) and in (e) (the Lloyd kernel);
12. the sharding rules and the dry run (no kernel on this path): (a)
   ``python -m repro_torch.launch.dryrun`` on ``DRYRUN_CELL`` (the
   reference's own cell: xlstm-125m, decode_32k, the 2 x 16 x 16 mesh on
   ``meta``) in a child process, started before phase 10 (a) and read
   here, prints ``OK`` and writes its JSON with the collective inventory
   (DTensor on a fake process group of 512, ``utils.collectives``): the
   per-op counts, the wire bytes per device and the three roofline terms
   are printed, and a ``null`` inventory fails the phase; (b) the
   same cell through ``dryrun.build_cell`` on a one-shard mesh, traced on
   ``meta`` and run on the card (``decode_step`` at batch 128 against a
   32768-token cell, parameters from seed 0): the bytes of the parameters,
   state and token on the card equal the dry run's argument bytes, the FLOPs
   counted on the card equal the ``meta`` count, and ``DRYRUN_STEPS`` timed
   steps (each step's outputs dropped before the next; the counted step
   must leave nothing alive) are printed beside the card's roofline terms,
   the peak memory beside the predicted peak;
   (c) a reduced train state saved from the card,
   resumed by ``launch.elastic.resume_on_mesh`` onto a (2, 2) mesh of 4
   shard devices: every leaf in 4 pieces of its spec's shape, gathered
   bitwise; (d) the reduced serve path (prefill, then greedy decode steps)
   of a dense, an MoE and a recurrent config under ``use_mesh_rules`` on the
   multi-pod mesh, bitwise equal to the same path without it;
13. symlint on the card (``repro_torch.analysis``, no kernel of its own):
   (a) the sync inventory of phase 6's service at its configuration
   (``_stream_windows``: 256 sessions of ``make_fleet(256, 2048, seed=0)``,
   ``SYMLINT_WARMUP`` 64-point windows of warm-up, then
   ``SYMLINT_MEASURED`` measured ones; raw in, then compressed in from
   phase 7 (a)'s senders, each on a 256-slot ``StreamServer`` through the
   Lloyd kernel).  Two counters watch the same measured rounds:
   ``synccount.SyncCounter`` (a function mode and a dispatch mode) and
   ``torch.cuda.set_sync_debug_mode("warn")``
   (``synccount.SyncDebugRecorder``), both keyed by entry, site and caller.
   They must agree key for key (else the first key where they differ is
   named), and the drive must launch ``kmeans_lloyd``.  The inventory is
   printed: syncs per round by entry, site and caller.  (b) beside (a),
   ``python -m repro_torch.analysis --deep`` in a child process, on the
   card: every drive within the card's budgets, every probe's dtypes
   clean, exit 0.

The last two lines are a JSON summary of every kernel (``launches`` from
phase 6, ``launches_abba`` from phase 10 (a), ``launches_train_step``
and ``launches_train_monitor`` from phase 11, ``launches_symlint`` from
phase 13) and ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --train-only`` builds the kernels and runs only
phase 11.  ``python3 chip_smoke.py --fleet-depths 1024,1280`` builds the
kernels and runs only phase 9, (a)-(b) once at each depth (points per stream) and
(c)-(d) once, printing each part's wall time: how the depth of (a)-(b)
was chosen.  It prints no JSON summary.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
TEST_SHAPES = [(1, 16, 2, 3), (3, 50, 2, 7), (2, 200, 2, 100), (1, 64, 8, 5),
               (2, 128, 128, 16), (1, 300, 2, 1)]
MAIN_SHAPE = (256, 512, 2, 100)
SESSIONS, POINTS, WINDOW = 256, 2048, 64
DTW_EVERY = 8  # the monitor fires at 512, 1024, 1536 and 2048 points
PLAIN_STRIDE = 16  # the plain k-means run serves every 16th session
CHECK_ROWS = range(0, SESSIONS, SESSIONS // 8)   # held against the CPU port
# phase 7 (b): the transport's table, and the modes of its CHECK_ROWS
# sessions (the first four compress on the card, the others send raw)
TCP_SLOTS, TCP_MIN_SLOTS, TCP_PIECES = 16, 4, 4
ENCODE_ROWS = range(1, SESSIONS, SESSIONS // 4)  # symed_encode, cuda vs CPU
# (B, N, band): tests/test_kernels.py's DTW cases, a pair whose buffers
# overflow shared memory, band 64 and the monitor's shapes: all sessions at
# each length it fires at, the last of them DTW_MAIN
DTW_GLOBAL = (2, 20000, None)
DTW_SHAPES = [(1, 32, None), (4, 150, None), (8, 128, None), (3, 257, None),
              (16, 64, None), (4, 200, 5), (4, 200, 20), (4, 200, 64),
              (3, 96, 0), DTW_GLOBAL, (256, 2048, 64)]
DTW_MONITOR = [(SESSIONS, n, None) for n in range(
    DTW_EVERY * WINDOW, POINTS + 1, DTW_EVERY * WINDOW)]
DTW_MAIN = DTW_MONITOR[-1]
DTW_TIMED = DTW_MONITOR + [(SESSIONS, POINTS, 64)]
# (B, T, alpha): tests/test_kernels.py's EWMA cases, alpha 0.5 and 1.0, a
# row whose carry crosses 10 chunks of 2048 points, benchmarks/
# kernels_bench.py's slab, the fleet's width with T % 4 != 0 (4-byte copies)
# and a second chunk whose last six warps lie wholly past T
EWMA_SHAPES = ([(b, t, alpha) for b, t in ((1, 64), (3, 300), (8, 1024),
                                           (17, 257), (256, 96))
                for alpha in (0.01, 0.05, 0.2, 0.5, 1.0)]
               + [(2, 20000, 0.02), (64, 2048, 0.02), (256, 2047, 0.01),
                  (4, 2348, 0.05)])
EWMA_OFFSET = (3, 2048, 0.05)  # rows one float off a 16-byte boundary
EWMA_LARGE = (2, 512, 0.05)  # streams offset by 1000, as in the tests
EWMA_ALPHA = 0.01            # the paper's, on make_fleet(SESSIONS, POINTS)
EWMA_TOL = ({"rtol": 2e-5, "atol": 2e-5}, {"rtol": 2e-4, "atol": 2e-4})
EWMA_LARGE_TOL = ({"rtol": 1e-4, "atol": 0.0}, {"rtol": 1e-3, "atol": 1e-2})
# one CUDA source each; kmeans_assign.cu holds the half-step and the Lloyd
# kernel
SOURCES = ("kmeans_assign", "dtw", "ewma")
# phase 8: the zoo (the non-legacy scenarios, at their defaults) and the
# paper's fleet on flash_crowd: the cohort of 192 sessions lands in one tick
ZOO = ("diurnal", "flash_crowd", "dropout_churn", "mixed_fleet",
       "slot_churn")
SCALE = dict(sessions=256, length=512, window=64)
SCALE_SERVER = dict(max_sessions=256, min_slots=32, autoscale=True,
                    shrink_patience=2, pretrace=True)
SCALE_CHECKED = 8  # of its sessions held against symed_encode
# phase 9: the fleet runtime on the paper's fleet (depth FLEET_POINTS, the
# streaming runs in FLEET_CHUNK-point windows, digitizing every FLEET_EVERY),
# symed_batch's plain k-means against it; the sharded table on CHECK_ROWS'
# sessions, SHARD_POINTS points each, in SHARD_BLOCKS blocks
FLEET_POINTS, FLEET_CHUNK, FLEET_EVERY = 1280, 256, 2
SHARD_POINTS, SHARD_BLOCKS, SHARD_DTW_EVERY = 512, 4, 4
# phase 10: ABBA at the Fig. 5 benchmark's settings (benchmarks/common.py
# and fig5_suite.py: 4 series x 1000 points of each family, seed 11), the
# serve CLI's defaults, the teacher-forcing bound in bf16 (fixed before the
# first run on the card), and the reference's parameter counts of the
# ten architectures (tests/test_torch_models.py holds them against
# repro.models.count_params)
ABBA_SERIES, ABBA_POINTS, ABBA_SEED = 4, 1000, 11
ABBA_KW = dict(n_max=256, len_max=256, k_max=64, scl=1.0)
ABBA_TOLS = (0.5, 0.1, 1.9)
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 32, 16
TF_STEPS, TF_BOUND = 4, 5e-2
REF_PARAM_COUNTS = {
    "codeqwen1.5-7b": 8190038016, "command-r-35b": 30283538432,
    "gemma3-27b": 27008319744, "jamba-1.5-large-398b": 398555111424,
    "mixtral-8x7b": 46702792704, "nemotron-4-15b": 15628376064,
    "olmoe-1b-7b": 6919096320, "paligemma-3b": 2508662784,
    "whisper-small": 238143744, "xlstm-125m": 155634512,
}
SERVE_ARCH = "olmoe-1b-7b"  # the serve CLI's default, at full depth
# (b) also serves xlstm-125m through the CLI; (c) runs both at full depth
FULL_DEPTH = (SERVE_ARCH, "xlstm-125m")
# (c) cuts jamba to these positions of its superblock of 8 (a mamba layer
# with its dense FFN, one with MoE, the attention layer): one superblock
# holds 4 MoE layers of 19.3 GB of bf16 experts each, more than the card
JAMBA_CUT = slice(2, 5)
KV_QUANT_ARCH = "gemma3-27b"  # (d)'s int8-cache variant: ring and global
# (c)'s MoE layer on 4 x 8192 tokens: one group of 4096 needs about 2.5 GB
# (its (g, e, cap) combine in f32, the bf16 dispatch, the experts'
# buffers); all 8 groups at once would need tens of GB
MOE_GROUPS_SHAPE, MOE_GROUPS_BYTES = (4, 8192), 8 * 2**30
LLOYD_ITERS = 10  # the paper's lloyd_iters
LLOYD_EXTRA = [(2, 30000, 2, 8)]  # pieces too many for shared memory
# phase 11: the train CLI at its defaults (symlm-100m, f32, batch 8, seq
# 256) for TRAIN_STEPS, failed at TRAIN_FAIL (a checkpoint every
# TRAIN_FAIL steps) and resumed; every loss logged.  Each batch waits
# 22-26 s on the pipeline (about 1.35 slabs of 32 x 1024 points), and
# each run spends about 100 s more in start-up, its first batch (two
# slabs) and the batcher's last slab (PERF.md, training): the two runs
# take 330-480 s, so they run beside phases 8-10
TRAIN_STEPS, TRAIN_FAIL = 6, 3
TRAIN_BF16 = ("xlstm-125m", 8, 256, 3)  # (b): arch, batch, seq, steps
# (c): a dense, an MoE and two recurrent reduced configs, card against CPU
TRAIN_REDUCED = ("codeqwen1.5-7b", "olmoe-1b-7b", "jamba-1.5-large-398b",
                 "xlstm-125m")
TRAIN_LOSS_REL, TRAIN_GRAD_REL, TRAIN_OPT_REL = 1e-5, 1e-4, 1e-6
TRAIN_AT_STEP = 5  # (c)-(d) step from here: past warmup's lr of 0 at step 0
# phase 12: the dry run's cell (the reference's own, tests/test_system.py)
# through the CLI on meta, then on a one-shard mesh run on the card for
# DRYRUN_STEPS timed decode steps after one untimed; elastic resume of a
# reduced train state onto ELASTIC_SHARDS shard devices; the reduced serve
# path under the mesh rules (a dense, an MoE and a recurrent config,
# RULES_PROMPT tokens then RULES_GEN greedy steps)
DRYRUN_CELL = ("xlstm-125m", "decode_32k", "multipod")
DRYRUN_STEPS = 5
ELASTIC_ARCH, ELASTIC_SHARDS, ELASTIC_MODEL = "olmoe-1b-7b", 4, 2
RULES_ARCHS = ("codeqwen1.5-7b", "olmoe-1b-7b", "xlstm-125m")
RULES_PROMPT, RULES_GEN = (4, 16), 4
# phase 13 (a): phase 6's service at its configuration, this many windows
# of warm-up, then this many measured under both counters
SYMLINT_WARMUP, SYMLINT_MEASURED = 4, 8


_T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"[phase] {name} (at {time.perf_counter() - _T0:.1f} s)",
          flush=True)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _nvcc_version() -> str:
    from repro_torch.kernels import _build

    out = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[-1]


def _ptxas_report(log: Path):
    """One line per kernel of a build's ``ptxas -v`` report: its registers,
    static shared memory, stack and spills."""
    lines, cur = [], None
    for raw in log.read_text().splitlines():
        text = raw.split(":", 1)[-1].strip() if "ptxas" in raw else raw.strip()
        if text.startswith("Compiling entry function"):
            cur = [text.split("'")[1]]
            lines.append(cur)
        elif cur is not None and ("registers" in text or "spill" in text):
            cur.append(text)
    return ["; ".join(parts) for parts in lines]


def _inputs(torch, shape, seed, dev):
    s, n, d, k = shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((s, n, d), generator=g)
    mask = torch.rand((s, n), generator=g) > 0.25
    c = torch.randn((s, k, d), generator=g)
    act = torch.rand((s, k), generator=g) > 0.2
    act[:, 0] = True  # at least one active center
    return [t.to(dev) for t in (x, mask, c, act)]


def _median_ms(torch, fn, runs=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _graph_ms(torch, fn, runs=50, replays=10):
    """Device time per call: ``runs`` calls captured in one CUDA graph,
    replayed ``replays`` times; the median replay over ``runs``.  The host's
    cost of issuing each call is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(runs):
            fn()
    return _median_ms(torch, graph.replay, runs=replays, warmup=2) / runs


def _roofline(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _assign_ops(shape, mask, n_active):
    """f32 operations of one assign half-step: per valid piece |x|^2 (2D),
    D adds and a count; per (valid piece, active center) the dot (2D), the
    expansion (3) and the compare (1); per center |c|^2 (2D).  A masked
    piece's label is 0 whatever its distances, so it needs none."""
    s, n, d, k = shape
    valid = mask.sum(dim=1)
    pairs = int((valid * n_active).sum())
    return ((3 * d + 1) * int(valid.sum()) + (2 * d + 4) * pairs
            + 2 * d * s * k)


def _bound_ms(shape, mask, act):
    """Least time for one assign half-step on these inputs: bytes moved
    (inputs read once, outputs written once) over the HBM rate, and f32
    operations over the f32 peak; the larger of the two."""
    s, n, d, k = shape
    nbytes = (4 * s * n * d + s * n + 4 * s * k * d + s * k   # inputs
              + 4 * s * n + 4 * s * k * d + 4 * s * k)          # outputs
    return _roofline(nbytes, _assign_ops(shape, mask, act.sum(dim=1)))


def _lloyd_bound_ms(shape, mask, k_act, iters):
    """Least time for ``iters`` Lloyd iterations on these inputs: the bytes
    (coords, mask, c_init and k read once, centers and labels written once),
    and ``iters`` half-steps' operations plus each iteration's D divisions
    per center; the larger of the two."""
    s, n, d, k = shape
    nbytes = (4 * s * n * d + s * n + 4 * s * k * d + 4 * s   # inputs
              + 4 * s * k * d + 4 * s * n)                      # outputs
    n_active = k_act.clamp(0, k)
    ops = iters * (_assign_ops(shape, mask, n_active) + d * s * k)
    return _roofline(nbytes, ops)


def _half_step_loop(torch, x, mask, c_init, k, iters):
    """The loop ``masked_kmeans_table`` ran before the Lloyd kernel: the
    half-step kernel and the eager center update, ``iters`` times."""
    from repro_torch.core.digitize import _lloyd_loop
    from repro_torch.kernels.kmeans import kmeans_assign_cuda

    active = torch.arange(c_init.shape[1], device=x.device)[None] < k[:, None]
    return _lloyd_loop(lambda cen: kmeans_assign_cuda(x, mask, cen, active),
                       c_init, x.shape[1], iters)


def _same(torch, a, b):
    """Bitwise equal, NaN where NaN."""
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _check_lloyd(torch, shape, x, mask, c, k, iters):
    """The Lloyd kernel against the iterated half-step kernel (bitwise),
    against itself (two calls bitwise) and against its plain version
    (labels exact, centers within 1e-5); returns the centers' largest
    absolute difference from the plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.kmeans import kmeans_lloyd_cuda

    what = f"kmeans_lloyd S,N,D,K={shape} iters={iters}"
    c1, l1 = kmeans_lloyd_cuda(x, mask, c, k, iters)
    c2, l2 = kmeans_lloyd_cuda(x, mask, c, k, iters)
    cw, lw = _half_step_loop(torch, x, mask, c, k, iters)
    cp, lp = ref.kmeans_lloyd_ref(x, mask, c, k, iters)
    torch.cuda.synchronize()
    if not (torch.equal(l1, l2) and _same(torch, c1, c2)):
        raise AssertionError(f"{what}: two calls differ")
    if not (torch.equal(l1, lw) and _same(torch, c1, cw)):
        raise AssertionError(f"{what}: differs from the iterated half-step "
                             f"kernel ({int((l1 != lw).sum())} labels)")
    if not torch.equal(l1, lp):
        raise AssertionError(f"{what}: {int((l1 != lp).sum())} labels differ "
                             "from the plain version")
    if bool((l1[~mask] != 0).any()):
        raise AssertionError(f"{what}: masked label != 0")
    torch.testing.assert_close(c1, cp, rtol=1e-5, atol=1e-5,
                               msg=lambda m: f"{what}: {m}")
    err = float((c1 - cp).abs().max()) if c1.numel() else 0.0
    print(f"{what}: bitwise equal to the iterated half-step kernel and "
          f"across two calls; labels exact, centers max_abs_err={err:.3e} "
          f"against the plain version", flush=True)
    return err


def kernel_phase(torch, dev):
    """The half-step kernel, then the Lloyd kernel, against their plain
    versions; returns the kernels line's numbers of both."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.kmeans import kmeans_assign_cuda, kmeans_lloyd_cuda

    measured = {}
    worst = 0.0
    for i, shape in enumerate(TEST_SHAPES + [MAIN_SHAPE] + LLOYD_EXTRA):
        x, mask, c, act = _inputs(torch, shape, 100 + i, dev)
        g = torch.Generator(device="cpu").manual_seed(400 + i)
        k = torch.randint(1, shape[3] + 1, (shape[0],), generator=g,
                          dtype=torch.int32).to(dev)
        worst = max(worst, _check_lloyd(torch, shape, x, mask, c, k,
                                        LLOYD_ITERS))
        if shape == (3, 50, 2, 7):
            for iters in (0, 1):
                worst = max(worst, _check_lloyd(torch, shape, x, mask, c, k,
                                                iters))
        if shape in LLOYD_EXTRA:
            continue
        lk, sk, ck = kmeans_assign_cuda(x, mask, c, act)
        lp, sp, cp = ref.kmeans_assign_ref(x, mask, c, act)
        torch.cuda.synchronize()
        if not torch.equal(lk, lp):
            bad = int((lk != lp).sum())
            raise AssertionError(f"kmeans_assign {shape}: {bad} labels differ")
        if bool((lk[~mask] != 0).any()):
            raise AssertionError(f"kmeans_assign {shape}: masked label != 0")
        if not torch.equal(ck, cp):
            raise AssertionError(f"kmeans_assign {shape}: counts differ")
        torch.testing.assert_close(sk, sp, rtol=1e-5, atol=1e-5)
        err = float((sk - sp).abs().max()) if sk.numel() else 0.0
        print(f"kmeans_assign S,N,D,K={shape}: labels/counts exact, "
              f"sums max_abs_err={err:.3e}", flush=True)
        if shape != MAIN_SHAPE:
            continue
        # the half-step's entry point, its launches counted
        kmeans_assign_cuda.launches = 0
        le, se, ce = ops.kmeans_assign(x, mask, c, act)
        torch.cuda.synchronize()
        entry = kmeans_assign_cuda.launches
        if entry <= 0 or not (torch.equal(le, lk) and torch.equal(se, sk)
                              and torch.equal(ce, ck)):
            raise AssertionError("ops.kmeans_assign did not launch the "
                                 "half-step kernel or differs from it")
        kernel = lambda: kmeans_assign_cuda(x, mask, c, act)
        plain = lambda: ref.kmeans_assign_ref(x, mask, c, act)
        call_ms = _median_ms(torch, kernel)
        plain_call_ms = _median_ms(torch, plain)
        ms = _graph_ms(torch, kernel)
        plain_ms = _graph_ms(torch, plain)
        bound, bound_by = _bound_ms(shape, mask, act)
        print(f"kmeans_assign at the service shape, device time per "
              f"call (CUDA graph of 50): kernel {ms:.5f} ms, plain "
              f"{plain_ms:.5f} ms; one call launched from Python (CUDA "
              f"events, median of 50): kernel {call_ms:.5f} ms, plain "
              f"{plain_call_ms:.5f} ms; bound {bound:.6f} ms "
              f"({bound_by}); ops.kmeans_assign: {entry} launch", flush=True)
        measured["kmeans_assign"] = {
            "launches": entry, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by}

        lloyd = lambda: kmeans_lloyd_cuda(x, mask, c, k, LLOYD_ITERS)
        plain = lambda: ref.kmeans_lloyd_ref(x, mask, c, k, LLOYD_ITERS)
        ms = _graph_ms(torch, lloyd)
        call_ms = _median_ms(torch, lloyd)
        plain_ms = _graph_ms(torch, plain, runs=10, replays=5)
        plain_call_ms = _median_ms(torch, plain, runs=10)
        bound, bound_by = _lloyd_bound_ms(shape, mask, k, LLOYD_ITERS)
        # the loop this kernel replaced: 10 half-step launches and their
        # eager updates, issued from Python
        loop = lambda: _half_step_loop(torch, x, mask, c, k, LLOYD_ITERS)
        loop_ms = _graph_ms(torch, loop, runs=10, replays=5)
        loop_call_ms = _median_ms(torch, loop)
        print(f"kmeans_lloyd at the service shape, {LLOYD_ITERS} iterations, "
              f"k from 1 to {shape[3]} (mean {float(k.float().mean()):.1f}): "
              f"device time per call (CUDA graph) kernel {ms:.5f} ms, plain "
              f"{plain_ms:.5f} ms; one call launched from Python (CUDA "
              f"events) kernel {call_ms:.5f} ms, plain {plain_call_ms:.5f} "
              f"ms; bound {bound:.6f} ms ({bound_by}); the loop of "
              f"{LLOYD_ITERS} half-step launches and eager updates it "
              f"replaces: {loop_ms:.5f} ms device time, {loop_call_ms:.5f} "
              f"ms launched from Python", flush=True)
        # how the time grows with the active centers: every slot at k = 1
        # and at k = K, the same pieces
        by_k = {kk: _graph_ms(torch, lambda kk=kk: kmeans_lloyd_cuda(
            x, mask, c, torch.full_like(k, kk), LLOYD_ITERS))
            for kk in (1, shape[3])}
        print("kmeans_lloyd at the service shape, device time per call with "
              "every slot at " + ", ".join(f"k={kk}: {v:.5f} ms"
                                           for kk, v in by_k.items()),
              flush=True)
        measured["kmeans_lloyd"] = {"ms": ms, "plain_ms": plain_ms,
                                    "bound_ms": bound, "bound_by": bound_by}
    measured["kmeans_lloyd"]["max_abs_err"] = worst
    return measured


def _dtw_cells(b, n, band):
    """Cells of a (B, N, N) banded DTW: |i - j| <= r, r = N when full."""
    r = n if band is None else max(int(band), 0)
    k = min(r, n - 1)
    return b * (n + 2 * (k * n - k * (k + 1) // 2))


def _dtw_bound_ms(b, n, band):
    """Least time for a batch of DTW pairs: five f32 operations per cell in
    the band (a subtract, a fused multiply-add, two minima) over the f32
    peak, and
    the bytes (x and y read once, the distances written once) over the HBM
    rate; the larger of the two.  The 2N - 1 dependent diagonals are a
    latency floor this does not count."""
    t_ops = 5 * _dtw_cells(b, n, band) / PEAK_F32_FLOPS * 1e3
    t_bytes = (2 * 4 * b * n + 4 * b) / PEAK_BYTES_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _pairs(torch, b, n, seed, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((b, n), generator=g).cumsum(1)
    y = x + 0.3 * torch.randn((b, n), generator=g)
    return x.to(dev), y.to(dev)


def dtw_phase(torch, dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels.dtw import _lib, dtw_cuda

    if _lib().dtw_smem_bytes(DTW_GLOBAL[1]) != 0:
        raise AssertionError(f"dtw N={DTW_GLOBAL[1]} no longer takes the "
                             "global-scratch branch")
    print(f"dtw shared memory per CTA at N={POINTS}: "
          f"{_lib().dtw_smem_bytes(POINTS)} bytes; N={DTW_GLOBAL[1]} runs "
          f"over the global scratch", flush=True)
    measured = None
    worst = 0.0
    monitor_ms = 0.0
    for i, (b, n, band) in enumerate(DTW_SHAPES + DTW_MONITOR):
        x, y = _pairs(torch, b, n, 200 + i, dev)
        got = dtw_cuda(x, y, band)
        want = ref.dtw_batch_ref(x, y, band)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            err = float((got - want).abs().max())
            raise AssertionError(f"dtw B,N,band={(b, n, band)}: differs from "
                                 f"the plain version, max abs {err:.3e}")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"dtw B,N,band={(b, n, band)}: not finite")
        err = float((got - want).abs().max())
        worst = max(worst, err)
        print(f"dtw B,N,band={(b, n, band)}: bitwise equal to the plain "
              f"version (max_abs_err={err:.3e})", flush=True)
        if (b, n, band) in DTW_TIMED:
            kernel = lambda: dtw_cuda(x, y, band)
            ms = _graph_ms(torch, kernel, runs=10, replays=5)
            call_ms = _median_ms(torch, kernel, runs=10, warmup=2)
            bound, bound_by = _dtw_bound_ms(b, n, band)
            line = (f"dtw at B={b}, N={n}, band={band}: device time per call "
                    f"(CUDA graph of 10, median of 5 replays) kernel "
                    f"{ms:.5f} ms, {ms / bound:.2f}x its bound "
                    f"{bound:.6f} ms ({bound_by}; {_dtw_cells(b, n, band)} "
                    f"cells; the {2 * n - 1} dependent diagonals are a "
                    f"latency floor the roofline does not count); one call "
                    f"launched from Python (CUDA events, median of 10) "
                    f"{call_ms:.5f} ms")
            if (b, n, band) in DTW_MONITOR:
                monitor_ms += ms
            if (b, n, band) == DTW_MAIN:
                # warm from the check above; one call is about 2.5 s
                plain_ms = _median_ms(
                    torch, lambda: ref.dtw_batch_ref(x, y, band), runs=3,
                    warmup=0)
                line += (f"; plain version (CUDA events, median of 3) "
                         f"{plain_ms:.5f} ms")
                measured = {"ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound, "bound_by": bound_by}
            print(line, flush=True)
    print(f"dtw: the monitor's {len(DTW_MONITOR)} launches per service run "
          f"(N={', '.join(str(n) for _, n, _ in DTW_MONITOR)}) take "
          f"{monitor_ms:.5f} ms of device time", flush=True)
    return {"max_abs_err": worst, **measured}


def _ewma_bound_ms(b, t):
    """Least time for one EWMA/EWMV scan of (B, T): 12 bytes per point
    (t read once, the mean and the var written once) over the HBM rate, and
    8 f32 operations per point (mean: a multiply and a fused multiply-add;
    var: a subtract, two multiplies and a fused multiply-add) over the f32
    peak; the larger of the two.  The T dependent steps of a row are a
    latency floor this does not count."""
    t_bytes = 12 * b * t / PEAK_BYTES_PER_S * 1e3
    t_ops = 8 * b * t / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _ewma_check(torch, ts, got, want, tol, what):
    """Kernel output ``got`` against the plain version's ``want``: point 0
    exact (t_0 and 1.0), means and vars within ``tol``; returns the largest
    absolute difference."""
    (m, v), (pm, pv) = got, want
    if m.shape != ts.shape or v.shape != ts.shape:
        raise AssertionError(f"ewma {what}: shapes {tuple(m.shape)}, "
                             f"{tuple(v.shape)}")
    if not (torch.equal(m[:, 0], ts[:, 0]) and bool((v[:, 0] == 1).all())):
        raise AssertionError(f"ewma {what}: point 0 is not (t_0, 1.0)")
    torch.testing.assert_close(m, pm, **tol[0], msg=lambda e: f"ewma {what} "
                               f"means: {e}")
    torch.testing.assert_close(v, pv, **tol[1], msg=lambda e: f"ewma {what} "
                               f"vars: {e}")
    return max(float((m - pm).abs().max()), float((v - pv).abs().max()))


def ewma_phase(torch, dev):
    """The EWMA kernel's entry point on the fleet slab, then the kernel
    against its plain version; returns the kernels line's numbers."""
    from repro_torch.core import normalize
    from repro_torch.data.synthetic import make_fleet
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ewma import ewma_scan_cuda

    slab_cpu = torch.from_numpy(make_fleet(SESSIONS, POINTS, seed=0))
    slab = slab_cpu.to(dev)
    ewma_scan_cuda.launches = 0
    means, vars_ = ops.ewma_scan(slab, EWMA_ALPHA)
    z = normalize.standardize(slab, means, vars_)
    torch.cuda.synchronize()
    launches = ewma_scan_cuda.launches
    if launches <= 0:
        raise AssertionError("ops.ewma_scan never launched the ewma kernel")
    if z.shape != slab.shape or not bool(torch.isfinite(z).all()):
        raise AssertionError("ewma: the fleet slab's z-scores are not finite")
    plain = ref.ewma_scan_ref(slab, EWMA_ALPHA)
    on_cpu = ref.ewma_scan_ref(slab_cpu, EWMA_ALPHA)
    for got, want, what in zip(plain, on_cpu, ("means", "vars")):
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"ewma fleet slab: the plain version's {what}"
                                 " on the card differ from the CPU's")
    err = _ewma_check(torch, slab, (means, vars_), plain, EWMA_TOL,
                      "fleet slab")
    print(f"ewma entry point on the fleet slab B,T={tuple(slab.shape)}, "
          f"alpha={EWMA_ALPHA}: {launches} kernel launch, z-scores finite, "
          f"point 0 exact, max_abs_err={err:.3e} against the plain version, "
          f"which is bitwise equal to the CPU's", flush=True)

    g = torch.Generator(device="cpu").manual_seed(300)
    cases = [(torch.randn(b, t, generator=g) * 2.0, alpha, EWMA_TOL)
             for b, t, alpha in EWMA_SHAPES]
    b, t, alpha = EWMA_LARGE
    cases.append((1000.0 + 5.0 * torch.randn(b, t, generator=g), alpha,
                  EWMA_LARGE_TOL))
    b, t, alpha = EWMA_OFFSET
    offset = torch.randn(b * t + 1, generator=g).to(dev)[1:].view(b, t)
    cases.append((offset, alpha, EWMA_TOL))
    timed = []  # (alpha, slab) pairs to time: kernels_bench.py's, the fleet
    for ts, alpha, tol in cases:
        ts = ts.to(dev)
        copies = ("16-byte" if ts.shape[1] % 4 == 0 and ts.data_ptr() % 16 == 0
                  else "4-byte")
        what = f"B,T={tuple(ts.shape)} alpha={alpha} ({copies} copies)"
        got = ewma_scan_cuda(ts, alpha)
        again = ewma_scan_cuda(ts, alpha)
        want = ref.ewma_scan_ref(ts, alpha)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], again[0]) and torch.equal(got[1],
                                                              again[1])):
            raise AssertionError(f"ewma {what}: two calls differ")
        e = _ewma_check(torch, ts, got, want, tol, what)
        print(f"ewma {what}: point 0 exact, within tolerance, two calls "
              f"bitwise equal (max_abs_err={e:.3e})", flush=True)
        if tuple(ts.shape) == (64, 2048):
            timed.append((alpha, ts))
    timed.append((EWMA_ALPHA, slab))

    measured = None
    for alpha, ts in timed:
        b, t = ts.shape
        kernel = lambda: ewma_scan_cuda(ts, alpha)
        ms = _graph_ms(torch, kernel)
        call_ms = _median_ms(torch, kernel)
        # warm from the checks above; about 2047 eager steps of ewm_step
        plain_ms = _median_ms(torch, lambda: ref.ewma_scan_ref(ts, alpha),
                              runs=3, warmup=0)
        bound, bound_by = _ewma_bound_ms(b, t)
        print(f"ewma at B={b}, T={t}, alpha={alpha}: device time per call "
              f"(CUDA graph of 50, median of 10 replays) kernel {ms:.5f} ms; "
              f"one call launched from Python (CUDA events, median of 50) "
              f"{call_ms:.5f} ms; plain version (CUDA events, median of 3) "
              f"{plain_ms:.5f} ms; bound {bound:.6f} ms ({bound_by}; the "
              f"{t - 1} dependent steps of a row are a latency floor the "
              f"roofline does not count)", flush=True)
        if (b, t) == (SESSIONS, POINTS):
            measured = {"launches": launches, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": bound_by}
    return measured


def _reset_launches():
    from repro_torch.core import digitize
    from repro_torch.kernels.dtw import dtw_cuda
    from repro_torch.kernels.ewma import ewma_scan_cuda
    from repro_torch.kernels.kmeans import kmeans_assign_cuda, kmeans_lloyd_cuda

    for fn in (kmeans_assign_cuda, kmeans_lloyd_cuda, dtw_cuda,
               ewma_scan_cuda):
        fn.launches = 0
    digitize.host_syncs = 0


def _launches():
    """The kernels' launches and the host syncs since ``_reset_launches``."""
    from repro_torch.core import digitize
    from repro_torch.kernels.dtw import dtw_cuda
    from repro_torch.kernels.ewma import ewma_scan_cuda
    from repro_torch.kernels.kmeans import kmeans_assign_cuda, kmeans_lloyd_cuda

    return {"kmeans_lloyd": kmeans_lloyd_cuda.launches,
            "kmeans_assign": kmeans_assign_cuda.launches,
            "dtw": dtw_cuda.launches, "ewma": ewma_scan_cuda.launches,
            "host_syncs": digitize.host_syncs}


def _serve(torch, cfg, data, *, device, use_kernel, window, clock=None,
           dtw_every=0, check_rows=(), rows=None):
    """Round-robin arrivals of every row of ``data``, then close all.

    Session ``s{r}`` carries the row ``data[i]`` for ``r = rows[i]`` (by
    default ``r = i``), and its digitizer key is ``fold_in(key(0), r + 1)``
    (the server's own default for the ``r``-th session opened), so a
    session gets the same key whichever rows are served.  For each row index
    in ``check_rows``, the final DTW reading is recomputed from the slot
    table with the plain DTW before the close."""
    from repro_torch.core import prng
    from repro_torch.launch.stream import StreamServer

    n_sessions, length = data.shape
    server = StreamServer(cfg, max_sessions=n_sessions, window_cap=window,
                          digitize_every_k=1, use_kernel=use_kernel,
                          dtw_every=dtw_every, device=device, clock=clock)
    rows = range(n_sessions) if rows is None else rows
    sids = [f"s{r}" for r in rows]
    base = prng.key(0)
    for r, sid in zip(rows, sids):
        server.open(sid, key=prng.fold_in(base, r + 1))
    labels = {sid: [] for sid in sids}
    ends = {sid: [] for sid in sids}
    t0 = time.perf_counter()
    for w in range(0, length, window):
        got = server.ingest_many({sid: data[i, w: w + window]
                                  for i, sid in enumerate(sids)})
        for sid, d in got.items():
            labels[sid].append(d["labels"])
            ends[sid].append(d["endpoints"])
    t_ingest = time.perf_counter() - t0
    rounds = server.totals["steps"]
    for row in check_rows:
        _check_reading(torch, server, f"s{row}", data[row])
    closed = {sid: server.close(sid) for sid in sids}
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = {"wall": wall, "ingest": t_ingest, "rounds": rounds,
             "points": int(server.totals["points_in"]),
             "dtw_seconds": server.monitor["dtw_seconds"],
             "dtw_readings": server.monitor["dtw_readings"]}
    return _session_outputs(labels, ends, closed), stats


def _session_outputs(labels, ends, closed):
    """Each session's joined delta frames (every round's and the closing
    one) and its close summary."""
    import numpy as np

    out = {}
    for sid, res in closed.items():
        out[sid] = {
            "labels": np.concatenate(labels[sid] + [res["delta"]["labels"]]),
            "endpoints": np.concatenate(ends[sid]
                                        + [res["delta"]["endpoints"]]),
            "n_pieces": res["n_pieces"], "t_seen": res["t_seen"],
            "k": int(res["out"]["k"]), "dtw": res["dtw"],
        }
    return out


def _check_reading(torch, server, sid, raw):
    """A session's latest monitor reading against the plain DTW of its
    pieces so far, on the table's device: bitwise."""
    from repro_torch.core.receiver import pieces_from_wire
    from repro_torch.core.reconstruct import reconstruct_from_pieces
    from repro_torch.kernels import ref

    stats = server.session_stats(sid)
    slot, t = stats["slot"], server._table
    lens, incs = pieces_from_wire(t.endpoints[slot], t.steps[slot],
                                  t.n_pieces[slot], t.t0[slot])
    rec = reconstruct_from_pieces(lens, incs, t.n_pieces[slot], t.t0[slot],
                                  stats["t_seen"])
    raw = torch.from_numpy(raw[: stats["t_seen"]]).to(server.device)
    want = float(ref.dtw_batch_ref(raw[None], rec[None], server.dtw_band)[0])
    if stats["dtw"] != want:
        raise AssertionError(f"{sid}: monitor reading {stats['dtw']!r} != "
                             f"plain DTW {want!r}")


def _compare(a, b, what):
    """Sender/wire outputs bitwise; returns (agreeing symbols, total)."""
    import numpy as np

    agree = total = 0
    for sid in a:
        for key in ("n_pieces", "t_seen"):
            if a[sid][key] != b[sid][key]:
                raise AssertionError(f"{what} {sid}: {key} differs")
        if not np.array_equal(a[sid]["endpoints"], b[sid]["endpoints"]):
            raise AssertionError(f"{what} {sid}: delta endpoints differ")
        la, lb = a[sid]["labels"], b[sid]["labels"]
        if la.shape != lb.shape:
            raise AssertionError(f"{what} {sid}: symbol counts differ")
        agree += int((la == lb).sum())
        total += la.size
    return agree, total


def _paper_cfg():
    """The paper's settings, ``repro_torch.configs.PAPER_SYMED``."""
    from repro_torch.configs import PAPER_SYMED
    from repro_torch.core.symed import SymEDConfig

    want = SymEDConfig(tol=0.5, alpha=0.01, scl=1.0, k_min=3, k_max=100,
                       n_max=512, len_max=512)
    if PAPER_SYMED != want:
        raise AssertionError(f"PAPER_SYMED is {PAPER_SYMED}, not {want}")
    return PAPER_SYMED


def _small_case():
    """A config small enough that k reaches k_max, and its 4 streams."""
    from repro_torch.core.symed import SymEDConfig
    from repro_torch.data.synthetic import make_fleet

    return (SymEDConfig(tol=0.5, alpha=0.02, scl=1.0, k_min=3, k_max=8,
                        len_max=32, n_max=64, lloyd_iters=5),
            make_fleet(4, 160, seed=1))


def _encode(torch, ts, cfg, i, dev):
    """``symed_encode(reconstruct=True)`` of one stream, as numpy."""
    from repro_torch.core import prng
    from repro_torch.core.symed import symed_encode

    out = symed_encode(torch.from_numpy(ts), cfg, prng.key(i, dev),
                       device=dev)
    return {k: out[k].cpu().numpy() for k in
            ("n_pieces", "pieces_len", "symbols", "re_pieces", "re_symbols")}


def _cpu_reference():
    """The CPU port's side of phase 6's cross-device checks: the 8
    ``CHECK_ROWS`` sessions at the paper's settings with the DTW monitor,
    the small config, and ``symed_encode`` on the ``ENCODE_ROWS``.  Runs in
    a worker process while the card works; every input is made here from
    the same seeds."""
    import torch

    from repro_torch.data.synthetic import make_fleet

    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    cfg = _paper_cfg()
    data = make_fleet(SESSIONS, POINTS, seed=0)
    t0 = time.perf_counter()
    paper, _ = _serve(torch, cfg, data[list(CHECK_ROWS)], device="cpu",
                      use_kernel=False, window=WINDOW, dtw_every=DTW_EVERY,
                      rows=CHECK_ROWS)
    small_cfg, small_data = _small_case()
    small, _ = _serve(torch, small_cfg, small_data, device="cpu",
                      use_kernel=False, window=32)
    encode = [_encode(torch, data[r], cfg, i, "cpu")
              for i, r in enumerate(ENCODE_ROWS)]
    return {"paper": paper, "small": small, "encode": encode,
            "seconds": time.perf_counter() - t0}


def _closed_outputs(res):
    """Each fed session's sender/wire outputs and symbols, from the close
    results of a ``ReplayResult`` (numpy, picklable)."""
    out = {}
    for sid, r in res.closed.items():
        if r["out"] is None:
            continue
        n = int(r["n_pieces"])
        out[sid] = {"n_pieces": n, "t_seen": int(r["t_seen"]),
                    "pieces_len": r["out"]["pieces_len"][:n],
                    "pieces_inc": r["out"]["pieces_inc"][:n],
                    "labels": r["out"]["symbols_online"][:n]}
    return out


def _zoo_reference():
    """The CPU port's replay of each zoo scenario at its defaults."""
    import torch

    from repro_torch.workload import Workload, replay_trace

    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    t0 = time.perf_counter()
    out = {}
    for name in ZOO:
        wl = Workload(name)
        res = replay_trace(wl.trace(), server_kw=wl.server_kw(),
                           device="cpu")
        out[name] = {"counters": res.counters,
                     "sessions": _closed_outputs(res)}
    out["seconds"] = time.perf_counter() - t0
    return out


def _cpu_worker(conn) -> None:
    """Worker process: send ``("ok", _cpu_reference())``, then
    ``("ok", _zoo_reference())`` and ``("ok", _abba_reference())``, or the
    failure."""
    try:
        conn.send(("ok", _cpu_reference()))
        conn.send(("ok", _zoo_reference()))
        conn.send(("ok", _abba_reference()))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def _recv(cpu_results, what):
    t_wait = time.perf_counter()
    status, got = cpu_results.recv()
    if status != "ok":
        raise RuntimeError(f"the CPU port's worker failed:\n{got}")
    print(f"CPU port's side of {what} ({got['seconds']:.1f} s in a worker "
          f"process; waited {time.perf_counter() - t_wait:.1f} s for it)",
          flush=True)
    return got


def _against_cpu(on_gpu, on_cpu, what, dtw_every=0):
    """The cuda kernel path against the CPU port on the same sessions:
    sender and wire outputs bitwise, at least 99% of symbols equal, DTW
    readings within 1e-4 relative."""
    on_gpu = {sid: on_gpu[sid] for sid in on_cpu}
    agree, total = _compare(on_gpu, on_cpu, f"cuda vs cpu, {what}")
    if agree < 0.99 * total:
        raise AssertionError(f"cuda vs cpu, {what}: symbols {agree}/{total}")
    ks = [res["k"] for res in on_gpu.values()]
    line = (f"{what}, cuda kernel path vs cpu port: sender/wire bitwise for "
            f"{len(on_gpu)} sessions, symbols {agree}/{total} agree, k up to "
            f"{max(ks)}")
    if dtw_every:
        rel = 0.0
        for sid, res in on_gpu.items():
            a, b = res["dtw"], on_cpu[sid]["dtw"]
            if a is None or b is None:
                raise AssertionError(f"cuda vs cpu, {what} {sid}: no reading")
            rel = max(rel, abs(a - b) / max(abs(b), 1e-30))
        if rel > 1e-4:
            raise AssertionError(f"cuda vs cpu, {what}: DTW readings differ "
                                 f"by {rel:.3e} relative")
        line += f", DTW readings within {rel:.3e} relative"
    print(line, flush=True)


def _encode_against_cpu(torch, dev, cfg, data, on_cpu):
    """``symed_encode(reconstruct=True)`` on cuda against the CPU port's
    outputs: pieces equal, ``re_pieces`` within 1e-4 relative,
    ``re_symbols`` too where the symbols agree."""
    import numpy as np

    for i, r in enumerate(ENCODE_ROWS):
        t0 = time.perf_counter()
        g = _encode(torch, data[r], cfg, i, dev)
        t_gpu = time.perf_counter() - t0
        c = on_cpu[i]
        rp_g, rp_c = float(g["re_pieces"]), float(c["re_pieces"])
        rs_g, rs_c = float(g["re_symbols"]), float(c["re_symbols"])
        if not (np.array_equal(g["n_pieces"], c["n_pieces"])
                and np.array_equal(g["pieces_len"], c["pieces_len"])):
            raise AssertionError(f"symed_encode stream {i}: pieces differ")
        if abs(rp_g - rp_c) > 1e-4 * abs(rp_c):
            raise AssertionError(f"symed_encode stream {i}: re_pieces "
                                 f"{rp_g} vs {rp_c}")
        same = np.array_equal(g["symbols"], c["symbols"])
        if same and abs(rs_g - rs_c) > 1e-4 * abs(rs_c):
            raise AssertionError(f"symed_encode stream {i}: re_symbols "
                                 f"{rs_g} vs {rs_c}")
        print(f"symed_encode(reconstruct=True) stream {i} (row {r}), cuda vs "
              f"cpu: re_pieces {rp_g!r} vs {rp_c!r}; re_symbols {rs_g!r} vs "
              f"{rs_c!r} (symbols {'equal' if same else 'differ'}); cuda "
              f"call {t_gpu:.2f} s", flush=True)


def end_to_end_phase(torch, dev):
    """Phase 6's service runs on the card; returns the Lloyd and DTW
    kernels' launches and the kernel run's sessions."""
    import numpy as np

    from repro_torch.data.synthetic import make_fleet
    from repro_torch.launch.stream import PhaseClock

    cfg = _paper_cfg()
    data = make_fleet(SESSIONS, POINTS, seed=0)
    clock = PhaseClock(torch.device(dev))

    check_rows = CHECK_ROWS
    _reset_launches()
    krn, t_krn = _serve(torch, cfg, data, device=dev, use_kernel=True,
                        window=WINDOW, clock=clock, dtw_every=DTW_EVERY,
                        check_rows=check_rows)
    counts = _launches()
    launches = {name: counts[name] for name in ("kmeans_lloyd", "dtw")}
    syncs = counts["host_syncs"]
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the service never launched the {name} "
                                 "kernel")
    if counts["kmeans_assign"]:
        raise AssertionError(f"the service launched the half-step kernel "
                             f"{counts['kmeans_assign']} times: its Lloyd "
                             "loops run in the Lloyd kernel")
    if counts["ewma"]:
        raise AssertionError("the service launched the ewma kernel: its "
                             "sender normalizes one point at a time")
    readings = [res["dtw"] for res in krn.values()]
    if any(r is None or not np.isfinite(r) for r in readings):
        raise AssertionError("a session has no finite DTW reading")
    print(f"DTW monitor: {launches['dtw']} kernel launches, "
          f"{t_krn['dtw_readings']} readings, "
          f"{t_krn['dtw_seconds']:.3f} s of {t_krn['wall']:.2f} s wall "
          f"({100 * t_krn['dtw_seconds'] / t_krn['wall']:.2f}%), mean final "
          f"reading {float(np.mean(readings)):.4f}; the final readings of "
          f"rows {list(check_rows)} bitwise equal to the plain DTW on the "
          f"card", flush=True)

    plain_rows = range(0, SESSIONS, PLAIN_STRIDE)
    plain, t_plain = _serve(torch, cfg, data[::PLAIN_STRIDE], device=dev,
                            use_kernel=False, window=WINDOW,
                            dtw_every=DTW_EVERY, rows=plain_rows)
    agree, total = _compare(plain, krn, "kernel vs plain")
    if any(krn[sid]["dtw"] != plain[sid]["dtw"] for sid in plain):
        raise AssertionError("kernel vs plain k-means: DTW readings differ "
                             "though the pieces are bitwise equal")
    share = agree / max(total, 1)
    diff = sorted(sid for sid in plain
                  if not np.array_equal(krn[sid]["labels"],
                                        plain[sid]["labels"]))
    for sid, res in krn.items():
        if res["k"] > 100 or (res["labels"] >= res["k"]).any():
            raise AssertionError(f"{sid}: symbol >= k={res['k']} or k > 100")
    if share < 0.99:
        raise AssertionError(f"symbol agreement {share:.4f} < 0.99")

    rounds = t_krn["rounds"]
    split = clock.totals
    print(f"end to end: {SESSIONS} sessions x {POINTS} points, {rounds} "
          f"rounds; "
          f"Lloyd kernel launches {launches['kmeans_lloyd']}, half-step "
          f"kernel launches 0, host syncs "
          f"{syncs} "
          f"({syncs / max(rounds, 1):.1f} per round + 1 harvest copy); "
          f"ewma kernel launches 0, as in the reference", flush=True)
    print(f"end to end (kernel): {t_krn['points'] / t_krn['wall']:.1f} "
          f"points/s over {t_krn['wall']:.2f} s, "
          f"{1e3 * t_krn['ingest'] / rounds:.2f} ms per round "
          + ", ".join(f"{k} {v / rounds:.2f} ms" for k, v in split.items()),
          flush=True)
    print(f"end to end (plain k-means, {len(plain_rows)} sessions): "
          f"{t_plain['points'] / t_plain['wall']:.1f} points/s over "
          f"{t_plain['wall']:.2f} s, "
          f"{1e3 * t_plain['ingest'] / t_plain['rounds']:.2f} ms per round",
          flush=True)
    print(f"kernel vs plain: sender/wire bitwise for {len(plain_rows)} "
          f"sessions, "
          f"symbols "
          f"{agree}/{total} agree ({100 * share:.3f}%), sessions differing: "
          f"{diff[:8]}{' ...' if len(diff) > 8 else ''}", flush=True)

    return launches, krn


def cross_device_phase(torch, dev, krn, cpu_results):
    """The card against the CPU port: 8 of phase 6's sessions, spread over
    the fleet's families, at the paper's widths (``krn``, the kernel run);
    a config small enough that k reaches k_max; ``symed_encode``.
    ``cpu_results`` is the pipe end on which ``_cpu_worker`` sends the CPU
    port's side."""
    from repro_torch.data.synthetic import make_fleet

    cfg = _paper_cfg()
    data = make_fleet(SESSIONS, POINTS, seed=0)
    small_cfg, small_data = _small_case()
    small, _ = _serve(torch, small_cfg, small_data, device=dev,
                      use_kernel=True, window=32)
    cpu = _recv(cpu_results, "phase 6")
    _against_cpu(krn, cpu["paper"], "paper config, 8 sessions",
                 dtw_every=DTW_EVERY)
    _against_cpu(small, cpu["small"], "small config")
    _encode_against_cpu(torch, dev, cfg, data, cpu["encode"])


def _sender_half(torch, cfg, data, dev, window):
    """Phase 7 (a)'s senders: one batched ``symed_encode_chunk`` per window
    over every row on the card (the batched EWMV rounding, as the raw-in
    table's sender), then ``pieces_on_wire`` per row.  Returns the
    arrivals of each window and of the tails, ``{sid: arrival}`` each."""
    from repro_torch.core.compress import compressor_finalize, pieces_on_wire
    from repro_torch.core.symed import symed_encode_chunk

    length = data.shape[1]
    rounds, state = [], None
    for w in range(0, length, window):
        state, ev = symed_encode_chunk(torch.from_numpy(data[:, w: w + window]),
                                       cfg, state, device=dev)
        host = {k: ev[k].cpu().numpy() for k in ("emit", "endpoint")}
        arrivals = {}
        for r in range(data.shape[0]):
            eps, steps = pieces_on_wire({k: v[r] for k, v in host.items()}, w)
            arrivals[f"s{r}"] = {"endpoints": eps, "steps": steps,
                                 "t_seen": min(w + window, length),
                                 "t0": float(data[r, 0])}
        rounds.append(arrivals)
    tail = compressor_finalize(state)
    emit, ends = tail.emit.cpu().numpy(), tail.endpoint.cpu().numpy()
    tails = {f"s{r}": {"endpoints": ends[r: r + 1], "steps": [length],
                       "t_seen": length, "t0": float(data[r, 0])}
             for r in range(data.shape[0]) if emit[r]}
    return rounds, tails


def _stream_server(cfg, n_sessions, dev, window, **kw):
    """A ``StreamServer`` of ``n_sessions`` slots digitizing every window,
    with sessions ``s0`` ... open, ``s{r}`` on phase 6's key for row
    ``r``."""
    from repro_torch.core import prng
    from repro_torch.launch.stream import StreamServer

    server = StreamServer(cfg, max_sessions=n_sessions, window_cap=window,
                          digitize_every_k=1, device=dev, **kw)
    base = prng.key(0)
    for r in range(n_sessions):
        server.open(f"s{r}", key=prng.fold_in(base, r + 1))
    return server


def _receiver_half(torch, cfg, rounds, tails, dev, window, clock):
    """Phase 7 (a)'s edge: a ``StreamServer`` with the kernel on that only
    digitizes.  Session ``s{r}`` has phase 6's key for row ``r``."""
    sids = list(rounds[0])
    server = _stream_server(cfg, len(sids), dev, window, use_kernel=True,
                            clock=clock)
    labels = {sid: [] for sid in sids}
    ends = {sid: [] for sid in sids}
    t0 = time.perf_counter()
    for arrivals in [*rounds, tails]:
        for sid, d in server.ingest_pieces_many(arrivals).items():
            labels[sid].append(d["labels"])
            ends[sid].append(d["endpoints"])
    t_ingest = time.perf_counter() - t0
    rounds_run = server.totals["steps"]
    closed = {sid: server.close(sid) for sid in sids}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = {"wall": wall, "ingest": t_ingest, "rounds": rounds_run,
             "points": int(server.totals["points_in"]),
             "bytes_in": server.totals["bytes_in"]}
    return _session_outputs(labels, ends, closed), stats


def _tcp_run(torch, cfg, data, dev):
    """Phase 7 (b): a ``TransportServer`` on the card in a thread and one
    ``SenderClient`` (compressing on the card) interleaving the
    ``CHECK_ROWS`` sessions on one socket.  Returns each session's result
    and delta stream, the transport's summary and the wall time."""
    import threading

    from repro_torch.launch.stream import StreamServer
    from repro_torch.launch.transport import (
        SenderClient, TransportServer, session_seed)

    server = StreamServer(cfg, max_sessions=TCP_SLOTS, window_cap=WINDOW,
                          digitize_every_k=1, autoscale=True,
                          min_slots=TCP_MIN_SLOTS, device=dev)
    transport = TransportServer(server, port=0)
    rows = {f"tcp-{r}": r for r in CHECK_ROWS}
    modes = {sid: "pieces" if i < TCP_PIECES else "raw"
             for i, sid in enumerate(rows)}
    failure = []

    def serve():
        try:
            transport.serve(expect_sessions=len(rows))
        except BaseException:
            failure.append(traceback.format_exc())
            transport.shutdown()
            raise

    thread = threading.Thread(target=serve, daemon=True)
    t0 = time.perf_counter()
    thread.start()
    client = SenderClient("127.0.0.1", transport.port, cfg)
    if client.device.type != torch.device(dev).type:
        raise AssertionError(f"the sender compresses on {client.device}")
    try:
        for sid, r in rows.items():
            client.open(sid, session_seed(sid, 0), mode=modes[sid])
        for w in range(0, POINTS, WINDOW):
            for sid, r in rows.items():
                client.send(sid, data[r, w: w + WINDOW])
        results = {sid: client.close(sid) for sid in rows}
        deltas = {sid: client.delta_concat(sid) for sid in rows}
    finally:
        client.shutdown()
        thread.join(timeout=120)
    if failure or thread.is_alive():
        raise AssertionError("the transport server failed:\n"
                             + "".join(failure or ["it did not exit"]))
    torch.cuda.synchronize()
    return (rows, results, deltas, transport.summary(),
            server.report(1.0), time.perf_counter() - t0)


def compressed_in_phase(torch, dev, krn, krn_launches):
    """Phase 7: (a) the compressed-in service against phase 6's raw-in
    kernel run ``krn``; (b) the same path over loopback TCP against
    ``symed_encode`` on the card."""
    from repro_torch.data.synthetic import make_fleet
    from repro_torch.launch.stream import PhaseClock
    from repro_torch.launch.transport import check_deltas, session_seed

    cfg = _paper_cfg()
    data = make_fleet(SESSIONS, POINTS, seed=0)

    # (a) in process
    t0 = time.perf_counter()
    rounds, tails = _sender_half(torch, cfg, data, dev, WINDOW)
    torch.cuda.synchronize()
    t_sender = time.perf_counter() - t0
    clock = PhaseClock(torch.device(dev))
    _reset_launches()
    pcs, t_pcs = _receiver_half(torch, cfg, rounds, tails, dev, WINDOW, clock)
    counts = _launches()
    lloyd, syncs = counts["kmeans_lloyd"], counts["host_syncs"]
    others = {"half-step": counts["kmeans_assign"], "DTW": counts["dtw"],
              "EWMA": counts["ewma"]}
    if lloyd <= 0:
        raise AssertionError("the compressed-in service never launched the "
                             "Lloyd kernel")
    for name, n in others.items():
        if n:
            raise AssertionError(f"the compressed-in service launched the "
                                 f"{name} kernel {n} times")
    agree, total = _compare(pcs, krn, "compressed-in vs raw-in")
    if agree < 0.99 * total:
        raise AssertionError(f"compressed-in vs raw-in: symbols "
                             f"{agree}/{total}")
    rounds_run = t_pcs["rounds"]
    raw_bytes = 4.0 * t_pcs["points"]
    print(f"compressed-in (a): {SESSIONS} sessions x {POINTS} points, "
          f"{rounds_run} rounds ({len(rounds)} windows + the tails of "
          f"{len(tails)} sessions); pieces, endpoints and n_pieces bitwise "
          f"equal to phase 6's raw-in run, symbols {agree}/{total} agree "
          f"({100 * agree / max(total, 1):.3f}%)", flush=True)
    print(f"compressed-in (a): Lloyd kernel launches {lloyd} (raw-in, phase "
          f"6: {krn_launches}), half-step, DTW and EWMA kernel launches 0; "
          f"host syncs {syncs} ({syncs / max(rounds_run, 1):.1f} per round "
          f"+ 1 harvest copy)", flush=True)
    print(f"compressed-in (a): {t_pcs['points'] / t_pcs['wall']:.1f} "
          f"raw-equivalent points/s over {t_pcs['wall']:.2f} s (receiver, "
          f"close included), {1e3 * t_pcs['ingest'] / rounds_run:.2f} ms per "
          f"round "
          + ", ".join(f"{k} {v / rounds_run:.2f} ms"
                      for k, v in clock.totals.items())
          + f"; the sender half apart: {t_sender:.2f} s "
          f"({1e3 * t_sender / len(rounds):.2f} ms per window of {SESSIONS} "
          f"senders); bytes in {t_pcs['bytes_in']:.0f} for "
          f"{raw_bytes:.0f} raw bytes ({t_pcs['bytes_in'] / raw_bytes:.4f} "
          f"of 4 B per point)", flush=True)

    # (b) over loopback TCP
    rows, results, deltas, summ, rep, wall = _tcp_run(
        torch, cfg, data, dev)
    agree = total = 0
    for sid, r in rows.items():
        res = results[sid]
        if res["t_seen"] != POINTS:
            raise AssertionError(f"tcp {sid}: t_seen {res['t_seen']}")
        agree += check_deltas(f"tcp {sid}", *deltas[sid], res,
                              torch.from_numpy(data[r]).to(dev), cfg,
                              session_seed(sid, 0), 0.99)
        total += res["n_pieces"]
    print(f"compressed-in (b), loopback TCP: {len(rows)} sessions "
          f"({TCP_PIECES} pieces, {len(rows) - TCP_PIECES} raw) x {POINTS} "
          f"points on one socket, table {TCP_MIN_SLOTS}..{TCP_SLOTS} slots "
          f"(capacity {int(rep['capacity'])}, {int(rep['grows'])} grows); "
          f"n_pieces and endpoints bitwise equal to symed_encode on the "
          f"card, symbols {agree}/{total} agree; pieces_ratio "
          f"{summ['pieces_ratio']:.4f}; wall {wall:.2f} s", flush=True)


def _lat(res):
    lat = res.latency
    return (f"symbol latency p50/p99/p999 {lat['p50_ms']:.3f}/"
            f"{lat['p99_ms']:.3f}/{lat['p999_ms']:.3f} ms over "
            f"{int(lat['count'])} symbols")


def zoo_phase(torch, dev):
    """Phase 8 (a): returns each scenario's first replay on the card."""
    from repro_torch.workload import Workload, check_slos, replay_trace

    runs = {}
    for name in ZOO:
        wl = Workload(name)
        trace = wl.trace()
        t0 = time.perf_counter()
        first = replay_trace(trace, server_kw=wl.server_kw(), verify=True,
                             device=dev)
        _reset_launches()  # the second replay's: no verification in them
        second = replay_trace(trace, server_kw=wl.server_kw(), device=dev)
        n = _launches()
        wall = time.perf_counter() - t0
        if first.fingerprint() != second.fingerprint():
            raise AssertionError(f"zoo {name}: two replays on the card give "
                                 "two fingerprints")
        if n["kmeans_lloyd"] <= 0:
            raise AssertionError(f"zoo {name}: no Lloyd kernel launch")
        if first.latency["count"] <= 0:
            raise AssertionError(f"zoo {name}: no symbol latency recorded")
        measured = first.measured()
        violations = check_slos(measured, wl.slos())
        c, q = first.counters, first.queue
        print(f"zoo {name}: {len(trace.sessions)} sessions, "
              f"{int(c['steps'])} rounds, fingerprints equal over 2 "
              f"replays, {first.verified} sessions verified; "
              f"{_lat(first)}; queue depth max {q['max_depth']:.0f} mean "
              f"{q['mean_depth']:.3f}; evict rate {first.evict_rate:.4f}; "
              f"Lloyd launches {n['kmeans_lloyd']}, host syncs "
              f"{n['host_syncs']} ({n['host_syncs'] / c['steps']:.1f} per "
              f"round) per replay; {second.wall_seconds:.2f} s per replay "
              f"({wall:.2f} s both, with the verification); SLOs "
              + ("met" if not violations else
                 "VIOLATED (" + "; ".join(map(str, violations)) + ")"),
              flush=True)
        runs[name] = first

    wl = Workload("mixed_fleet")
    syncs, prints = [], []
    for obs in (None, False):
        _reset_launches()
        res = replay_trace(wl.trace(), server_kw=wl.server_kw(), obs=obs,
                           device=dev)
        syncs.append(_launches()["host_syncs"])
        prints.append(res.fingerprint())
    if prints[0] != prints[1] or syncs[0] != syncs[1]:
        raise AssertionError(f"zoo mixed_fleet, obs on vs off: host syncs "
                             f"{syncs}, fingerprints equal: "
                             f"{prints[0] == prints[1]}")
    print(f"zoo mixed_fleet, obs on vs off: the same fingerprint and "
          f"{syncs[0]} host syncs in both", flush=True)
    return runs


def zoo_against_cpu(runs, cpu):
    """Phase 8 (a): each scenario on the card against the CPU port's
    replay: counters equal, sender/wire outputs bitwise, 99% of symbols."""
    agree = total = 0
    for name, res in runs.items():
        ref = cpu[name]
        if res.counters != ref["counters"]:
            diff = {k: (v, ref["counters"].get(k))
                    for k, v in res.counters.items()
                    if v != ref["counters"].get(k)}
            raise AssertionError(f"zoo {name}, cuda vs cpu: counters {diff}")
        mine = _closed_outputs(res)
        if set(mine) != set(ref["sessions"]):
            raise AssertionError(f"zoo {name}, cuda vs cpu: sessions differ")
        for sid, a in mine.items():
            b = ref["sessions"][sid]
            for key in ("n_pieces", "t_seen"):
                if a[key] != b[key]:
                    raise AssertionError(f"zoo {name} {sid}: {key} differs")
            for key in ("pieces_len", "pieces_inc"):
                if not (a[key] == b[key]).all():
                    raise AssertionError(f"zoo {name} {sid}: {key} differs")
            agree += int((a["labels"] == b["labels"]).sum())
            total += a["n_pieces"]
    if agree < 0.99 * total:
        raise AssertionError(f"zoo, cuda vs cpu: symbols {agree}/{total}")
    print(f"zoo, cuda vs cpu port: every counter equal in all "
          f"{len(runs)} scenarios, pieces bitwise, symbols {agree}/{total} "
          f"agree", flush=True)


def _check_against_encode(torch, res, trace, cfg, dev, sids):
    """Sessions of a replay against ``symed_encode`` on the card of the
    points each ingested: ``n_pieces`` and the pieces bitwise, at least 99%
    of symbols.  Returns (agreeing symbols, total)."""
    from repro_torch.core import prng
    from repro_torch.core.symed import symed_encode
    from repro_torch.data.synthetic import make_fleet
    from repro_torch.launch.transport import session_seed

    data = make_fleet(trace.n_streams, trace.length, seed=trace.seed)
    got = _closed_outputs(res)
    agree = total = 0
    for sid in sids:
        a = got[sid]
        ts = data[trace.sessions[sid]["stream"], : a["t_seen"]]
        ref = symed_encode(torch.from_numpy(ts), cfg,
                           prng.key(session_seed(sid, trace.seed)),
                           reconstruct=False, device=dev)
        n = int(ref["n_pieces"])
        if n != a["n_pieces"]:
            raise AssertionError(f"{sid}: n_pieces {a['n_pieces']} against "
                                 f"symed_encode's {n}")
        for key in ("pieces_len", "pieces_inc"):
            if not (ref[key][:n].cpu().numpy() == a[key]).all():
                raise AssertionError(f"{sid}: {key} differs from "
                                     "symed_encode's")
        ok = int((ref["symbols_online"][:n].cpu().numpy()
                  == a["labels"]).sum())
        if ok < 0.99 * n:
            raise AssertionError(f"{sid}: symbols {ok}/{n}")
        agree += ok
        total += n
    return agree, total


def scale_phase(torch, dev):
    """Phase 8 (b): flash_crowd at the paper's fleet."""
    from repro_torch.launch.stream import StreamServer
    from repro_torch.obs import Observability
    from repro_torch.workload import Workload, replay_trace

    cfg = _paper_cfg()
    wl = Workload("flash_crowd", **SCALE)
    trace = wl.trace()
    obs = Observability(trace_capacity=65536)
    _reset_launches()
    server = StreamServer(cfg, window_cap=trace.window, device=dev, obs=obs,
                          **SCALE_SERVER)
    res = replay_trace(trace, cfg=cfg, server=server)
    torch.cuda.synchronize()
    n = _launches()
    snap = obs.snapshot()
    retraces = snap["counters"]["symed_table_retraces_total"]
    pretrace = [ev for ev in obs.tracer.events()
                if ev[0] == "stream.pretrace"]
    c = res.counters
    rounds = int(c["steps"])
    if n["kmeans_lloyd"] <= 0 or retraces != 0 or len(pretrace) != 1:
        raise AssertionError(f"at scale: Lloyd launches {n['kmeans_lloyd']}, "
                             f"retraces {retraces}, pretrace spans "
                             f"{len(pretrace)}")
    if c["opened"] != SCALE["sessions"] or c["points_in"] != (
            SCALE["sessions"] * SCALE["length"]):
        raise AssertionError(f"at scale: counters {c}")
    tick = snap["histograms"]["symed_ingest_tick_seconds"]
    spans = {}
    for ev in obs.tracer.events():
        if ev[1] == "X" and ev[0].startswith("stream."):
            spans[ev[0]] = spans.get(ev[0], 0) + ev[3]
    sids = sorted(trace.sessions)[:: SCALE["sessions"] // SCALE_CHECKED]
    t0 = time.perf_counter()
    agree, total = _check_against_encode(torch, res, trace, cfg, dev, sids)
    print(f"at scale: flash_crowd, {SCALE['sessions']} sessions x "
          f"{SCALE['length']} points in {SCALE['window']}-point windows, "
          f"the paper's config, table {SCALE_SERVER['min_slots']}.."
          f"{SCALE_SERVER['max_sessions']} slots; {rounds} rounds, "
          f"{res.wall_seconds:.2f} s ({1e3 * res.wall_seconds / rounds:.2f} "
          f"ms of wall per round, closes included; round latency mean "
          f"{1e3 * tick['mean']:.2f} ms, p99 {1e3 * tick['p99']:.2f} ms), "
          f"{c['points_in'] / res.wall_seconds:.1f} points/s", flush=True)
    print(f"at scale: {_lat(res)} (the paper: 42 ms per symbol on one "
          f"CPU); Lloyd launches {n['kmeans_lloyd']}, host syncs "
          f"{n['host_syncs']} ({n['host_syncs'] / rounds:.1f} per round), "
          f"DTW, half-step and EWMA launches {n['dtw']}, "
          f"{n['kmeans_assign']}, {n['ewma']}; grows {int(c['grows'])}, "
          f"shrinks {int(c['shrinks'])}, evicted {int(c['evicted'])}; "
          f"symed_table_retraces_total {retraces:.0f}; pretrace warm-up "
          f"{1e-9 * pretrace[0][3]:.3f} s for capacities "
          f"{pretrace[0][4]['capacities']}; queue depth max "
          f"{res.queue['max_depth']:.0f}", flush=True)
    print("at scale: host time per round by span: "
          + ", ".join(f"{name} {1e-6 * ns / rounds:.2f} ms"
                      for name, ns in spans.items()
                      if name != "stream.pretrace"), flush=True)
    print(f"at scale: {len(sids)} sessions held against symed_encode on the "
          f"card: n_pieces and pieces bitwise, symbols {agree}/{total} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def _prom(text, series):
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"series {series!r} not in /metrics")


def tcp_replay_phase(torch, dev, inproc):
    """Phase 8 (c): ``mixed_fleet`` over loopback TCP with the exporter,
    against (a)'s in-process replay ``inproc``."""
    import urllib.request

    from repro_torch.launch.stream import StreamServer
    from repro_torch.obs import Observability
    from repro_torch.obs.export import ObsHTTPServer
    from repro_torch.workload import Workload, replay_trace
    from repro_torch.workload.replay import LOOSE_COUNTER_KEYS, _default_cfg

    wl = Workload("mixed_fleet")
    trace = wl.trace()
    obs = Observability()
    # the zoo's config: the replay engine's default
    server = StreamServer(_default_cfg(), window_cap=trace.window, device=dev,
                          obs=obs, **wl.server_kw())
    exporter = ObsHTTPServer(obs, port=0)
    try:
        _reset_launches()
        res = replay_trace(trace, server=server, transport=True, verify=True)
        n = _launches()
        got = {}
        for path in ("/metrics", "/metrics.json", "/trace"):
            with urllib.request.urlopen(exporter.url + path,
                                        timeout=30) as resp:
                got[path] = resp.read().decode()
    finally:
        exporter.close()
    rep = server.report(res.wall_seconds)
    text = got["/metrics"]
    n_sessions = len(trace.sessions)
    checks = {
        "symed_points_in_total": rep["points_in"],
        "symed_symbols_out_total": rep["symbols_out"],
        "symed_frames_out_total": rep["frames_out"],
        "symed_sessions_opened_total": n_sessions,
        "symed_sessions_closed_total": n_sessions,
        'transport_frames_in_total{type="open"}': n_sessions,
        'transport_frames_in_total{type="close"}': n_sessions,
        "transport_sessions_closed_total": n_sessions,
    }
    for series, want in checks.items():
        if _prom(text, series) != want:
            raise AssertionError(f"/metrics {series} = {_prom(text, series)}"
                                 f", report/transport: {want}")
    for series in ('transport_frames_in_total{type="data"}',
                   "transport_rx_bytes_total", "transport_tx_bytes_total",
                   "symed_symbol_latency_seconds_count"):
        if not _prom(text, series) > 0:
            raise AssertionError(f"/metrics {series} is 0")
    snap = json.loads(got["/metrics.json"])
    if snap["counters"]["symed_points_in_total"] != rep["points_in"]:
        raise AssertionError("/metrics.json disagrees with report()")
    names = {ev["name"] for ev in json.loads(got["/trace"])["traceEvents"]}
    if not (any(x.startswith("stream.") for x in names)
            and any(x.startswith("transport.") for x in names)):
        raise AssertionError(f"/trace names: {sorted(names)}")
    for key in LOOSE_COUNTER_KEYS:
        if res.counters[key] != inproc.counters[key]:
            raise AssertionError(f"tcp vs in-process: {key} "
                                 f"{res.counters[key]} != "
                                 f"{inproc.counters[key]}")
    if res.delta_sha256 != inproc.delta_sha256:
        raise AssertionError("tcp vs in-process: the delta hash differs")
    if n["kmeans_lloyd"] <= 0:
        raise AssertionError("tcp replay: no Lloyd kernel launch")
    print(f"tcp replay: mixed_fleet, {n_sessions} sessions over loopback "
          f"TCP, {res.verified} verified; /metrics agrees with report() and "
          f"the transport's counts ({len(text.splitlines())} lines), "
          f"/trace {len(names)} span names (stream.* and transport.*); "
          f"the delta hash and {', '.join(LOOSE_COUNTER_KEYS)} equal the "
          f"in-process replay's; {_lat(res)}; decode p99 "
          f"{1e3 * snap['histograms']['transport_decode_seconds']['p99']:.3f}"
          f" ms, route p99 "
          f"{1e3 * snap['histograms']['transport_route_seconds']['p99']:.3f}"
          f" ms; Lloyd launches {n['kmeans_lloyd']}; wall "
          f"{res.wall_seconds:.2f} s", flush=True)


def cli_phase(torch, dev):
    """Phase 8 (d): the stream CLI on the card, through the DTW kernel.
    ``--max-slots 8``: bursty's 6 sessions are all open at once, which the
    CLI's default 4-slot table refuses without ``--evict`` (the
    reference's CLI too)."""
    import contextlib
    import io
    import tempfile

    from repro_torch.launch.stream import main as stream_main

    with tempfile.TemporaryDirectory() as tmp:
        trace_out = os.path.join(tmp, "stream_trace.json")
        out = io.StringIO()
        _reset_launches()
        with contextlib.redirect_stdout(out):
            rep = stream_main(["--workload", "bursty", "--verify",
                               "--dtw-every", "2", "--max-slots", "8",
                               "--trace-out", trace_out, "--device", dev])
        n = _launches()
        with open(trace_out) as f:
            doc = json.load(f)
    text = out.getvalue()
    print("\n".join("cli | " + line for line in text.splitlines()),
          flush=True)
    if not any(line.startswith("obs_summary ") for line in text.splitlines()):
        raise AssertionError("the stream CLI printed no obs_summary")
    if "delta equivalence       : OK" not in text:
        raise AssertionError("the stream CLI did not verify")
    if n["dtw"] <= 0 or n["kmeans_lloyd"] <= 0:
        raise AssertionError(f"the stream CLI's launches: {n}")
    names = {ev["name"] for ev in doc["traceEvents"]}
    if "stream.dtw_monitor" not in names:
        raise AssertionError(f"trace names: {sorted(names)}")
    print(f"stream CLI on the card: {int(rep['opened'])} sessions, DTW "
          f"kernel launches {n['dtw']}, Lloyd launches {n['kmeans_lloyd']}, "
          f"host syncs {n['host_syncs']}; the trace file loads "
          f"({len(doc['traceEvents'])} events)", flush=True)

def _fleet_counts(torch, label, t0):
    """Read the launch counts of one fleet part and print them."""
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = _launches()
    print(f"{label}: {wall:.2f} s, host syncs {n['host_syncs']}, Lloyd "
          f"launches {n['kmeans_lloyd']}, DTW launches {n['dtw']}, "
          f"half-step {n['kmeans_assign']}, EWMA {n['ewma']}", flush=True)
    if n["kmeans_lloyd"] <= 0:
        raise AssertionError(f"{label}: no Lloyd kernel launch")
    return n, wall


def _symbol_agreement(a, b, what):
    """Pieces bitwise (``n_pieces``, lengths, increments); returns the
    symbols that agree over the valid pieces, and their count."""
    import numpy as np

    a = {k: v.cpu().numpy() for k, v in a.items()}
    b = {k: v.cpu().numpy() for k, v in b.items()}
    for key in ("n_pieces", "pieces_len", "pieces_inc"):
        if not np.array_equal(a[key], b[key]):
            raise AssertionError(f"{what}: {key} differs")
    valid = np.arange(a["symbols"].shape[1])[None, :] < a["n_pieces"][:, None]
    agree = int(((a["symbols"] == b["symbols"]) & valid).sum())
    return agree, int(valid.sum())


def _same_labels_same_centers(torch, out, ref, what):
    """Streams whose final labels agree over their pieces: ``k`` and the
    centers bitwise (the raw centers are means over the labels, in plain
    PyTorch either way), ``re_symbols`` within 1e-5 relative.  Returns the
    number of such streams and the largest relative ``re_symbols`` gap."""
    o = {k: out[k].cpu() for k in ("symbols", "n_pieces", "k", "centers",
                                   "re_symbols")}
    r = {k: ref[k].cpu() for k in o}
    valid = (torch.arange(o["symbols"].shape[1])[None, :]
             < o["n_pieces"][:, None])
    same = ((o["symbols"] == r["symbols"]) | ~valid).all(1)
    if not bool(same.any()):
        raise AssertionError(f"{what}: no stream's labels agree")
    if not (torch.equal(o["k"][same], r["k"][same])
            and torch.equal(o["centers"][same], r["centers"][same])):
        raise AssertionError(f"{what}: k or centers differ where the labels "
                             "agree")
    gap = ((o["re_symbols"] - r["re_symbols"]).abs()
           / r["re_symbols"].abs().clamp_min(1e-30))[same]
    rel = float(gap.max())
    if rel > 1e-5:
        raise AssertionError(f"{what}: re_symbols {rel:.3e} relative where "
                             "the labels agree")
    return int(same.sum()), rel


def fleet_phase(torch, dev, points=FLEET_POINTS):
    """Phase 9 (a)-(b): ``run_fleet`` on the paper's fleet, whole-stream
    with ``reconstruct=True`` on one shard against ``symed_batch`` on the
    card, then streaming over a (2, 2) and a (4,) mesh on one card against
    a one-shard streaming run."""
    from repro_torch.core import prng
    from repro_torch.core.receiver import delta_frame_bytes
    from repro_torch.core.symed import symed_batch
    from repro_torch.data.synthetic import make_fleet
    from repro_torch.launch.fleet import fleet_data_mesh, run_fleet
    from repro_torch.launch.mesh import make_pod_data_mesh

    cfg = _paper_cfg()
    data = make_fleet(SESSIONS, points, seed=0)
    key = prng.key(0)
    one = fleet_data_mesh(1, device=dev)

    _reset_launches()
    t0 = time.perf_counter()
    out, tele = run_fleet(data, cfg, key, one, reconstruct=True)
    n, wall = _fleet_counts(torch, f"fleet (a): whole-stream, reconstruct, "
                            f"{SESSIONS} x {points}, one shard", t0)
    if n["dtw"] != 2:
        raise AssertionError(f"fleet (a): {n['dtw']} DTW launches, not 2")
    t0 = time.perf_counter()
    ref = symed_batch(data, cfg, key, reconstruct=True, device=dev)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    agree, total = _symbol_agreement(out, ref, "fleet (a) vs symed_batch")
    n_pieces = ref["n_pieces"]
    want = {"streams": float(SESSIONS),
            "points": float(SESSIONS * points),
            "pieces": float(n_pieces.float().sum()),
            "wire_bytes": float(ref["wire_bytes"].sum()),
            "raw_bytes": float(4 * SESSIONS * points),
            "wire_out_bytes": float(delta_frame_bytes(n_pieces).sum())}
    got = {k: float(v) for k, v in tele.items()}
    if got != want:
        raise AssertionError(f"fleet (a) telemetry {got} != symed_batch's "
                             f"{want}")
    rel = float(((out["re_pieces"] - ref["re_pieces"]).abs()
                 / ref["re_pieces"].abs().clamp_min(1e-30)).max())
    if agree < 0.99 * total or rel > 1e-5:
        raise AssertionError(f"fleet (a) vs symed_batch: symbols "
                             f"{agree}/{total}, re_pieces {rel:.3e} relative")
    if not bool(torch.isfinite(out["re_symbols"]).all()):
        raise AssertionError("fleet (a): re_symbols not finite")
    same, rel_sym = _same_labels_same_centers(torch, out, ref, "fleet (a)")
    print(f"fleet (a) vs symed_batch on the card (plain k-means, {t_batch:.2f}"
          f" s): pieces and telemetry bitwise ({int(got['pieces'])} pieces, "
          f"{int(got['wire_bytes'])} wire bytes of {int(got['raw_bytes'])}), "
          f"symbols {agree}/{total}, re_pieces within {rel:.3e} relative "
          f"(mean {float(out['re_pieces'].mean()):.4f}, re_symbols mean "
          f"{float(out['re_symbols'].mean()):.4f}); the {same} streams "
          f"whose labels agree: k and centers bitwise, re_symbols within "
          f"{rel_sym:.3e} relative; {SESSIONS * points / wall:.1f} points/s",
          flush=True)

    stream_kw = dict(chunk_len=FLEET_CHUNK, digitize_every_k=FLEET_EVERY)
    _reset_launches()
    t0 = time.perf_counter()
    base, base_tele = run_fleet(data, cfg, key, one, **stream_kw)
    _fleet_counts(torch, f"fleet (b): streaming({FLEET_CHUNK}, digitize "
                  f"every {FLEET_EVERY}), one shard", t0)
    base_tele = {k: float(v) for k, v in base_tele.items()}
    for name, mesh, axis in (
            ("(pod, data) = (2, 2)", make_pod_data_mesh(2, 2, device=dev),
             ("pod", "data")),
            ("(data,) = (4,)", fleet_data_mesh(4, device=dev), "data")):
        _reset_launches()
        t0 = time.perf_counter()
        res, tele = run_fleet(data, cfg, key, mesh, axis=axis, **stream_kw)
        _fleet_counts(torch, f"fleet (b): streaming over {name}, "
                      f"{len(set(mesh.devices.flat))} card", t0)
        tele = {k: float(v) for k, v in tele.items()}
        if tele != base_tele:
            raise AssertionError(f"fleet (b) {name}: telemetry {tele} != "
                                 f"one shard's {base_tele}")
        agree, total = _symbol_agreement(res, base, f"fleet (b) {name}")
        if agree < 0.99 * total:
            raise AssertionError(f"fleet (b) {name}: symbols {agree}/{total}")
        print(f"fleet (b) {name} vs one shard: telemetry equal "
              f"({int(tele['pieces'])} pieces, {int(tele['wire_out_bytes'])} "
              f"wire-out bytes), pieces bitwise, symbols {agree}/{total}",
              flush=True)


def _cli_run(torch, devices, dev):
    """The stream CLI on flash_crowd with ``--devices``; returns its
    ``stream_summary`` line, its report and its launch counts."""
    import contextlib
    import io

    from repro_torch.launch.stream import main as stream_main

    out = io.StringIO()
    _reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rep = stream_main(["--devices", str(devices), "--workload",
                           "flash_crowd", "--max-slots", "16", "--min-slots",
                           "4", "--autoscale", "--verify", "--pretrace",
                           "--device", dev])
    n, wall = _fleet_counts(torch, f"sharded CLI (c): --devices {devices}",
                            t0)
    text = out.getvalue()
    print("\n".join(f"cli --devices {devices} | " + line
                    for line in text.splitlines()), flush=True)
    if "delta equivalence       : OK" not in text:
        raise AssertionError(f"--devices {devices}: the CLI did not verify")
    summary = [l for l in text.splitlines() if l.startswith("stream_summary")]
    return summary, rep


def sharded_cli_phase(torch, dev):
    """Phase 9 (c): the stream CLI with a 4-block table against one block."""
    four, rep4 = _cli_run(torch, 4, dev)
    one, rep1 = _cli_run(torch, 1, dev)
    keys = ("points_in", "symbols_out", "frames_out", "bytes_out", "steps",
            "opened", "closed", "evicted", "grows", "shrinks")
    if four != one or rep4["fingerprint"] != rep1["fingerprint"] or any(
            rep4[k] != rep1[k] for k in keys):
        raise AssertionError(f"--devices 4 vs 1: {four} {rep4} vs {one} "
                             f"{rep1}")
    print(f"sharded CLI (c): --devices 4 and 1 give one stream_summary and "
          f"one fingerprint ({rep4['fingerprint'][:16]}); "
          f"{int(rep4['opened'])} sessions, {int(rep4['grows'])} grows, "
          f"{int(rep4['shrinks'])} shrinks", flush=True)


def sharded_table_phase(torch, dev):
    """Phase 9 (d): 8 of phase 6's sessions served by a 4-block
    ``StreamServer`` on one card, frame by frame against one block."""
    import numpy as np

    from repro_torch.core import prng
    from repro_torch.data.synthetic import make_fleet
    from repro_torch.launch.fleet import fleet_data_mesh
    from repro_torch.launch.stream import StreamServer

    cfg = _paper_cfg()
    data = make_fleet(SESSIONS, POINTS, seed=0)[list(CHECK_ROWS),
                                                 :SHARD_POINTS]
    sids = [f"s{r}" for r in CHECK_ROWS]
    kw = dict(max_sessions=len(sids), window_cap=WINDOW, digitize_every_k=1,
              dtw_every=SHARD_DTW_EVERY, device=dev)
    servers = {}
    for name, mesh in (("one block", None),
                       (f"{SHARD_BLOCKS} blocks",
                        fleet_data_mesh(SHARD_BLOCKS, device=dev))):
        server = StreamServer(cfg, mesh=mesh, **kw)
        base = prng.key(0)
        for r, sid in zip(CHECK_ROWS, sids):
            server.open(sid, key=prng.fold_in(base, r + 1))
        servers[name] = server
    flat, sharded = servers.values()
    agree = total = 0
    sharded_wall = 0.0
    _reset_launches()
    counts = _launches()
    for w in range(0, SHARD_POINTS, WINDOW):
        batch = {sid: data[i, w: w + WINDOW] for i, sid in enumerate(sids)}
        a = flat.ingest_many(batch)
        n_before = _launches()
        t0 = time.perf_counter()
        b = sharded.ingest_many(batch)
        torch.cuda.synchronize()
        sharded_wall += time.perf_counter() - t0
        n_after = _launches()
        counts = {k: counts[k] + n_after[k] - n_before[k] for k in counts}
        for sid in sids:
            if a[sid]["n_new"] != b[sid]["n_new"] or not np.array_equal(
                    a[sid]["endpoints"], b[sid]["endpoints"]):
                raise AssertionError(f"sharded (d) window {w} {sid}: n_new "
                                     "or endpoints differ")
            agree += int((a[sid]["labels"] == b[sid]["labels"]).sum())
            total += a[sid]["n_new"]
    closes = 0
    for sid in sids:
        if flat.session_stats(sid)["dtw"] != sharded.session_stats(sid)["dtw"]:
            raise AssertionError(f"sharded (d) {sid}: DTW readings differ")
        ca = flat.close(sid)
        n_before = _launches()["kmeans_lloyd"]
        cb = sharded.close(sid)
        closes += _launches()["kmeans_lloyd"] - n_before
        if ca["n_pieces"] != cb["n_pieces"] or not np.array_equal(
                ca["out"]["pieces_len"], cb["out"]["pieces_len"]):
            raise AssertionError(f"sharded (d) {sid}: pieces differ")
        if ca["delta"]["n_new"] != cb["delta"]["n_new"]:
            raise AssertionError(f"sharded (d) {sid}: closing n_new differs")
        agree += int((ca["delta"]["labels"] == cb["delta"]["labels"]).sum())
        total += ca["delta"]["n_new"]
    if closes <= 0:
        raise AssertionError("sharded (d): the closes launched no Lloyd "
                             "kernel")
    if agree < 0.99 * total:
        raise AssertionError(f"sharded (d): symbols {agree}/{total}")
    if counts["kmeans_lloyd"] <= 0 or counts["dtw"] <= 0:
        raise AssertionError(f"sharded (d): launches {counts}")
    print(f"sharded table (d): {len(sids)} sessions x {SHARD_POINTS} points "
          f"in {SHARD_BLOCKS} blocks on "
          f"{len(set(map(str, sharded.block_devices)))} card, "
          f"{sharded.totals['steps']} rounds in {sharded_wall:.2f} s; host "
          f"syncs {counts['host_syncs']}, Lloyd launches "
          f"{counts['kmeans_lloyd']} (and {closes} in the 8 closes), DTW "
          f"launches {counts['dtw']}; against one block frame by frame: "
          f"n_new exact, endpoints and pieces bitwise, DTW readings equal, "
          f"symbols {agree}/{total} (the closing frames' too)", flush=True)


def _abba_runs(torch, dev):
    """Phase 10 (a)'s streams through ``abba_encode`` on ``dev``, each tol's
    20 reconstructions scored in one ``ops.dtw`` call (the DTW kernel on
    the card).  Returns, per tol, every stream's fields and its score."""
    import numpy as np

    from repro_torch.core.abba import abba_encode
    from repro_torch.core.reconstruct import reconstruct_from_symbols
    from repro_torch.data.synthetic import FAMILIES, make_dataset
    from repro_torch.kernels import ops

    out = {}
    for tol in ABBA_TOLS:
        fields, raws, recs = [], [], []
        for family in FAMILIES:
            for row in make_dataset(family, ABBA_SERIES, ABBA_POINTS,
                                    seed=ABBA_SEED):
                res = abba_encode(row, tol=tol, device=dev, **ABBA_KW)
                t0 = torch.tensor(np.float32((row[0] - float(res.mean))
                                             / float(res.std)), device=dev)
                rec = reconstruct_from_symbols(res.labels, res.centers,
                                               res.n_pieces, t0, len(row))
                recs.append(rec * res.std + res.mean)
                raws.append(torch.from_numpy(row).to(dev))
                fields.append({k: v.cpu().numpy()
                               for k, v in res._asdict().items()})
        scores = ops.dtw(torch.stack(raws), torch.stack(recs))
        out[tol] = {"fields": fields, "dtw": scores.cpu().numpy()}
    return out


def _abba_reference():
    """The CPU port's side of phase 10 (a)."""
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    t0 = time.perf_counter()
    out = {"runs": _abba_runs(torch, "cpu")}
    out["seconds"] = time.perf_counter() - t0
    return out


def _abba_card_worker(conn, dev) -> None:
    """Worker process: phase 10 (a)'s streams on ``dev``, the kernels'
    launches counted from 0 just before them.  Host-bound, so it runs in a
    process of its own beside phase 9; sends ``("ok", {"runs", "seconds",
    "counts"})`` or the failure."""
    try:
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _reset_launches()
        t0 = time.perf_counter()
        runs = _abba_runs(torch, dev)
        if dev != "cpu":
            torch.cuda.synchronize()
        conn.send(("ok", {"runs": runs, "seconds": time.perf_counter() - t0,
                          "counts": _launches()}))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


class AbbaCard:
    """Phase 10 (a)'s side on the card in a worker process: the smoke
    starts it after phase 8, when the CPU port's worker is about done, and
    reads it in phase 10, so it runs beside phase 6's checks against the
    CPU port and phase 9.  ``stop`` ends it if it is still going."""

    def __init__(self, dev):
        ctx = multiprocessing.get_context("spawn")
        self._conn, send = ctx.Pipe(duplex=False)
        self._proc = ctx.Process(target=_abba_card_worker, args=(send, dev),
                                 daemon=True)
        self._proc.start()
        send.close()

    def result(self):
        t0 = time.perf_counter()
        status, got = self._conn.recv()
        if status != "ok":
            raise RuntimeError(f"phase 10 (a)'s card worker failed:\n{got}")
        got["waited"] = time.perf_counter() - t0
        return got

    def stop(self):
        if self._proc.is_alive():
            self._proc.terminate()
        self._proc.join(timeout=60)


def _fleet_card_worker(conn, dev) -> None:
    """Worker process: phase 9 (a)-(b) on ``dev``, its printed lines kept
    and sent back with its seconds (``("ok", {"text", "seconds"})``), or
    the failure.  Host-bound, so it runs in a process of its own beside
    phase 8."""
    try:
        import contextlib
        import io

        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            fleet_phase(torch, dev)
        conn.send(("ok", {"text": out.getvalue(),
                          "seconds": time.perf_counter() - t0}))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


class FleetCard:
    """Phase 9 (a)-(b) on the card in a worker process: the smoke starts it
    after phase 7 and reads it where phase 9 begins, so it runs beside
    phase 8.  ``stop`` ends it if it is still going."""

    def __init__(self, dev):
        ctx = multiprocessing.get_context("spawn")
        self._conn, send = ctx.Pipe(duplex=False)
        self._proc = ctx.Process(target=_fleet_card_worker,
                                 args=(send, dev), daemon=True)
        self._proc.start()
        send.close()

    def result(self):
        t0 = time.perf_counter()
        status, got = self._conn.recv()
        if status != "ok":
            raise RuntimeError(f"phase 9 (a)-(b)'s worker failed:\n{got}")
        print(got["text"], end="", flush=True)
        print(f"fleet (a)-(b): {got['seconds']:.1f} s in a worker process; "
              f"waited {time.perf_counter() - t0:.1f} s for it", flush=True)

    def stop(self):
        if self._proc.is_alive():
            self._proc.terminate()
        self._proc.join(timeout=60)


def abba_phase(card, cpu):
    """Phase 10 (a): ABBA on the card (``AbbaCard``'s result) against the
    CPU port.  Returns the kernels' launches, counted from 0 just before
    the card's side."""
    import numpy as np

    runs, wall, counts = card["runs"], card["seconds"], card["counts"]
    for tol in ABBA_TOLS:
        g, c = runs[tol], cpu["runs"][tol]
        agree = total = same_streams = 0
        rel = 0.0
        for i, (fg, fc) in enumerate(zip(g["fields"], c["fields"])):
            for key in ("lengths", "incs", "n_pieces", "mean", "std"):
                if not np.array_equal(fg[key], fc[key]):
                    raise AssertionError(f"abba tol {tol} stream {i}: {key} "
                                         "differs from the CPU port")
            n = int(fc["n_pieces"])
            eq = fg["labels"][:n] == fc["labels"][:n]
            agree += int(eq.sum())
            total += n
            if eq.all():
                same_streams += 1
                a, b = float(g["dtw"][i]), float(c["dtw"][i])
                rel = max(rel, abs(a - b) / max(abs(b), 1e-30))
        if agree < 0.99 * total:
            raise AssertionError(f"abba tol {tol}: labels {agree}/{total}")
        if rel > 1e-4:
            raise AssertionError(f"abba tol {tol}: DTW differs by {rel:.3e} "
                                 "relative where labels agree")
        ks = [int(f["k"]) for f in g["fields"]]
        print(f"abba tol {tol}: {len(ks)} streams, lengths/incs/n_pieces/"
              f"mean/std bitwise, labels {agree}/{total}, k {min(ks)}..."
              f"{max(ks)}; DTW of the {same_streams} streams whose labels "
              f"agree within {rel:.3e} relative", flush=True)
    if counts["kmeans_lloyd"] <= 0 or counts["dtw"] != len(ABBA_TOLS):
        raise AssertionError(f"abba on the card: launches {counts}")
    print(f"abba on the card: {wall:.2f} s for {3 * len(runs[0.5]['fields'])}"
          f" encodes (a worker process; waited {card['waited']:.1f} s for "
          f"it), Lloyd launches {counts['kmeans_lloyd']}, DTW launches "
          f"{counts['dtw']}, host syncs {counts['host_syncs']}", flush=True)
    return counts


def serve_cli_phase(arch):
    """Phase 10 (b): ``python -m repro_torch.launch.serve --full`` on
    ``arch`` (the CLI's defaults otherwise)."""
    import re

    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--full",
         "--arch", arch],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[serve]")]
    print("\n".join("serve | " + ln for ln in proc.stdout.splitlines()),
          flush=True)
    if proc.returncode != 0 or len(lines) != 3:
        raise AssertionError(f"serve --full --arch {arch}: rc "
                             f"{proc.returncode}, {len(lines)} [serve] "
                             f"lines\n{proc.stderr}")
    m = re.search(r"prefill ([\d.]+)s, decode ([\d.]+)ms/tok, ([\d.]+) tok/s",
                  lines[1])
    if not lines[0].startswith(f"[serve] {arch}: generated "
                               f"({SERVE_BATCH}, {SERVE_GEN})") or m is None:
        raise AssertionError(f"serve --full printed {lines}")
    print(f"serve CLI --full ({arch}, bf16, batch {SERVE_BATCH}, prompt "
          f"{SERVE_PROMPT}, gen {SERVE_GEN}): prefill {m.group(1)} s, decode "
          f"{m.group(2)} ms/tok, {m.group(3)} tok/s; the process took "
          f"{wall:.2f} s", flush=True)


def _frontend(torch, cfg, batch, dev, seed):
    """Frontend inputs from ``seed`` (0.1-scaled normals), as the models'
    tests make them; the serve CLI feeds zeros of the same shapes."""
    from repro_torch.launch.serve import frontend_inputs

    kw, prefix_len = frontend_inputs(cfg, batch, dev)
    gen = torch.Generator(dev).manual_seed(seed)
    return ({k: 0.1 * torch.randn(v.shape, generator=gen, device=dev)
             for k, v in kw.items()}, prefix_len)


def _lm_greedy(torch, params, cfg, prompts, steps, kw, prefix_len):
    """Prefill then ``steps`` greedy decode steps: the logits of every step
    (on the CPU) and the tokens fed, with the device seconds of each."""
    from repro_torch.models import decode_step, prefill

    with torch.inference_mode():
        if prompts.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = prefill(params, cfg, prompts,
                                max_len=prompts.shape[1] + prefix_len + steps,
                                **kw)
        seq = [logits.cpu()]
        t_prefill = time.perf_counter() - t0
        toks = []
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            toks.append(tok)
            logits, state = decode_step(params, cfg, state, tok)
            seq.append(logits)
        seq[1:] = [x.cpu() for x in seq[1:]]
        t_decode = time.perf_counter() - t0
    return seq, torch.cat(toks, 1).cpu(), t_prefill, t_decode / max(steps, 1)


def _cut(cfg):
    """Full width; the archs of FULL_DEPTH keep their depth, jamba keeps
    JAMBA_CUT of its superblock once, the others one superblock plus the
    tail (and one encoder block).  Returns (config, what was cut)."""
    import dataclasses

    if cfg.name in FULL_DEPTH:
        return cfg, "full depth"
    if cfg.name.startswith("jamba"):
        pattern = cfg.block_pattern[JAMBA_CUT]
        kinds = ", ".join(s.kind + ("+MoE" if s.moe else "+dense FFN")
                          for s in pattern)
        return (dataclasses.replace(cfg, block_pattern=pattern, n_blocks=1),
                f"layers {JAMBA_CUT.start}-{JAMBA_CUT.stop - 1} of its "
                f"superblock of {len(cfg.block_pattern)} ({kinds})")
    return (dataclasses.replace(cfg, n_blocks=1,
                                enc_blocks=min(cfg.enc_blocks, 1)),
            "one superblock plus the tail")


def _bf16_reduction_check(torch, dev):
    """How often a bf16 product on the card differs from the same product
    summed in f32 (TF32 off) and rounded once, with cuBLAS's reduced-
    precision bf16 reductions allowed and not, at the serve arch's
    decode and prefill GEMM shapes.  Both sides accumulate in f32, in
    their own orders: the share is what order alone moves."""
    from repro_torch.configs import get_config

    cfg = get_config(SERVE_ARCH)
    gen = torch.Generator(dev).manual_seed(3)
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    shapes = [(m, cfg.d_model, n) for m in (SERVE_BATCH,
                                            SERVE_BATCH * SERVE_PROMPT)
              for n in (cfg.n_heads * cfg.head_dim, cfg.vocab)]
    parts = []
    try:
        for allow in (True, False):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
                = allow
            for m, k, n in shapes:
                x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
                w = (0.02 * torch.randn(k, n, generator=gen, device=dev)
                     ).bfloat16()
                want = (x.float() @ w.float()).bfloat16()
                share = float(((x @ w) != want).float().mean())
                parts.append(f"{'allowed' if allow else 'off'} {m}x{k}x{n} "
                             f"{share:.3e}")
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag
    print("bf16 products differing from f32-summed-then-rounded (reduced-"
          "precision reductions " + "; ".join(parts) + ")", flush=True)


def _moe_groups_check(torch, dev):
    """One olmoe-1b-7b MoE layer at full width on MOE_GROUPS_SHAPE tokens
    in bf16: 8 groups of 4096, one after the other.  The first group's
    output is the layer's on that group alone (at most 1% of it differs:
    the router's f32 product may sum in another order at another row
    count); the memory the call adds stays under MOE_GROUPS_BYTES."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_apply, moe_init

    cfg = get_config(SERVE_ARCH)
    params = moe_init(torch.Generator(dev).manual_seed(4), cfg, dev)
    x = (torch.randn(MOE_GROUPS_SHAPE + (cfg.d_model,),
                     generator=torch.Generator(dev).manual_seed(5),
                     device=dev) * 0.1).to(torch.bfloat16)
    with torch.inference_mode():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        y, aux = moe_apply(params, cfg, x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        added = torch.cuda.max_memory_allocated() - base
        alone, _ = moe_apply(params, cfg, x[:1, :4096])
    if not (torch.isfinite(y).all() and torch.isfinite(aux)):
        raise AssertionError("MoE over 8 groups: not finite")
    share = float((y[:1, :4096] != alone).float().mean())
    if share > 0.01:
        raise AssertionError(f"MoE over 8 groups: {share:.4f} of the first "
                             "group differs from the layer on it alone")
    if added > MOE_GROUPS_BYTES:
        raise AssertionError(f"MoE over 8 groups added {added} bytes > "
                             f"{MOE_GROUPS_BYTES}")
    print(f"{SERVE_ARCH} MoE layer, {MOE_GROUPS_SHAPE[0]} x "
          f"{MOE_GROUPS_SHAPE[1]} tokens (8 groups of 4096) in bf16: "
          f"{wall:.3f} s, the call added {added} bytes "
          f"({added / 2**30:.2f} GiB) at its peak; {share:.5f} of the first "
          f"group differs from the layer on it alone", flush=True)


def full_width_phase(torch, dev):
    """Phase 10 (c): every arch at full width in bf16 on the card: two
    runs from one seed bitwise equal, tokens in range, logits finite, the
    parameter count the reference's, and the teacher-forcing contract
    within TF_BOUND.  Returns the peak memory of each FULL_DEPTH arch."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import count_params, decode_step, init_params
    from repro_torch.models import prefill

    _bf16_reduction_check(torch, dev)
    peak = {}
    for arch in sorted(REF_PARAM_COUNTS):
        full = get_config(arch)
        if count_params(full) != REF_PARAM_COUNTS[arch]:
            raise AssertionError(f"{arch}: count_params {count_params(full)}"
                                 f" != the reference's "
                                 f"{REF_PARAM_COUNTS[arch]}")
        cfg, cut = _cut(full)
        t_start = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(dev).manual_seed(1)
        prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH,
                                               SERVE_PROMPT + TF_STEPS),
                                generator=gen, device=dev, dtype=torch.int32)
        kw, prefix_len = _frontend(torch, cfg, SERVE_BATCH, dev, 2)
        runs = []
        for _ in range(2):
            params = init_params(torch.Generator(dev).manual_seed(0), cfg)
            n_alloc = sum(p.numel() for p in params.parameters())
            if n_alloc != count_params(cfg):
                raise AssertionError(f"{arch}: {n_alloc} parameters "
                                     f"allocated, count {count_params(cfg)}")
            runs.append(_lm_greedy(torch, params, cfg,
                                   prompts[:, :SERVE_PROMPT], SERVE_GEN - 1,
                                   kw, prefix_len))
            if len(runs) == 1:
                del params
        mem = torch.cuda.max_memory_allocated()
        (seq_a, tok_a, t_pre, t_dec), (seq_b, tok_b, _, _) = runs
        for a, b in zip(seq_a, seq_b):
            if not (torch.isfinite(a).all() and torch.equal(a, b)):
                raise AssertionError(f"{arch}: logits not finite or not "
                                     "bitwise equal across two runs")
        if not (torch.equal(tok_a, tok_b)
                and bool(((tok_a >= 0) & (tok_a < cfg.vocab)).all())):
            raise AssertionError(f"{arch}: tokens differ or out of range")
        # teacher forcing: prefill(n0) + TF_STEPS decodes vs prefill(n0 + 4)
        tf_cfg = cfg
        if cfg.n_experts:  # no-drop capacity, as tests/test_models.py
            tf_cfg = dataclasses.replace(
                cfg, capacity_factor=float(cfg.n_experts) / cfg.top_k)
        t_len = SERVE_PROMPT + TF_STEPS
        with torch.inference_mode():
            gt, _ = prefill(params, tf_cfg, prompts,
                            max_len=t_len + prefix_len, **kw)
            logits, state = prefill(params, tf_cfg, prompts[:, :SERVE_PROMPT],
                                    max_len=t_len + prefix_len, **kw)
            for i in range(SERVE_PROMPT, t_len):
                logits, state = decode_step(params, tf_cfg, state,
                                            prompts[:, i: i + 1])
        err = float((gt - logits).abs().max())
        scale = max(float(gt.abs().max()), 1.0)
        if not err <= TF_BOUND * scale:
            raise AssertionError(f"{arch}: teacher forcing {err:.4e} > "
                                 f"{TF_BOUND} x {scale:.4f}")
        del params, state
        if arch in FULL_DEPTH:
            peak[arch] = mem
        print(f"{arch}: {cfg.n_layers} layers (of {full.n_layers}; {cut}), "
              f"d_model {cfg.d_model}, {count_params(cfg)} parameters "
              f"(full config {count_params(full)}, the reference's), bf16; "
              f"two runs bitwise equal, tokens in range; teacher forcing "
              f"{err:.4e} = {err / scale:.4e} x scale {scale:.4f}; prefill "
              f"{t_pre:.3f} s, decode {1e3 * t_dec:.2f} ms/tok "
              f"({SERVE_BATCH} x {SERVE_PROMPT} prompt); peak memory "
              f"{mem / 2**30:.2f} GiB; {time.perf_counter() - t_start:.2f} s",
              flush=True)
    _moe_groups_check(torch, dev)
    return peak


def reduced_phase(torch, dev):
    """Phase 10 (d): the reduced configs (f32) and one int8-cache variant
    on the card against the port on the CPU, the same weights: logits
    within 1e-4 x max(max|cpu|, 1), greedy tokens equal."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.models import init_params

    cases = [(a, False) for a in sorted(REF_PARAM_COUNTS)]
    cases.append((KV_QUANT_ARCH, True))
    for arch, quant in cases:
        cfg = dataclasses.replace(get_config(arch).reduced(), kv_quant=quant)
        cpu = init_params(torch.Generator().manual_seed(0), cfg)
        gpu = params_from_numpy(params_to_numpy(cpu), cfg, device=dev)
        prompts = torch.randint(0, cfg.vocab, (2, 40), dtype=torch.int32,
                                generator=torch.Generator().manual_seed(1))
        kw, prefix_len = _frontend(torch, cfg, 2, "cpu", 2)
        want, want_t, _, _ = _lm_greedy(torch, cpu, cfg, prompts, 5, kw,
                                        prefix_len)
        got, got_t, _, _ = _lm_greedy(
            torch, gpu, cfg, prompts.to(dev), 5,
            {k: v.to(dev) for k, v in kw.items()}, prefix_len)
        rel = 0.0
        for a, b in zip(got, want):
            rel = max(rel, float((a - b).abs().max())
                      / max(float(b.abs().max()), 1.0))
        if rel > 1e-4 or not torch.equal(got_t, want_t):
            raise AssertionError(f"{arch} reduced{' kv_quant' if quant else ''}"
                                 f": logits {rel:.3e} x scale, tokens "
                                 f"{'equal' if torch.equal(got_t, want_t) else 'differ'}")
        print(f"{arch} reduced{' (kv_quant)' if quant else ''}, f32, card vs "
              f"CPU port: prefill and 5 decode steps within {rel:.3e} x "
              f"scale, greedy tokens equal", flush=True)


# ---------------------------------------------------------------------------
# Phase 11: training
# ---------------------------------------------------------------------------

class TrainCLI:
    """Phase 11 (a)'s two runs of the train CLI, one after the other in a
    background thread: the smoke starts them before phase 8 and reads them
    in phase 11, so they overlap phases 8-10 (all host-bound; the card has
    room for all).  ``stop`` kills a run still going."""

    def __init__(self):
        import tempfile
        import threading

        self.ckpt = tempfile.mkdtemp(prefix="smoke_train_")
        self.runs, self.saved, self.error = [], [], None
        self._proc, self._stopped = None, False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _one(self, args):
        env = {**os.environ,
               "PYTHONPATH": os.pathsep.join(
                   [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p])}
        t0 = time.perf_counter()
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *args],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        out, err = self._proc.communicate(timeout=600)
        self.runs.append((self._proc.returncode, out, err,
                          time.perf_counter() - t0))

    def _run(self):
        common = ["--steps", str(TRAIN_STEPS), "--ckpt-dir", self.ckpt,
                  "--ckpt-every", str(TRAIN_FAIL), "--log-every", "1"]
        try:
            self._one(common + ["--fail-at-step", str(TRAIN_FAIL)])
            self.saved = sorted(p.name for p in Path(self.ckpt).glob("ckpt_*"))
            if not self._stopped:
                self._one(common)
        except BaseException as e:  # read in result()
            self.error = e

    def result(self):
        self._thread.join()
        if self.error is not None:
            raise self.error
        return self.runs, self.saved

    def stop(self):
        import shutil

        self._stopped = True
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()
        self._thread.join(timeout=60)
        shutil.rmtree(self.ckpt, ignore_errors=True)


def train_cli_phase(cli: TrainCLI):
    """Phase 11 (a): ``python -m repro_torch.launch.train`` at its defaults
    (symlm-100m at full size, f32, batch 8, seq 256, lr 3e-4) for
    ``TRAIN_STEPS`` steps with a checkpoint directory: failed at step
    ``TRAIN_FAIL`` (exit non-zero), then run again, resuming from the
    checkpoint; every loss finite, the last three's mean below the first
    three's by 0.1 (``tests/test_system.py``'s rule)."""
    import math
    import re

    t0 = time.perf_counter()
    runs, saved = cli.result()
    waited = time.perf_counter() - t0
    cli.stop()
    for rc, out, _, _ in runs:
        print("\n".join("train | " + ln for ln in out.splitlines()),
              flush=True)
    (rc1, out1, err1, wall1), (rc2, out2, err2, wall2) = runs
    if rc1 == 0 or f"simulated node failure at step {TRAIN_FAIL}" not in err1:
        raise AssertionError(f"train --fail-at-step {TRAIN_FAIL}: rc {rc1}"
                             f"\n{err1[-2000:]}")
    if rc2 != 0:
        raise AssertionError(f"train resume: rc {rc2}\n{err2[-2000:]}")
    if f"[train] resumed from step {TRAIN_FAIL}" not in out2:
        raise AssertionError(f"the second run did not resume from step "
                             f"{TRAIN_FAIL} (checkpoints {saved})")
    pat = re.compile(r"\[train\] step (\d+): loss=(\S+) grad_norm=(\S+)")
    logged = [(int(m.group(1)), float(m.group(2)), float(m.group(3)))
              for out in (out1, out2) for m in pat.finditer(out)]
    steps = [s for s, _, _ in logged]
    if steps != list(range(TRAIN_STEPS)):
        raise AssertionError(f"logged steps {steps}")
    losses = [l for _, l, _ in logged]
    if not all(math.isfinite(v) for _, l, g in logged for v in (l, g)):
        raise AssertionError(f"non-finite loss or grad norm: {logged}")
    head, tail = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    if not tail < head - 0.1:
        raise AssertionError(f"loss did not fall: first three logged "
                             f"{losses[:3]}, last three {losses[-3:]}")
    timing = [ln for ln in out2.splitlines() if " ms/step after the first" in ln]
    print(f"train CLI (symlm-100m, f32, batch 8, seq 256): failed at step "
          f"{TRAIN_FAIL} as asked (checkpoints {saved}, {wall1:.1f} s), "
          f"resumed from step {TRAIN_FAIL} to {TRAIN_STEPS} ({wall2:.1f} s; "
          f"phase 11 waited {waited:.1f} s for the two); logged losses "
          f"{losses}: mean of the first three {head:.4f}, of the last three "
          f"{tail:.4f}", flush=True)
    print("train CLI timing (resumed run): " + "; ".join(timing), flush=True)


def _trainable_count(params):
    return sum(p.numel() for p in params.parameters())


def _timed_steps(torch, dev, cfg, batch, seq, n):
    """``n`` AdamW steps of ``cfg`` from seed 0 on random tokens: finite
    loss and grad norm, every leaf moved.  Returns (parameters, leaves,
    (loss, grad norm) per step, seconds per step, peak bytes)."""
    import math

    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.steps import (init_train_state, make_train_step,
                                         param_leaves)

    oc = OptConfig(warmup_steps=1, total_steps=10)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(torch.Generator(dev).manual_seed(0), cfg, oc)
    count = _trainable_count(state["params"])
    before = {k: v.clone() for k, v in param_leaves(state["params"]).items()}
    step = make_train_step(cfg, oc)
    gen = torch.Generator(dev).manual_seed(1)
    times, logs = [], []
    for _ in range(n):
        toks = torch.randint(0, cfg.vocab, (batch, seq + 1), device=dev,
                             generator=gen, dtype=torch.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, {"tokens": toks})
        loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
        times.append(time.perf_counter() - t0)
        logs.append((loss, gn))
        if not (math.isfinite(loss) and math.isfinite(gn)):
            raise AssertionError(f"{cfg.name}: loss {loss}, grad norm {gn}")
    after = param_leaves(state["params"])
    still = [k for k, v in before.items() if torch.equal(v, after[k])]
    if still:
        raise AssertionError(f"{cfg.name}: leaves that did not move: {still}")
    return count, len(before), logs, times, torch.cuda.max_memory_allocated()


def train_bf16_phase(torch, dev):
    """Phase 11 (b): xlstm-125m at its published config in bf16, in
    process: ``TRAIN_BF16`` AdamW steps; finite loss and grad norm, every
    leaf moved, the reference's parameter count.  Then the train CLI's
    symlm-100m (f32, batch 8, seq 256) the same way, timed without the
    pipeline beside it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import cli_config

    arch, batch, seq, n = TRAIN_BF16
    for cfg in (get_config(arch), cli_config(None, False)):
        count, leaves, logs, times, peak = _timed_steps(torch, dev, cfg,
                                                        batch, seq, n)
        if count != REF_PARAM_COUNTS.get(cfg.name, cfg.param_count()):
            raise AssertionError(f"{cfg.name}: {count} parameters")
        print(f"{cfg.name} {cfg.dtype} at full width and depth ({count} "
              f"parameters, batch {batch}, seq {seq}): {n} AdamW steps, "
              f"(loss, grad norm) {logs}, every one of {leaves} leaves "
              f"moved; {1e3 * sum(times[1:]) / (n - 1):.1f} ms/step after "
              f"the first (first {1e3 * times[0]:.1f} ms), "
              f"{batch * seq * (n - 1) / sum(times[1:]):.0f} tokens/s, "
              f"torch.cuda.max_memory_allocated {peak} bytes "
              f"({peak / 2**30:.2f} GiB)", flush=True)


def _grads_of(torch, params, cfg, batch):
    """(loss, reference-named gradients) of ``loss_fn`` at ``params``."""
    from repro_torch.models import loss_fn
    from repro_torch.models.params import stack_named

    names, leaves = zip(*params.named_parameters())
    loss, _ = loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), stack_named(zip(names, grads))


def _rel(torch, got, want, floor):
    err = float((got.double().cpu() - want.double()).abs().max())
    return err / max(float(want.abs().max()), floor)


def _check_step(torch, arch, got, want, cpu_grads):
    """The acceptance tolerances, card against CPU: loss and grad norm
    within TRAIN_LOSS_REL relative; every gradient leaf within
    TRAIN_GRAD_REL x max(max|g|, 1e-6); the parameters and moments after
    the step within TRAIN_OPT_REL x max(|cpu|, 1) per element, except
    where |g| is at most 100 x the gradient tolerance (there Adam's m/sqrt(v)
    turns a sign flip of a near-zero gradient into +-lr): such elements
    left out, at most 0.1% of a leaf."""
    from repro_torch.train.steps import param_leaves

    (g_state, g_metrics, g_grads), (w_state, w_metrics) = got, want
    for k in ("loss", "grad_norm"):
        rel = abs(float(g_metrics[k]) - float(w_metrics[k])) / max(
            abs(float(w_metrics[k])), 1e-30)
        if rel > TRAIN_LOSS_REL:
            raise AssertionError(f"{arch}: {k} {rel:.3e} relative")
    worst_g = max(_rel(torch, g_grads[k], g, 1e-6)
                  for k, g in cpu_grads.items())
    if worst_g > TRAIN_GRAD_REL:
        raise AssertionError(f"{arch}: gradients {worst_g:.3e} x scale")
    gp, wp = param_leaves(g_state["params"]), param_leaves(w_state["params"])
    worst_p, left = 0.0, 0.0
    for k, g in cpu_grads.items():
        small = g.abs() <= 100 * TRAIN_GRAD_REL * max(float(g.abs().max()),
                                                      1e-6)
        for got_t, want_t in ((gp[k], wp[k]),
                              (g_state["opt"]["m"][k], w_state["opt"]["m"][k]),
                              (g_state["opt"]["v"][k], w_state["opt"]["v"][k])):
            e = ((got_t.double().cpu() - want_t.double()).abs()
                 / want_t.double().abs().clamp_min(1.0))
            out = e > TRAIN_OPT_REL
            if (out & ~small).any():
                raise AssertionError(
                    f"{arch} {k}: {float(e[~small].max()):.3e} x "
                    "max(|cpu|, 1) where the gradient is not small")
            left = max(left, float(out.float().mean()))
            worst_p = max(worst_p, float(e[~out].max()) if (~out).any()
                          else 0.0)
    if left > 1e-3:
        raise AssertionError(f"{arch}: {left:.3%} of a leaf left out")
    return worst_g, worst_p, left


def train_against_cpu_phase(torch, dev):
    """Phase 11 (c): one ``make_train_step`` step of reduced configs in f32
    on the card against the CPU port, the same state and batch."""
    from repro_torch.configs import get_config
    from repro_torch.convert import (train_state_from_numpy,
                                     train_state_to_numpy)
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.steps import init_train_state, make_train_step

    oc = OptConfig(warmup_steps=2, total_steps=10)
    for arch in TRAIN_REDUCED:
        cfg = get_config(arch).reduced()
        cpu = init_train_state(torch.Generator().manual_seed(0), cfg, oc)
        cpu["step"] = torch.tensor(TRAIN_AT_STEP, dtype=torch.int32)  # lr > 0
        gpu = train_state_from_numpy(train_state_to_numpy(cpu), cfg,
                                     device=dev)
        toks = torch.randint(0, cfg.vocab, (4, 33), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(1))
        batch = {"tokens": toks}
        kw, _ = _frontend(torch, cfg, 4, "cpu", 2)
        batch.update(kw)
        gbatch = {k: v.to(dev) for k, v in batch.items()}
        _, cpu_grads = _grads_of(torch, cpu["params"], cfg, batch)
        _, gpu_grads = _grads_of(torch, gpu["params"], cfg, gbatch)
        step = make_train_step(cfg, oc)
        want = step(cpu, batch)
        got_state, got_metrics = step(gpu, gbatch)
        worst_g, worst_p, left = _check_step(
            torch, arch, (got_state, got_metrics, gpu_grads), want,
            cpu_grads)
        print(f"{arch} reduced, f32, one train step, card vs CPU port: loss "
              f"{float(got_metrics['loss']):.6f} / "
              f"{float(want[1]['loss']):.6f}, gradients within "
              f"{worst_g:.3e} x scale, parameters and moments within "
              f"{worst_p:.3e} x max(|cpu|, 1) where compared ({left:.3%} "
              "of a leaf left out at most)", flush=True)


def train_compressed_phase(torch, dev):
    """Phase 11 (d): the compressed step, two pods on the one card, against
    ``make_train_step`` on the same batch: the pods' int8 mean of the
    gradients within each leaf's quantization step (amax / 127) plus the
    gradient tolerance of the full batch's gradients."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_pod_data_mesh
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.steps import (init_error_fb, init_train_state,
                                         make_compressed_train_step,
                                         make_train_step,
                                         quantized_psum_mean)

    arch = "codeqwen1.5-7b"  # dense: the halves' mean loss is the batch's
    cfg = get_config(arch).reduced()
    oc = OptConfig(warmup_steps=2, total_steps=10)
    state = init_train_state(torch.Generator(dev).manual_seed(0), cfg, oc)
    state["step"] = torch.tensor(TRAIN_AT_STEP, dtype=torch.int32, device=dev)
    toks = torch.randint(0, cfg.vocab, (4, 33), dtype=torch.int32,
                         device=dev, generator=torch.Generator(dev).manual_seed(1))
    _, full = _grads_of(torch, state["params"], cfg, {"tokens": toks})
    pods = [_grads_of(torch, state["params"], cfg, {"tokens": toks[i:i + 2]})[1]
            for i in (0, 2)]
    mean, _ = quantized_psum_mean(pods)
    worst = 0.0
    for k, g in full.items():
        amax = max(float(p[k].abs().max()) for p in pods)
        bound = amax / 127 + TRAIN_GRAD_REL * max(float(g.abs().max()), 1e-6)
        err = float((mean[k] - g).abs().max())
        if err > bound:
            raise AssertionError(f"compressed {k}: {err:.3e} > {bound:.3e}")
        worst = max(worst, err / bound)
    mesh = make_pod_data_mesh(2, 1, device=dev)
    state_c = dict(state, error_fb=init_error_fb(state["params"]))
    new_c, m_c = make_compressed_train_step(cfg, oc, mesh)(
        state_c, {"tokens": toks})
    new_c, m_c2 = make_compressed_train_step(cfg, oc, mesh)(
        new_c, {"tokens": toks})
    _, m_f = make_train_step(cfg, oc)(state, {"tokens": toks})
    rel = abs(float(m_c["loss"]) - float(m_f["loss"])) / float(m_f["loss"])
    if rel > TRAIN_LOSS_REL or len(new_c["error_fb"]) != 2:
        raise AssertionError(f"compressed step: loss {rel:.3e} relative to "
                             f"the full step's, {len(new_c['error_fb'])} "
                             "error-feedback buffers")
    print(f"compressed step, 2 pods on {mesh.devices.flat[0]} ({arch} "
          f"reduced): int8 mean of the gradients within {worst:.3f} of its "
          f"bound at worst; loss {float(m_c['loss']):.6f} against the full "
          f"step's {float(m_f['loss']):.6f}, grad norm "
          f"{float(m_c['grad_norm']):.4f} / {float(m_f['grad_norm']):.4f}, "
          f"second step (error feedback) loss {float(m_c2['loss']):.6f}",
          flush=True)


def train_monitor_phase(torch):
    """Phase 11 (e): ``examples/torch_anomaly_monitor.py`` on the card: the
    injected straggler (host 7, steps 200-220) and hang (host 3, step 350)
    flagged, as the reference example flags them."""
    import contextlib
    import importlib.util
    import io
    import re

    spec = importlib.util.spec_from_file_location(
        "torch_anomaly_monitor", ROOT / "examples" / "torch_anomaly_monitor.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        mod.main(["--device", "cuda"])
    wall = time.perf_counter() - t0
    text = out.getvalue()
    print("\n".join("monitor | " + ln for ln in text.splitlines()), flush=True)
    events = re.findall(r"host(\d+) step\s+(\d+): (\w+)", text)
    straggler = any(h == "07" and k == "straggler" and 200 <= int(s) < 220
                    for h, s, k in events)
    hang = ("03", "350", "hang") in events
    if not (straggler and hang and "both detected" in text):
        raise AssertionError(f"anomaly monitor: events {events}")
    print(f"anomaly monitor on the card: straggler host07 and hang host03 "
          f"flagged ({wall:.1f} s)", flush=True)


def train_phase(torch, dev, cli: TrainCLI):
    """Phase 11, (a)-(e).  Returns the kernels' launches in the train steps
    of (b)-(d) and in (e)."""
    phase("train (a): the train CLI, failed and resumed")
    train_cli_phase(cli)
    _reset_launches()
    phase("train (b): xlstm-125m in bf16 at full size")
    train_bf16_phase(torch, dev)
    phase("train (c): reduced configs, card against the CPU port")
    train_against_cpu_phase(torch, dev)
    phase("train (d): the compressed step, two pods")
    train_compressed_phase(torch, dev)
    step_launches = _launches()
    _reset_launches()
    phase("train (e): the anomaly monitor example")
    train_monitor_phase(torch)
    monitor_launches = _launches()
    print(f"phase 11 kernel launches: train steps {step_launches}, anomaly "
          f"monitor {monitor_launches}", flush=True)
    return step_launches, monitor_launches


# ---------------------------------------------------------------------------
# Phase 12: the sharding rules and the dry run
# ---------------------------------------------------------------------------

class DryrunCLI:
    """Phase 12 (a)'s child, the dry-run CLI on ``DRYRUN_CELL``: the smoke
    starts it before phase 10 (a), once the CPU port's worker is done, and
    reads it in phase 12, so it runs beside phases 10 and 11.  ``stop``
    kills it if it is still going."""

    def __init__(self):
        import tempfile
        import threading

        arch, shape, mesh = DRYRUN_CELL
        self.out_dir = tempfile.mkdtemp(prefix="smoke_dryrun_")
        env = {**os.environ,
               "PYTHONPATH": os.pathsep.join(
                   [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p])}
        self._t0 = time.perf_counter()
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out", self.out_dir],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        self.out = self.err = self.error = None
        self.seconds = 0.0
        self._thread = threading.Thread(target=self._wait, daemon=True)
        self._thread.start()

    def _wait(self):
        try:
            self.out, self.err = self._proc.communicate(timeout=300)
            self.seconds = time.perf_counter() - self._t0
        except BaseException as e:  # read in result()
            self.error = e

    def result(self):
        self._thread.join()
        if self.error is not None:
            raise self.error
        return self._proc.returncode, self.out, self.err

    def stop(self):
        import shutil

        if self._proc.poll() is None:
            self._proc.kill()
        self._thread.join(timeout=60)
        shutil.rmtree(self.out_dir, ignore_errors=True)


def dryrun_cli_phase(dry: DryrunCLI):
    """Phase 12 (a): the CLI printed ``OK`` and wrote the cell's JSON, with
    the collective inventory (``utils.collectives``: DTensor on a fake
    process group of 512, run in the child, whose imports of
    ``torch.distributed`` and ``DTensor`` fail the phase if they fail)."""
    t0 = time.perf_counter()
    rc, out, err = dry.result()
    waited = time.perf_counter() - t0
    arch, shape, mesh = DRYRUN_CELL
    tag = f"{arch}_{shape}_{mesh}"
    print("\n".join("dryrun | " + ln for ln in out.splitlines()), flush=True)
    if rc != 0 or not out.startswith(f"OK   {tag}"):
        raise AssertionError(f"dry-run CLI: rc {rc}\n{out}\n{err[-2000:]}")
    rec = json.loads((Path(dry.out_dir) / f"{tag}.json").read_text())
    roof, colls = rec["roofline"], rec["collectives"]
    if (not colls or rec["n_chips"] != 512
            or not isinstance(roof["collective_s"], float)
            or not rec["cost"]["wire_bytes_per_dev"] > 0):
        raise AssertionError(f"dry-run JSON: {rec}")
    print(f"dry-run CLI on {tag}: OK in {dry.seconds:.1f} s (child process; "
          f"phase 12 waited {waited:.1f} s for it; first trace "
          f"{rec['compile_seconds']} s, collective inventory "
          f"{rec['inventory_seconds']} s); argument bytes per "
          f"device {rec['memory']['argument_bytes_per_dev']}, peak "
          f"{rec['memory']['peak_bytes_per_dev']}, FLOPs per device "
          f"{rec['cost']['flops_per_dev']} (analytic), "
          f"{rec['cost']['torch_flops_per_dev_raw']} (counted)", flush=True)
    print(f"dry-run collectives on {tag} (512 ranks): "
          + ", ".join(f"{op} {v['count']:.0f} x "
                      f"({v['weighted_result_bytes']:.0f} B weighted)"
                      for op, v in colls.items())
          + f"; wire bytes per device {rec['cost']['wire_bytes_per_dev']}; "
          f"roofline compute_s {roof['compute_s']}, memory_s "
          f"{roof['memory_s']}, collective_s {roof['collective_s']} "
          f"({roof['dominant']}); torch {rec['torch_version']}; not a "
          f"partitioner's plan where: {rec['inventory_caveats']}", flush=True)


def dryrun_card_phase(torch, dev):
    """Phase 12 (b): ``DRYRUN_CELL`` on a one-shard mesh, traced on ``meta``
    and run on the card: bytes and FLOPs equal, step time beside the
    roofline, peak memory beside the prediction."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh

    arch, shape, _ = DRYRUN_CELL
    cfg = get_config(arch)
    want = dryrun.measure_cell(dryrun.build_cell(
        cfg, shape, make_test_mesh((1, 1), device="meta")))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cell = dryrun.build_cell(cfg, shape, make_test_mesh((1, 1), device=dev),
                             device=dev)
    nbytes = sum(t.numel() * t.element_size() for t in cell.tensors())
    held = torch.cuda.memory_allocated() - base
    if nbytes != want["memory"]["argument_bytes_per_dev"]:
        raise AssertionError(f"{arch} {shape}: {nbytes} bytes of arguments on "
                             f"the card, the dry run's "
                             f"{want['memory']['argument_bytes_per_dev']}")
    got = dryrun.measure_cell(cell)  # one decode step under the counters
    kept = torch.cuda.memory_allocated()
    counted = got["cost"]["torch_flops_per_dev_raw"]
    if counted != want["cost"]["torch_flops_per_dev_raw"]:
        raise AssertionError(f"{arch} {shape}: {counted} FLOPs counted on the "
                             f"card, {want['cost']['torch_flops_per_dev_raw']}"
                             " on meta")
    times, finite = [], True
    for _ in range(DRYRUN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cell.fn(*cell.args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        finite = finite and bool(torch.isfinite(out[0]).all())
        del out  # so that the peak below is one step's
    if not finite:
        raise AssertionError(f"{arch} {shape}: non-finite logits")
    if kept != torch.cuda.memory_allocated():
        raise AssertionError(f"{arch} {shape}: the counted step left "
                             f"{kept - torch.cuda.memory_allocated()} bytes "
                             "alive")
    peak = torch.cuda.max_memory_allocated() - base
    roof = want["roofline"]
    print(f"{arch} {shape} on one card (batch {cell.local_batch}, one shard): "
          f"arguments {nbytes} bytes = the dry run's (allocator "
          f"{held}), FLOPs counted {counted:.6e} = meta's, analytic "
          f"{want['cost']['flops_per_dev']:.6e}; decode step "
          f"{1e3 * statistics.median(times):.3f} ms median of "
          f"{DRYRUN_STEPS} ({', '.join(f'{1e3 * t:.3f}' for t in times)}) "
          f"against compute_s {1e3 * roof['compute_s']:.6f} ms, memory_s "
          f"{1e3 * roof['memory_s']:.6f} ms ({roof['dominant']}); "
          f"max_memory_allocated {peak} bytes against the predicted peak "
          f"{want['memory']['peak_bytes_per_dev']} (temp "
          f"{want['memory']['temp_bytes_per_dev']}, meta trace "
          f"{want['compile_seconds']} s, card {got['compile_seconds']} s)",
          flush=True)
    del cell


def elastic_phase(torch, dev):
    """Phase 12 (c): a reduced train state saved from the card, resumed onto
    ``ELASTIC_SHARDS`` shard devices as a ``(data, model)`` mesh, each leaf
    gathered bitwise."""
    import shutil
    import tempfile

    from repro_torch.ckpt import save_checkpoint
    from repro_torch.ckpt.checkpoint import named_leaves
    from repro_torch.configs import get_config
    from repro_torch.launch.elastic import elastic_mesh, resume_on_mesh
    from repro_torch.launch.mesh import describe_devices, shard_devices
    from repro_torch.launch.specs import abstract_train_state
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.steps import init_train_state

    cfg, oc = get_config(ELASTIC_ARCH).reduced(), OptConfig()
    state = init_train_state(torch.Generator(dev).manual_seed(0), cfg, oc,
                             device=dev)
    tmp = tempfile.mkdtemp(prefix="smoke_elastic_")
    try:
        save_checkpoint(tmp, 1, state)
        mesh = elastic_mesh(ELASTIC_MODEL,
                            devices=shard_devices(ELASTIC_SHARDS, dev))
        restored, _ = resume_on_mesh(tmp, abstract_train_state(cfg, oc), mesh)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got = dict(named_leaves(restored))
    n = 0
    for name, leaf in named_leaves(state):
        s = got[name]
        local = s.sharding.shard_shape(tuple(leaf.shape))
        if (s.sharding.num_devices != ELASTIC_SHARDS
                or any(tuple(p.shape) != local
                       or p.device.type != torch.device(dev).type
                       for p in s.pieces)
                or not torch.equal(s.gather(dev), leaf)):
            raise AssertionError(f"elastic resume: {name} {s}")
        n += 1
    default = elastic_mesh(1, device=dev)
    print(f"elastic resume of {ELASTIC_ARCH} reduced onto a "
          f"{tuple(mesh.devices.shape)} (data, model) mesh "
          f"({describe_devices(mesh.devices.flat)}): {n} leaves in "
          f"{ELASTIC_SHARDS} pieces each, gathered bitwise; elastic_mesh(1) "
          f"over every card: {tuple(default.devices.shape)}", flush=True)


def _serve_path(torch, cfg, params, prompt):
    """The reduced serve path: prefill, then ``RULES_GEN`` greedy steps of
    ``make_serve_step``; every logit, token and the final state."""
    from repro_torch.launch.specs import decode_state_leaves
    from repro_torch.models import prefill
    from repro_torch.models.transformer import decode_step

    with torch.no_grad():
        logits, state = prefill(params, cfg, prompt,
                                max_len=prompt.shape[1] + RULES_GEN)
        outs = [logits]
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        for _ in range(RULES_GEN):
            logits, state = decode_step(params, cfg, state, tok)
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            outs += [logits, tok]
    return outs + list(decode_state_leaves(state).values())


def mesh_rules_phase(torch, dev):
    """Phase 12 (d): the reduced serve path under ``use_mesh_rules`` on the
    multi-pod mesh, bitwise equal to the path without it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import init_params
    from repro_torch.sharding import ctx, use_mesh_rules

    mesh = make_production_mesh(multi_pod=True, device="meta")
    for arch in RULES_ARCHS:
        cfg = get_config(arch).reduced()
        params = init_params(torch.Generator(dev).manual_seed(0), cfg,
                             device=dev)
        prompt = torch.randint(0, cfg.vocab, RULES_PROMPT, device=dev,
                               dtype=torch.int32,
                               generator=torch.Generator(dev).manual_seed(1))
        plain = _serve_path(torch, cfg, params, prompt)
        with use_mesh_rules(mesh), ctx.recording() as sites:
            ruled = _serve_path(torch, cfg, params, prompt)
        if len(plain) != len(ruled) or not all(
                torch.equal(a, b) for a, b in zip(plain, ruled)):
            raise AssertionError(f"{arch}: the serve path differs under the "
                                 "mesh rules")
        names = sorted({s[0] for s in sites}, key=str)
        print(f"{arch} reduced on the card under use_mesh_rules(2 x 16 x 16): "
              f"{len(plain)} tensors bitwise equal to the run without; "
              f"{len(sites)} constraints resolved at {len(names)} distinct "
              f"sites {names}", flush=True)


def dryrun_phase(torch, dev, dry: DryrunCLI):
    """Phase 12, (a)-(d); (a)'s child has run beside phases 10 and 11."""
    t0 = time.perf_counter()
    phase("dry run (b): the cell on a one-shard mesh on the card")
    dryrun_card_phase(torch, dev)
    phase("dry run (c): elastic resume onto 4 shard devices")
    elastic_phase(torch, dev)
    phase("dry run (d): the serve path under the mesh rules")
    mesh_rules_phase(torch, dev)
    phase("dry run (a): the dry-run CLI")
    dryrun_cli_phase(dry)
    print(f"phase 12 took {time.perf_counter() - t0:.1f} s here, beside "
          f"{dry.seconds:.1f} s of (a)'s child", flush=True)


# ---------------------------------------------------------------------------
# phase 13: symlint's sync inventory on the card
# ---------------------------------------------------------------------------

def _first_difference(a, b):
    """The first key (in sorted order) whose counts differ, with both."""
    for key in sorted(set(a) | set(b)):
        if a.get(key, 0) != b.get(key, 0):
            return key, a.get(key, 0), b.get(key, 0)
    return None


def _stream_windows(torch, cfg, data, dev, window, warmup, measured,
                    watches):
    """Phase 13's drive: ``data (S, T)`` as ``S`` sessions of phase 6's
    service (``_stream_server``), raw in, then compressed in (phase 7 (a)'s
    senders, ``_sender_half``) on a second server: ``warmup`` windows, then
    ``measured`` windows inside the context managers ``watches()`` gives.
    Returns ``{mode: (watches, seconds of the measured window, rounds)}``
    for ``"raw"`` and ``"pieces"``."""
    import contextlib

    n = warmup + measured
    data = data[:, : n * window]
    pieces, _ = _sender_half(torch, cfg, data, dev, window)
    out = {}
    for mode in ("raw", "pieces"):
        server = _stream_server(cfg, data.shape[0], dev, window)
        sids = list(pieces[0])

        def serve_window(w):
            if mode == "raw":
                server.ingest_many({sid: data[r, w * window: (w + 1) * window]
                                    for r, sid in enumerate(sids)})
            else:
                server.ingest_pieces_many(pieces[w])

        for w in range(warmup):
            serve_window(w)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        active = list(watches())
        steps = server.totals["steps"]
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            for watch in active:
                stack.enter_context(watch)
            for w in range(warmup, n):
                serve_window(w)
        out[mode] = (active, time.perf_counter() - t0,
                     server.totals["steps"] - steps)
    return out


def _deep_tier_child():
    """``python -m repro_torch.analysis --deep --format json`` (on the card:
    its default), started so that it runs beside phase 13's drive."""
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", "--deep", "--format",
         "json"], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _deep_tier_result(child, t0):
    """(b): the deep tier on the card exits 0: every drive within the card's
    budgets, every probe's dtypes clean."""
    out, err = child.communicate(timeout=300)
    seconds = time.perf_counter() - t0
    try:
        doc = json.loads(out)
    except ValueError:
        doc = None
    if child.returncode != 0 or doc is None or doc["findings"]:
        shown = ([f"{f['path']}:{f['line']}: {f['rule']}: {f['message']}"
                  for f in doc["findings"]] if doc else [out[-2000:]])
        raise AssertionError(
            f"symlint (b): `python -m repro_torch.analysis --deep` on the "
            f"card exited {child.returncode}:\n" + "\n".join(shown)
            + f"\n{err[-2000:]}")
    print(f"symlint (b): `python -m repro_torch.analysis --deep` on the card "
          f"exited 0, 0 findings ({len(doc['suppressed'])} suppressed), "
          f"read {seconds:.1f} s after it started beside (a); syncs by drive and entry (each "
          f"within its `budget=`): {doc['sync_counts']}", flush=True)


def symlint_phase(torch, dev):
    """Phase 13: (a) phase 6's service at its configuration, raw in then
    compressed in, under ``SyncCounter`` and ``set_sync_debug_mode("warn")``
    at once; the two must agree key for key.  Prints the inventory (syncs
    per round by entry, site and caller) and returns the kernels' launches,
    counted from 0 just before it.  (b) beside it, the deep tier on the
    card in a child process, which must exit 0."""
    from repro_torch.analysis import deep
    from repro_torch.analysis.synccount import SyncCounter, SyncDebugRecorder
    from repro_torch.data.synthetic import make_fleet

    cfg = _paper_cfg()
    data = make_fleet(SESSIONS, POINTS, seed=0)
    group, attributor = deep.drive_attributor(ROOT)
    print(f"symlint: stream drive entries "
          f"{', '.join(e.qualname for e in group)}", flush=True)
    t0 = time.perf_counter()
    child = _deep_tier_child()
    try:
        _reset_launches()
        runs = _stream_windows(
            torch, cfg, data, dev, WINDOW, SYMLINT_WARMUP, SYMLINT_MEASURED,
            watches=lambda: [SyncCounter(dev, attributor),
                             SyncDebugRecorder(attributor)])
        torch.cuda.synchronize()
        n = _launches()
        wall = time.perf_counter() - t0
        _deep_tier_result(child, t0)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if n["kmeans_lloyd"] <= 0:
        raise AssertionError(f"symlint: the stream drive launched no Lloyd "
                             f"kernel: {n}")
    for mode, ((counter, recorder), seconds, rounds) in runs.items():
        for key, count in sorted(counter.counts.items()):
            entry, site, caller = key
            print(f"symlint {mode}: {entry} {site} <- {caller}: {count} "
                  f"({count / rounds:.2f} per round)", flush=True)
        print(f"symlint {mode}: {counter.total} syncs in {rounds} rounds "
              f"({counter.total / rounds:.2f} per round; by entry "
              f"{counter.by_entry()}), {seconds:.2f} s measured under both "
              f"counters; set_sync_debug_mode saw {recorder.total}",
              flush=True)
        diff = _first_difference(counter.counts, recorder.counts)
        if diff is not None:
            key, a, b = diff
            raise AssertionError(
                f"symlint {mode}: the sync counter and set_sync_debug_mode "
                f"disagree at {key}: {a} against {b} (by entry "
                f"{counter.by_entry()} against {recorder.by_entry()})")
    print(f"symlint (a): counters agree key for key, raw in and compressed "
          f"in; {wall:.1f} s, Lloyd launches {n['kmeans_lloyd']}, DTW "
          f"{n['dtw']}, half-step {n['kmeans_assign']}, EWMA {n['ewma']}",
          flush=True)
    return n


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--fleet-depths", default=None,
                    help="comma-separated points per stream: only build "
                         "the kernels and time phase 9 at each depth")
    ap.add_argument("--train-only", action="store_true",
                    help="only build the kernels and run phase 11")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"

    phase("environment")
    smi = _smi()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {_nvcc_version()}", flush=True)
    if args.fleet_depths:
        return _fleet_depths(torch, dev, smi, [
            int(d) for d in args.fleet_depths.split(",")])
    if args.train_only:
        _build_kernels()
        cli = TrainCLI()
        try:
            train_phase(torch, dev, cli)
        finally:
            cli.stop()
        print(smi)
        return 0

    # the CPU port's side of phase 6 runs beside the card's phases
    ctx = multiprocessing.get_context("spawn")
    cpu_results, send = ctx.Pipe(duplex=False)
    worker = ctx.Process(target=_cpu_worker, args=(send,), daemon=True)
    worker.start()
    send.close()
    try:
        return _card_phases(torch, dev, smi, cpu_results)
    finally:
        if worker.is_alive():
            worker.terminate()
        worker.join(timeout=60)


def _fleet_depths(torch, dev, smi, depths) -> int:
    """Phase 9 alone: (a)-(b) at each depth, (c)-(d) once, timed."""
    _build_kernels()
    took = {}
    for points in depths:
        phase(f"fleet (a)-(b) at {points} points")
        t0 = time.perf_counter()
        fleet_phase(torch, dev, points)
        took[f"(a)-(b) at {points}"] = time.perf_counter() - t0
    phase("sharded (c)-(d)")
    t0 = time.perf_counter()
    sharded_cli_phase(torch, dev)
    sharded_table_phase(torch, dev)
    took["(c)-(d)"] = time.perf_counter() - t0
    print(smi)
    print("phase 9 wall: " + ", ".join(f"{k} {v:.2f} s"
                                       for k, v in took.items()), flush=True)
    return 0


def _build_kernels():
    phase("build")
    from repro_torch.kernels import _build

    def timed_load(name):
        t = time.perf_counter()
        _build.load(name)
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        took = dict(zip(SOURCES, pool.map(timed_load, SOURCES)))
    print("build: " + ", ".join(f"{k} in {v:.2f} s" for k, v in took.items())
          + f", {time.perf_counter() - t0:.2f} s in all "
          f"({_build.BUILD_ROOT})", flush=True)
    for name in ("dtw", "ewma"):
        for line in _ptxas_report(_build.build(name).with_suffix(".log")):
            print(f"ptxas {name}: {line}", flush=True)


def _card_phases(torch, dev, smi, cpu_results) -> int:
    _build_kernels()

    phase("k-means kernels against their plain versions")
    measured = kernel_phase(torch, dev)

    phase("DTW kernel against its plain version")
    measured["dtw"] = dtw_phase(torch, dev)

    phase("EWMA kernel against its plain version")
    measured["ewma"] = ewma_phase(torch, dev)

    phase("end to end")
    launches, krn = end_to_end_phase(torch, dev)

    phase("compressed-in")
    compressed_in_phase(torch, dev, krn, launches["kmeans_lloyd"])

    # phase 11 (a)'s two train CLI runs (330-480 s, most of it waiting on
    # their pipeline) start here and run beside phases 8 and 9; phase 10
    # (a)'s card side starts after phase 8, when the CPU port's worker (its
    # whole run up to about 630 s) is about done, and runs beside phase 6's
    # checks against that worker and phase 9.  Each is a process of its
    # own; all are host-bound, so the wall times of phases 8-10 are read
    # with them running
    cli = TrainCLI()
    fleet = FleetCard(dev)
    abba = None
    try:
        phase("replay (a): the scenario zoo")
        zoo = zoo_phase(torch, dev)
        phase("replay (b): flash_crowd at the paper's fleet")
        scale_phase(torch, dev)
        phase("replay (c): mixed_fleet over loopback TCP, scraped")
        tcp_replay_phase(torch, dev, zoo["mixed_fleet"])
        phase("replay (d): the stream CLI")
        cli_phase(torch, dev)
        abba = AbbaCard(dev)
        phase("end to end: cuda against the CPU port")
        cross_device_phase(torch, dev, krn, cpu_results)
        return _phases_9_to_13(torch, dev, smi, cpu_results, measured,
                               launches, cli, zoo, abba, fleet)
    finally:
        cli.stop()
        fleet.stop()
        if abba is not None:
            abba.stop()


def _phases_9_to_13(torch, dev, smi, cpu_results, measured, launches, cli,
                    zoo, abba_card, fleet_card):
    phase("fleet (a)-(b): run_fleet on the paper's fleet (its worker)")
    fleet_card.result()
    phase("sharded (c): the stream CLI with --devices 4")
    sharded_cli_phase(torch, dev)
    phase("sharded (d): a 4-block slot table against one block")
    sharded_table_phase(torch, dev)
    phase("replay (a): the zoo against the CPU port")
    zoo_against_cpu(zoo, _recv(cpu_results, "phase 8 (a)"))
    abba_cpu = _recv(cpu_results, "phase 10 (a)")
    # the CPU port's worker is done: phase 12 (a)'s child runs from here,
    # beside phases 10 and 11
    dry = DryrunCLI()
    try:
        phase("ABBA (a): the Fig. 5 streams on the card against the CPU port")
        abba = abba_phase(abba_card.result(), abba_cpu)
        phase("serve (b): the serve CLI at full width")
        for arch in FULL_DEPTH:
            serve_cli_phase(arch)
        phase("serve (c): every arch at full width in bf16")
        peaks = full_width_phase(torch, dev)
        for arch, peak in peaks.items():
            print(f"{arch} at full width and depth (the serve CLI's config): "
                  f"torch.cuda.max_memory_allocated {peak} bytes "
                  f"({peak / 2**30:.2f} GiB)", flush=True)
        phase("serve (d): reduced configs, card against the CPU port")
        reduced_phase(torch, dev)
        train_launches, monitor_launches = train_phase(torch, dev, cli)
        _reset_launches()
        dryrun_phase(torch, dev, dry)
        if any(v for k, v in _launches().items() if k != "host_syncs"):
            raise AssertionError(f"phase 12 launched a kernel: {_launches()}")
    finally:
        dry.stop()
    phase("symlint: (a) the service's syncs under two counters, (b) --deep")
    symlint = symlint_phase(torch, dev)
    # the half-step's and the ewma kernel's launches are their own entry
    # points' (phases 3 and 5): the service launches neither
    for name in ("kmeans_assign", "ewma"):
        launches[name] = measured[name].pop("launches")

    rows = [{"name": "kmeans_assign", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/kmeans_assign.cu",
             "replaces": "src/repro/kernels/kmeans.py:78"},
            {"name": "kmeans_lloyd", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/kmeans_assign.cu",
             "replaces": "src/repro/kernels/kmeans.py:78"},
            {"name": "dtw", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/dtw.cu",
             "replaces": "src/repro/kernels/dtw.py:71"},
            {"name": "ewma", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/ewma.cu",
             "replaces": "src/repro/kernels/ewma.py:104"}]
    rows = [{**row, "launches": launches[row["name"]],
             "launches_abba": abba[row["name"]],
             "launches_train_step": train_launches[row["name"]],
             "launches_train_monitor": monitor_launches[row["name"]],
             "launches_symlint": symlint[row["name"]],
             **measured[row["name"]], "library_ms": None} for row in rows]
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

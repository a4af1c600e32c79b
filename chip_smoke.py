#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SymED on one GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Four phases,
each raising on failure:

1. environment: the card's name and power limit, torch/CUDA/nvcc versions;
2. build: the k-means kernel from ``src/repro_torch/kernels/csrc``;
3. kernel against its plain PyTorch version on the card, at the shapes of
   ``tests/test_kernels.py`` and at the service's shape (S=256 slots,
   N=512 pieces, D=2, K=100 centers): labels and counts exact, masked
   labels 0, sums within rtol=atol=1e-5; median times over 50 runs;
4. end to end: ``StreamServer`` on cuda with the paper's settings serves 256
   sessions x 2048 points in 64-point windows and closes them, once through
   the kernel and once through the plain version; then, on 8 of those
   sessions at the same settings and on a small config, the cuda kernel
   path against the CPU port (which the CPU tests hold to the JAX
   reference).

The last two lines are a JSON summary of every kernel and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
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


def phase(name: str) -> None:
    print(f"[phase] {name}", flush=True)


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


def _bound_ms(shape, mask, act):
    """Least time for one assign half-step on these inputs: bytes moved
    (inputs read once, outputs written once) over the HBM rate, and f32
    operations over the f32 peak; the larger of the two."""
    s, n, d, k = shape
    nbytes = (4 * s * n * d + s * n + 4 * s * k * d + s * k   # inputs
              + 4 * s * n + 4 * s * k * d + 4 * s * k)          # outputs
    active_pairs = int(act.sum(dim=1).mul(n).sum())
    # per piece |x|^2 (2D); per (piece, active center) the dot (2D), the
    # expansion (3) and the compare (1); per valid piece D adds and a count
    ops = (2 * d * s * n + (2 * d + 4) * active_pairs
           + (d + 1) * int(mask.sum()) + 2 * d * s * k)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels.kmeans import kmeans_assign_cuda

    measured = None
    for i, shape in enumerate(TEST_SHAPES + [MAIN_SHAPE]):
        x, mask, c, act = _inputs(torch, shape, 100 + i, dev)
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
        if shape == MAIN_SHAPE:
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
                  f"({bound_by})", flush=True)
            measured = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": bound_by}
    return measured


def _serve(torch, cfg, data, *, device, use_kernel, window, clock=None):
    """Round-robin arrivals of every row of ``data``, then close all."""
    import numpy as np

    from repro_torch.launch.stream import StreamServer

    n_sessions, length = data.shape
    server = StreamServer(cfg, max_sessions=n_sessions, window_cap=window,
                          digitize_every_k=1, use_kernel=use_kernel,
                          device=device, clock=clock)
    sids = [f"s{i}" for i in range(n_sessions)]
    for sid in sids:
        server.open(sid)
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
    closed = {sid: server.close(sid) for sid in sids}
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    out = {}
    for sid in sids:
        res = closed[sid]
        out[sid] = {
            "labels": np.concatenate(labels[sid] + [res["delta"]["labels"]]),
            "endpoints": np.concatenate(ends[sid]
                                        + [res["delta"]["endpoints"]]),
            "n_pieces": res["n_pieces"], "t_seen": res["t_seen"],
            "k": int(res["out"]["k"]),
        }
    return out, {"wall": wall, "ingest": t_ingest, "rounds": rounds,
                 "points": int(server.totals["points_in"])}


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


def _against_cpu(torch, dev, cfg, data, window, what):
    """The cuda kernel path against the CPU port on the same input: sender
    and wire outputs bitwise, at least 99% of symbols equal."""
    on_gpu, _ = _serve(torch, cfg, data, device=dev, use_kernel=True,
                       window=window)
    on_cpu, _ = _serve(torch, cfg, data, device="cpu", use_kernel=False,
                       window=window)
    agree, total = _compare(on_gpu, on_cpu, f"cuda vs cpu, {what}")
    if agree < 0.99 * total:
        raise AssertionError(f"cuda vs cpu, {what}: symbols {agree}/{total}")
    ks = [res["k"] for res in on_gpu.values()]
    print(f"{what}, cuda kernel path vs cpu port: sender/wire bitwise for "
          f"{len(on_gpu)} sessions, symbols {agree}/{total} agree, k up to "
          f"{max(ks)}", flush=True)


def end_to_end_phase(torch, dev):
    import numpy as np

    from repro_torch.core import digitize
    from repro_torch.core.symed import SymEDConfig
    from repro_torch.data.synthetic import make_fleet
    from repro_torch.kernels.kmeans import kmeans_assign_cuda
    from repro_torch.launch.stream import PhaseClock

    # the paper's settings (configs/symed_paper.py)
    cfg = SymEDConfig(tol=0.5, alpha=0.01, scl=1.0, k_min=3, k_max=100,
                      n_max=512, len_max=512)
    data = make_fleet(SESSIONS, POINTS, seed=0)
    clock = PhaseClock(torch.device(dev))

    kmeans_assign_cuda.launches = 0
    digitize.host_syncs = 0
    krn, t_krn = _serve(torch, cfg, data, device=dev, use_kernel=True,
                        window=WINDOW, clock=clock)
    launches = kmeans_assign_cuda.launches
    syncs = digitize.host_syncs
    if launches <= 0:
        raise AssertionError("the service never launched the k-means kernel")

    plain, t_plain = _serve(torch, cfg, data, device=dev, use_kernel=False,
                            window=WINDOW)
    agree, total = _compare(krn, plain, "kernel vs plain")
    share = agree / max(total, 1)
    diff = sorted(sid for sid in krn
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
          f"kernel launches {launches}, host syncs {syncs} "
          f"({syncs / max(rounds, 1):.1f} per round + 1 harvest copy)",
          flush=True)
    print(f"end to end (kernel): {t_krn['points'] / t_krn['wall']:.1f} "
          f"points/s over {t_krn['wall']:.2f} s, "
          f"{1e3 * t_krn['ingest'] / rounds:.2f} ms per round "
          + ", ".join(f"{k} {v / rounds:.2f} ms" for k, v in split.items()),
          flush=True)
    print(f"end to end (plain):  {t_plain['points'] / t_plain['wall']:.1f} "
          f"points/s over {t_plain['wall']:.2f} s, "
          f"{1e3 * t_plain['ingest'] / rounds:.2f} ms per round", flush=True)
    print(f"kernel vs plain: sender/wire bitwise for {SESSIONS} sessions, "
          f"symbols "
          f"{agree}/{total} agree ({100 * share:.3f}%), sessions differing: "
          f"{diff[:8]}{' ...' if len(diff) > 8 else ''}", flush=True)

    # the card against the CPU port: 8 of the sessions above, spread over
    # the fleet's families, at the paper's widths; then a config small
    # enough that k reaches k_max
    _against_cpu(torch, dev, cfg, data[::SESSIONS // 8], WINDOW,
                 "paper config, 8 sessions")
    small = SymEDConfig(tol=0.5, alpha=0.02, scl=1.0, k_min=3, k_max=8,
                        len_max=32, n_max=64, lloyd_iters=5)
    _against_cpu(torch, dev, small, make_fleet(4, 160, seed=1), 32,
                 "small config")
    return launches


def main() -> int:
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

    phase("build")
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load("kmeans_assign")
    print(f"build: kmeans_assign in {time.perf_counter() - t0:.2f} s "
          f"({_build.BUILD_ROOT})", flush=True)

    phase("kernel against its plain version")
    measured = kernel_phase(torch, dev)

    phase("end to end")
    launches = end_to_end_phase(torch, dev)

    row = {"name": "kmeans_assign", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/kmeans_assign.cu",
           "replaces": "src/repro/kernels/kmeans.py:78",
           "launches": launches, **measured, "library_ms": None}
    print(smi)
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

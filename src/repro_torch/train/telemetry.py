"""SymED-compressed training telemetry + straggler watchdog.

This is the paper's sender/receiver split mapped onto the cluster: every host
is an IoT-class *sender* that runs Alg. 1 (EWMA/EWMV normalization + O(1)
bridge-error compression, numpy scalar math -- cheap enough for a per-step
host callback), transmitting one float per emitted piece to the coordinator
*receiver*, which can digitize the piece stream into symbols on demand for
monitoring dashboards / anomaly mining.

The straggler watchdog dogfoods Eq. 1-2 directly: step times are z-scored
against the damped-window mean/variance; a z-score past the threshold flags a
straggler, a wall-clock timeout flags a hang.  (This is how SymED becomes a
first-class feature of the trainer, not a side-car -- see DESIGN.md Sec. 3.)

Port of ``repro.train.telemetry``: the sender and the watchdog are plain
Python, the same code; ``TelemetryHub.digitize`` runs the port's
``core.digitize.digitize_pieces`` with the reference's key, on ``device``
(``cuda`` unless told otherwise).
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

__all__ = ["NumpySender", "TelemetryHub", "StepWatchdog"]


class NumpySender:
    """Host-side SymED sender (paper Alg. 1) on plain Python floats."""

    def __init__(self, tol: float = 0.5, alpha: float = 0.05, len_max: int = 256):
        self.tol = tol
        self.alpha = alpha
        self.len_max = len_max
        self._n = 0
        self.wire: List[tuple] = []   # (step_index, endpoint) transmissions
        self._state = None

    def push(self, t: float) -> Optional[float]:
        """Ingest one point; returns the transmitted endpoint if a piece closed."""
        t = float(t)
        self._n += 1
        if self._state is None:
            # EWMA_0 = t0, EWMV_0 = 1; open segment at t0
            self._state = dict(mean=t, var=1.0, start=t, last=t, npts=1,
                               s0=0.0, s1=0.0, s2=0.0)
            self.wire.append((0, t))  # t0 hello (4 bytes)
            return None
        st = self._state
        a = self.alpha
        st["mean"] = a * t + (1 - a) * st["mean"]
        st["var"] = a * (t - st["mean"]) ** 2 + (1 - a) * st["var"]

        v = t - st["start"]
        h = float(st["npts"])
        s0, s1, s2 = st["s0"] + v, st["s1"] + h * v, st["s2"] + v * v
        npts = st["npts"] + 1
        length = max(npts - 1.0, 1.0)
        sum_h2 = length * (length + 1.0) * (2.0 * length + 1.0) / 6.0
        r = v / length
        err_raw = max(s2 - 2.0 * r * s1 + r * r * sum_h2, 0.0)
        err = err_raw / max(st["var"], 1e-12)
        bound = (npts - 2.0) * self.tol * self.tol

        if err > bound or npts > self.len_max:
            endpoint = st["last"]
            self.wire.append((self._n - 1, endpoint))
            v1 = t - st["last"]
            st.update(start=st["last"], last=t, npts=2, s0=v1, s1=v1, s2=v1 * v1)
            return endpoint
        st.update(last=t, npts=npts, s0=s0, s1=s1, s2=s2)
        return None

    @property
    def raw_bytes(self) -> int:
        return 4 * self._n

    @property
    def wire_bytes(self) -> int:
        return 4 * len(self.wire)

    def compression_rate(self) -> float:
        return self.wire_bytes / max(self.raw_bytes, 1)


class TelemetryHub:
    """Coordinator-side receiver: one SymED stream per (host, metric)."""

    def __init__(self, tol: float = 0.5, alpha: float = 0.05):
        self.tol = tol
        self.alpha = alpha
        self.senders: Dict[str, NumpySender] = {}

    def record(self, name: str, value: float):
        s = self.senders.setdefault(name, NumpySender(self.tol, self.alpha))
        s.push(value)

    def record_metrics(self, host: str, metrics: Dict[str, float]):
        for k, v in metrics.items():
            self.record(f"{host}/{k}", float(v))

    def traffic_report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "raw_bytes": s.raw_bytes,
                "wire_bytes": s.wire_bytes,
                "cr": s.compression_rate(),
                "pieces": len(s.wire),
            }
            for name, s in self.senders.items()
        }

    def digitize(self, name: str, k_max: int = 16, device=None):
        """Receiver-side symbolization of one stream (on demand)."""
        import torch

        from repro_torch import resolve_device
        from repro_torch.core import prng
        from repro_torch.core.digitize import digitize_pieces

        s = self.senders[name]
        if len(s.wire) < 2:
            return None
        device = resolve_device(device)
        steps = [w[0] for w in s.wire]
        ends = [w[1] for w in s.wire]
        n = len(ends) - 1
        n_max = max(8, 1 << (n - 1).bit_length())
        lens = [steps[i + 1] - steps[i] for i in range(n)] + [0] * (n_max - n)
        incs = [ends[i + 1] - ends[i] for i in range(n)] + [0.0] * (n_max - n)
        f32 = dict(dtype=torch.float32, device=device)
        return digitize_pieces(
            torch.tensor(lens, **f32), torch.tensor(incs, **f32),
            torch.tensor(n, dtype=torch.int32, device=device),
            prng.key(0, device),
            k_cap=k_max, tol=self.tol, k_max_active=k_max,
        )


class StepWatchdog:
    """Straggler/hang detection on step times via the paper's EWMA/EWMV."""

    def __init__(self, alpha: float = 0.05, z_threshold: float = 4.0,
                 hang_factor: float = 10.0, warmup: int = 5):
        self.alpha = alpha
        self.z = z_threshold
        self.hang_factor = hang_factor
        self.warmup = warmup
        self.mean = None
        self.var = 1.0
        self.count = 0
        self.events: List[dict] = []
        self._tick: Optional[float] = None

    def start_step(self):
        self._tick = time.monotonic()

    def end_step(self, step: int) -> Optional[dict]:
        dt = time.monotonic() - self._tick if self._tick else 0.0
        self._tick = None
        return self.observe(step, dt)

    def observe(self, step: int, dt: float) -> Optional[dict]:
        """Feed one step duration directly (testing / simulation)."""
        self.count += 1
        if self.mean is None:
            self.mean = dt
            return None
        a = self.alpha
        prev_mean, prev_var = self.mean, self.var
        self.mean = a * dt + (1 - a) * self.mean
        self.var = a * (dt - self.mean) ** 2 + (1 - a) * self.var
        if self.count <= self.warmup:
            return None
        zscore = (dt - prev_mean) / math.sqrt(max(prev_var, 1e-12))
        if dt > self.hang_factor * prev_mean and self.count > self.warmup:
            ev = {"step": step, "kind": "hang", "dt": dt, "z": zscore}
        elif zscore > self.z:
            ev = {"step": step, "kind": "straggler", "dt": dt, "z": zscore}
        else:
            return None
        self.events.append(ev)
        return ev

    def deadline(self) -> float:
        """Suggested per-step timeout for the runner."""
        base = self.mean if self.mean else 60.0
        return max(self.hang_factor * base, 30.0)

"""SymED receiver: online digitization via warm-started k-means (paper Alg. 3).

Port of ``repro.core.digitize``.  State lives in fixed-capacity masked
buffers: ``pieces (S, n_max, 2)`` raw (len, inc) tuples with ``n`` valid,
``labels (S, n_max)``, ``centers (S, k_max, 2)`` with ``k`` active.  Every
function works on a table of S slots (the batch dimension the reference
gets from ``jax.vmap``); the per-slot functions wrap the table ones with
S = 1.

The reference's control flow is lowered by hand exactly as jax batches it:
both branches of a per-lane ``cond`` are computed and selected per lane
(``_select_lanes``), and each ``while_loop`` runs until no lane wants
another trip (``_any``, one host sync per trip on CUDA; counted in
``host_syncs``).

Arithmetic follows the reference's CPU compilation so that CPU results are
bitwise equal to it: sums over the piece axis run in sequential blocks of
32 rows (XLA's tree-reduction rewrite), per-cluster sums in row order, and
the two-term sums of squares fuse their second multiply-add.  On CUDA the
row reductions are plain ``torch.sum`` / batched matrix products.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.normalize import fma32

__all__ = [
    "DigitizerState",
    "digitizer_delta",
    "digitizer_init",
    "digitizer_step",
    "digitizer_table_step",
    "digitize_pieces",
    "digitize_span",
    "digitize_span_table",
    "masked_kmeans",
    "masked_kmeans_table",
    "max_cluster_variance",
    "scale_coords",
]

_BIG = 1e30
_TREE = 32  # rows per sequential block of a reduction on the CPU

# Loop predicates evaluated on the host (each one a device sync on CUDA).
host_syncs = 0


class DigitizerState(NamedTuple):
    pieces: torch.Tensor   # (..., n_max, 2) raw (len, inc); len stored as f32
    n: torch.Tensor        # (...,) int32 -- number of valid pieces
    labels: torch.Tensor   # (..., n_max) int32
    centers: torch.Tensor  # (..., k_max, 2) raw space
    k: torch.Tensor        # (...,) int32 -- number of active centers
    key: torch.Tensor      # (..., 2) int64 threefry key words (prng)


def _any(pred: torch.Tensor) -> bool:
    global host_syncs
    host_syncs += 1
    return bool(pred.any())


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading axis, one row after the other."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def _row_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` (the piece axis) in the reference's CPU order:
    sequential blocks of 32 rows, then the block sums in order."""
    if x.is_cuda:
        return x.sum(dim)
    x = x.movedim(dim, 0)
    n = x.shape[0]
    if n <= _TREE:
        return _seq_sum(x)
    pad = -n % _TREE
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
    blocks = x.reshape((-1, _TREE) + x.shape[1:]).movedim(1, 0)
    return _seq_sum(_seq_sum(blocks))


def _cluster_sums(onehot: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``onehot^T @ values`` per slot: ``(S, N, K), (S, N, D) -> (S, K, D)``.

    On the CPU each cluster adds its rows in row order, as the reference's
    compiled dot does at these sizes; on CUDA it is a batched product.
    """
    if values.is_cuda:
        return torch.bmm(onehot.transpose(1, 2), values)
    acc = onehot[:, 0, :, None] * values[:, 0, None, :]
    for i in range(1, values.shape[1]):
        acc = acc + onehot[:, i, :, None] * values[:, i, None, :]
    return acc


def _dot_chain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_e a_e * b_e`` over the last axis: the first product rounded on
    its own, every further term fused into the running sum."""
    acc = a[..., 0] * b[..., 0]
    for e in range(1, a.shape[-1]):
        acc = fma32(a[..., e], b[..., e], acc)
    return acc


def _one_hot(labels: torch.Tensor, k: int) -> torch.Tensor:
    """f32 one-hot; out-of-range labels give an all-zero row."""
    return (labels[..., None].long()
            == torch.arange(k, device=labels.device)).float()


def digitizer_init(n_max: int, k_max: int, key: torch.Tensor) -> DigitizerState:
    """Blank digitizer; ``key (..., 2)`` sets the batch shape."""
    key = torch.as_tensor(key, dtype=torch.int64)
    batch, dev = key.shape[:-1], key.device
    return DigitizerState(
        pieces=torch.zeros(batch + (n_max, 2), dtype=torch.float32, device=dev),
        n=torch.zeros(batch, dtype=torch.int32, device=dev),
        labels=torch.zeros(batch + (n_max,), dtype=torch.int32, device=dev),
        centers=torch.zeros(batch + (k_max, 2), dtype=torch.float32,
                            device=dev),
        k=torch.zeros(batch, dtype=torch.int32, device=dev),
        key=key,
    )


def scale_coords(pieces, mask, scl) -> Tuple[torch.Tensor, torch.Tensor]:
    """ABBA standardization of piece space, per slot.

    ``pieces (S, n, 2)``, ``mask (S, n)``.  Returns ``(scales (S, 2),
    coords (S, n, 2))`` with ``coords = pieces * scales`` and ``scales =
    (scl/std(len), 1/std(inc))`` over the active pieces.
    """
    cnt = torch.clamp_min(mask.sum(-1, dtype=torch.int32), 1).float()
    m = mask[..., None].float()
    mean = _row_sum(pieces * m, -2) / cnt[..., None]
    dev = pieces - mean[..., None, :]
    var = _row_sum(dev * dev * m, -2) / cnt[..., None]
    std = torch.sqrt(var)
    std = torch.where(std < 1e-12, torch.ones_like(std), std)
    num = torch.stack([torch.full_like(std[..., 0], float(np.float32(scl))),
                       torch.ones_like(std[..., 1])], dim=-1)
    scales = num / std
    return scales, pieces * scales[..., None, :]


def _pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``||x_i - c_j||^2`` per slot via the expansion ``|x|^2 - 2x.c + |c|^2``
    (the form the kernel computes): ``(S, n, D), (S, k, D) -> (S, n, k)``."""
    x2 = _dot_chain(x, x)[..., :, None]
    c2 = _dot_chain(c, c)[..., None, :]
    cross = _dot_chain(x[..., :, None, :], c[..., None, :, :])
    return torch.clamp_min((x2 - 2.0 * cross) + c2, 0.0)


def _lloyd_half_step(coords, mask, centers, center_active):
    """The assign half of one Lloyd iteration, for every slot.

    The op sequence the kernel fuses: masked pairwise distances, argmin
    (first index on ties), per-cluster (sum, count).  Labels of masked rows
    are the argmin here; the kernel zeroes them.
    Returns ``(labels (S, n) i32, sums (S, k, D), counts (S, k))``.
    """
    k_max = centers.shape[-2]
    d = _pairwise_sq_dists(coords, centers)
    d = torch.where(center_active[..., None, :], d, torch.full_like(d, _BIG))
    labels = torch.argmin(d, dim=-1).to(torch.int32)
    onehot = _one_hot(labels, k_max) * mask[..., None].float()
    counts = onehot.sum(-2)
    sums = _cluster_sums(onehot, coords)
    return labels, sums, counts


def masked_kmeans_table(coords, mask, c_init, k, iters: int = 10, *,
                        use_kernel: bool = False):
    """Slot-table batch of independent masked Lloyd problems.

    ``coords (S, n, 2)``, ``mask (S, n)``, ``c_init (S, k_max, 2)``,
    ``k (S,)``.  ``use_kernel`` routes the assign half-step through
    ``kernels.ops.kmeans_assign`` (the CUDA kernel for CUDA tensors, one
    launch per iteration for the whole table), which zeroes the labels of
    masked pieces.  Returns ``(centers, labels)``; empty clusters keep
    their previous position.
    """
    from repro_torch.kernels import ops  # deferred: ops.ref imports us

    s, n = coords.shape[0], coords.shape[1]
    k_max = c_init.shape[1]
    center_active = (torch.arange(k_max, device=coords.device)[None, :]
                     < k[:, None])
    centers = c_init
    labels = torch.zeros((s, n), dtype=torch.int32, device=coords.device)
    for _ in range(iters):
        if use_kernel:
            labels, sums, counts = ops.kmeans_assign(coords, mask, centers,
                                                     center_active)
        else:
            labels, sums, counts = _lloyd_half_step(coords, mask, centers,
                                                    center_active)
        counts = counts[..., None]
        centers = torch.where(counts > 0, sums / torch.clamp_min(counts, 1.0),
                              centers)
    return centers, labels


def masked_kmeans(coords, mask, c_init, k, iters: int = 10):
    """One slot's masked Lloyd iterations: ``coords (n, 2)``, ``mask (n,)``,
    ``c_init (k_max, 2)``, ``k ()``.  Returns ``(centers, labels)``."""
    c, lab = masked_kmeans_table(coords[None], mask[None], c_init[None],
                                 torch.as_tensor(k).reshape(1), iters)
    return c[0], lab[0]


def max_cluster_variance(coords, mask, centers, labels, k):
    """Per slot: ``max_c sum_{p in c} ||p - center_c||^2 / max(|c| - 1, 1)``
    over active, non-empty clusters (the paper's MAXCLUSTERVARIANCE)."""
    k_max = centers.shape[-2]
    onehot = _one_hot(labels, k_max) * mask[..., None].float()
    diff = coords[..., :, None, :] - centers[..., None, :, :]
    sq = _dot_chain(diff, diff)
    per_cluster = _row_sum(sq * onehot, -2)
    counts = onehot.sum(-2)
    var = per_cluster / torch.clamp_min(counts - 1.0, 1.0)
    active = ((torch.arange(k_max, device=coords.device) < k[..., None])
              & (counts > 0))
    return torch.where(active, var, torch.zeros_like(var)).amax(-1)


def _raw_centers(pieces, mask, labels, k_max: int):
    """Per-cluster means of the *raw* pieces, per slot."""
    onehot = _one_hot(labels, k_max) * mask[..., None].float()
    counts = onehot.sum(-2)
    sums = _cluster_sums(onehot, pieces)
    return sums / torch.clamp_min(counts[..., None], 1.0), counts


def _select_lanes(pred, new, old):
    """Per-lane select over (nested) tuples with an ``(S,)`` leading axis."""
    if isinstance(new, tuple):
        out = [_select_lanes(pred, a, b) for a, b in zip(new, old)]
        return type(new)(*out) if hasattr(new, "_fields") else tuple(out)
    return torch.where(pred.reshape(pred.shape + (1,) * (new.dim() - 1)),
                       new, old)


def _take_rows(x, idx):
    """``x[s, idx[s]]`` for every slot s (``x (S, n, ...)``, ``idx (S,)``).

    An index out of range (a dead lane whose buffer is full) reads as
    ``jnp.take_along_axis`` fills it: NaN, or the most negative integer.
    """
    idx = idx.long()
    ok = (idx >= 0) & (idx < x.shape[1])
    rows = x[torch.arange(x.shape[0], device=x.device),
             idx.clamp(0, x.shape[1] - 1)]
    fill = (float("nan") if x.is_floating_point()
            else torch.iinfo(x.dtype).min)
    return torch.where(ok.reshape(ok.shape + (1,) * (rows.dim() - 1)), rows,
                       torch.full_like(rows, fill))


def _put_rows(x, idx, rows):
    """Copy of ``x`` with ``x[s, idx[s]] = rows[s]``, the index clamped into
    range as ``lax.dynamic_update_slice`` clamps it."""
    out = x.clone()
    idx = idx.long().clamp(0, x.shape[1] - 1)
    out[torch.arange(x.shape[0], device=x.device), idx] = rows
    return out


def digitizer_table_step(state: DigitizerState, piece, live, *, tol: float,
                         scl: float, k_min: int, k_max_active: int,
                         lloyd_iters: int = 10, use_kernel: bool = False):
    """Slot-table batch of ``digitizer_step``: every lane ingests one piece.

    ``piece (S, 2)``; lanes with ``live=False`` pass through unchanged.
    The k-means runs as one table-level problem (``masked_kmeans_table``),
    so ``use_kernel=True`` launches each Lloyd half-step once for all slots.
    Returns ``(state, symbols (S,))`` with symbol 0 for dead lanes.
    """
    s, n_max = state.pieces.shape[0], state.pieces.shape[1]
    k_cap = state.centers.shape[1]
    dev = state.pieces.device
    piece = piece.to(torch.float32)

    pieces = _put_rows(state.pieces, state.n, piece)
    n = state.n + 1
    ar_n = torch.arange(n_max, device=dev)
    mask = ar_n[None, :] < n[:, None]

    # --- trivial phase: every piece its own cluster ------------------------
    m = min(k_cap, n_max)
    labels_t = torch.where(mask, ar_n[None, :].to(torch.int32),
                           torch.zeros((), dtype=torch.int32, device=dev))
    centers_t = torch.zeros((s, k_cap, 2), dtype=torch.float32, device=dev)
    centers_t[:, :m] = torch.where(mask[:, :m, None], pieces[:, :m],
                                   torch.zeros((), device=dev))
    trivial = DigitizerState(pieces, n, labels_t, centers_t, n, state.key)

    # --- clustering phase (the k-means runs table-level) -------------------
    scales, coords = scale_coords(pieces, mask, scl)
    c_scaled = state.centers * scales[:, None, :]
    bound = float(np.float32(tol) * np.float32(tol))
    k_hi = torch.clamp_max(n, int(k_max_active))
    k_o = torch.clamp_min(state.k, 1)

    def run(c_init, k):
        c, lab = masked_kmeans_table(coords, mask, c_init, k, lloyd_iters,
                                     use_kernel=use_kernel)
        return c, lab, max_cluster_variance(coords, mask, c, lab, k)

    c, lab, err = run(c_scaled, k_o)
    k, key = k_o, state.key
    newest = _take_rows(coords, n - 1)
    probs = mask.float() / torch.clamp_min(
        mask.sum(-1, keepdim=True, dtype=torch.int32), 1)
    while _any((k < k_hi) & (err > bound)):
        grow = (k < k_hi) & (err > bound)
        k_new = k + 1
        splits = prng.split(key)
        key_new, sub = splits[:, 0], splits[:, 1]
        # k_old + 1: seed the extra center with the newest piece
        seeded = _put_rows(c, k, newest)
        # beyond that: random re-init from active pieces
        idx = prng.choice(sub, n_max, k_cap, probs)
        randomed = torch.gather(coords, 1, idx[..., None].expand(-1, -1, 2))
        c_init = torch.where((k_new == k_o + 1)[:, None, None], seeded,
                             randomed)
        c2, lab2, err2 = run(c_init, k_new)
        k, c, lab, err, key = _select_lanes(
            grow, (k_new, c2, lab2, err2, key_new), (k, c, lab, err, key))
    centers_raw = _raw_centers(pieces, mask, lab, k_cap)[0]
    cluster = DigitizerState(pieces, n, lab, centers_raw, k, key)

    stepped = _select_lanes(n <= k_min, trivial, cluster)
    symbol = _take_rows(stepped.labels, n - 1)
    new_state = _select_lanes(live, stepped, state)
    return new_state, torch.where(live, symbol, torch.zeros_like(symbol))


def digitizer_step(state: DigitizerState, piece, *, tol: float, scl: float,
                   k_min: int, k_max_active: int, lloyd_iters: int = 10):
    """One slot ingests one (len, inc) piece; returns ``(state, symbol)``."""
    batched = DigitizerState(*(leaf[None] for leaf in state))
    piece = torch.as_tensor(piece, dtype=torch.float32,
                            device=state.pieces.device)
    live = torch.ones((1,), dtype=torch.bool, device=state.pieces.device)
    st, sym = digitizer_table_step(
        batched, piece[None], live, tol=tol, scl=scl, k_min=k_min,
        k_max_active=k_max_active, lloyd_iters=lloyd_iters)
    return DigitizerState(*(leaf[0] for leaf in st)), sym[0]


def digitizer_delta(prev_n, state: DigitizerState, symbols_online, endpoints):
    """Symbol delta since ``prev_n`` pieces had been digitized, per slot.

    Returns ``(labels, endpoints, n_new)`` padded to ``n_max`` (zeros beyond
    ``n_new``): concatenating the first ``n_new`` entries of every delta
    reproduces ``symbols_online[:n]`` / ``endpoints[:n]``.
    """
    n_max = symbols_online.shape[-1]
    idx = torch.arange(n_max, device=symbols_online.device)
    n_new = (state.n - prev_n).to(torch.int32)
    src = torch.clamp_max(prev_n[..., None] + idx, n_max - 1).long()
    live = idx < n_new[..., None]
    labels = torch.where(live, torch.gather(symbols_online, -1, src),
                         torch.zeros_like(symbols_online))
    ends = torch.where(live, torch.gather(endpoints, -1, src),
                       torch.zeros_like(endpoints))
    return labels.to(torch.int32), ends.to(torch.float32), n_new


def digitize_span_table(state: DigitizerState, lengths, incs, lo, hi, *,
                        tol: float, scl: float, k_min: int, k_max_active: int,
                        lloyd_iters: int = 10, use_kernel: bool = False):
    """Slot-table batch of ``digitize_span``: per-lane spans, shared loop.

    Every lane walks its ``[lo_s, hi_s)`` span of the ``(S, n_max)`` piece
    buffers; the loop runs until every lane drains (trip count = the widest
    span), each trip one ``digitizer_table_step``.  Returns ``(state,
    symbols (S, n_max))`` with symbols 0 outside each span.
    """
    s, n_max = lengths.shape
    dev = lengths.device
    pieces = torch.stack([lengths.float(), incs.float()], dim=-1)
    syms = torch.zeros((s, n_max), dtype=torch.int32, device=dev)
    j = torch.as_tensor(lo, dtype=torch.int32, device=dev).clone()
    hi = torch.as_tensor(hi, dtype=torch.int32, device=dev)
    rows = torch.arange(s, device=dev)
    st = state
    while _any(j < hi):
        live = j < hi
        jc = torch.clamp_max(j, n_max - 1).long()
        st, sym = digitizer_table_step(
            st, pieces[rows, jc], live, tol=tol, scl=scl, k_min=k_min,
            k_max_active=k_max_active, lloyd_iters=lloyd_iters,
            use_kernel=use_kernel)
        syms[rows, jc] = torch.where(live, sym, syms[rows, jc])
        j = torch.where(live, j + 1, j)
    return st, syms


def digitize_span(state: DigitizerState, lengths, incs, lo, hi, *,
                  tol: float, scl: float, k_min: int, k_max_active: int,
                  lloyd_iters: int = 10):
    """One slot ingests buffer slots ``lo <= idx < hi`` (``lengths``/``incs``
    ``(n_max,)``); returns ``(state, symbols (n_max,))``."""
    dev = state.pieces.device
    batched = DigitizerState(*(leaf[None] for leaf in state))
    one = lambda v: torch.as_tensor(v, dtype=torch.int32, device=dev).reshape(1)
    st, syms = digitize_span_table(
        batched, lengths[None], incs[None], one(lo), one(hi), tol=tol,
        scl=scl, k_min=k_min, k_max_active=k_max_active,
        lloyd_iters=lloyd_iters)
    return DigitizerState(*(leaf[0] for leaf in st)), syms[0]


def digitize_pieces(lengths, incs, n_pieces, key, *, k_cap: int = 100,
                    tol: float = 0.5, scl: float = 1.0, k_min: int = 3,
                    k_max_active: int = 100, lloyd_iters: int = 10) -> dict:
    """Run the receiver over one padded piece sequence (``(n_max,)``).

    Returns ``labels``/``centers``/``k``/``state`` of the final state plus
    ``symbols``, the symbol each piece got when it arrived.
    """
    state = digitizer_init(lengths.shape[0], int(k_cap),
                           torch.as_tensor(key, device=lengths.device))
    final, symbols = digitize_span(
        state, lengths, incs, 0, n_pieces, tol=tol, scl=scl, k_min=k_min,
        k_max_active=k_max_active, lloyd_iters=lloyd_iters)
    return {"labels": final.labels, "centers": final.centers, "k": final.k,
            "symbols": symbols, "state": final}

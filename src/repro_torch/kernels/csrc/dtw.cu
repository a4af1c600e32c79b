// Banded DTW distance of equal-length pairs, written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/dtw.py::dtw_pallas.  For every
// pair b it fills the cost matrix
//   D[i, j] = (x_i - y_j)^2 + min(D[i-1, j], D[i, j-1], D[i-1, j-1])
// with the origin's predecessor 0 and every cell outside the grid or the
// Sakoe-Chiba band |i - j| <= r at 1e30, and writes sqrt(D[N-1, N-1]).
//
// What bounds it on this card: per pair the band holds up to N^2 cells of
// five f32 operations (a subtract, a fused multiply-add counted as two, two
// minima) against 8N bytes in and 4 out, so by the roofline it is bound by
// operations (at the monitor's B = 256, N = 2048, full band: 5.4 GFLOP,
// 0.08 ms at the f32 peak).  The cells depend on one another along 2N - 1
// anti-diagonals, so the chain of dependent tiles below is the latency
// floor.
//
// The design: a tiled wavefront.  The N x N matrix is cut into tiles of
// kTileRows = 32 * kRows rows by kCols columns (256 by 128).  One CTA runs
// one pair (grid = B) with up to kWarps warps; a warp sweeps a whole tile
// alone.  Inside a tile lane l owns the kRows rows i0 + l * kRows + t and
// holds their x in registers; it sweeps the tile's columns staggered by one
// step per lane, so at step s it computes column s - l, its rows top to
// bottom.  It gets D[i-1, j] of its first row from lane l - 1 with one
// __shfl_up_sync (lane 0 from the tile above), D[i-1, j-1] is what it got
// the step before (lane 0: the corner, then the tile above), and D[i, j-1]
// is its own previous value.  No block barrier inside a tile.  The tiles of
// one tile-anti-diagonal are independent: the warps take them round-robin,
// with one __syncthreads() per tile-anti-diagonal, ceil(N / kTileRows) +
// ceil(N / kCols) - 1 in all (23 at N = 2048) where the cell wavefront
// needs 2N - 1 (4095).  Tiles pass their boundaries through three buffers:
// `top` holds per column the bottom row of the last tile above, `left` per
// row the right column of the last tile to the left, and `corner` each
// tile's bottom-right cell in a slot chosen by its tile-diagonal modulo 3
// (the tile that reads a corner runs two tile-diagonals after the one that
// wrote it, and in between the tile to its left has overwritten that cell
// in `top`).
//
// Against the four faults of the cell wavefront that came before: 4095
// barriers become 23; x and y are staged once in shared memory, and each
// step's loads are issued a step ahead, so no load sits on the chain; every
// lane of a tile is busy but in its fill and drain (kCols of kCols + 31
// steps), and the steps in between test nothing per lane; and a tile with
// no cell in the band is never visited: its boundaries are then read as
// exactly 1e30, which they are, and the band test of each cell runs only
// in tiles that the band cuts.  The tile shape and warp count were chosen
// by timing 256 x 2048 at full band and at band 64 (PERF.md).
//
// Shared memory holds x, y, `top`, `left` and the corners, 16 bytes per
// point, while that fits in the 227 KB a block may use (up to 14,485
// points); past it the same code runs over x and y in global memory and a
// global scratch of (B, 2 N + 3 P) floats that the wrapper allocates, so no
// stream length is refused.
//
// Each cell rounds x - y with __fsub_rn and then diff * diff + best once
// with __fmaf_rn, as the plain PyTorch version's fma32 does.  best is the
// minimum of the three predecessors, taken as min(up, min(left, diag)) so
// that min(left, diag) is off the chain; the minimum is exact and, with
// min.NaN (any NaN operand gives NaN, as torch.minimum), does not depend on
// the order for the values this recurrence makes (never -0).  So the kernel
// is bitwise equal to repro_torch.core.metrics.dtw_ref.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr float kBig = 1e30f;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kLanes = 32;
constexpr int kRows = 8;  // rows a lane owns in a tile
constexpr int kTileRows = kLanes * kRows;
constexpr int kCols = 128;  // columns of a tile
constexpr int kWarps = 8;  // most warps a CTA runs

// torch.minimum: NaN if either operand is NaN, else the smaller
__device__ __forceinline__ float min_nan(float a, float b) {
  float m;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

// Tile (p, q) holds a cell with |i - j| <= r (its bounds unclipped by N)
__device__ __forceinline__ bool tile_in_band(int p, int q, int r) {
  const int i0 = p * kTileRows;
  const int j0 = q * kCols;
  return i0 - (j0 + kCols - 1) <= r && j0 - (i0 + kTileRows - 1) <= r;
}

struct Buffers {
  const float* x;  // (n,) this pair's x
  const float* y;  // (n,) this pair's y
  float* top;      // (n,) per column: the bottom row of the last tile above
  float* left;     // (n,) per row: the right column of the last tile left
  float* corner;   // (P, 3) per tile row: bottom-right cells, by k % 3
};

// One warp sweeps tile (p, q) of tile-diagonal k = p + q.  The steps have
// no branch: every lane computes a column each step and keeps it only when
// the column is its own, and the loads of the next step are issued before
// this step's chain of minima and multiply-adds.
template <bool kBanded>
__device__ __forceinline__ void sweep_tile(const Buffers& s, int n, int r,
                                           int p, int q, int k, int lane) {
  const int i0 = p * kTileRows;
  const int j0 = q * kCols;
  const int row = i0 + lane * kRows;  // this lane's first row
  // a neighbour that has no cell in the band was never visited: its
  // boundary cells are out of the band, exactly 1e30
  const bool has_left = q > 0 && tile_in_band(p, q - 1, r);
  const bool has_top = p > 0 && tile_in_band(p - 1, q, r);
  float xr[kRows];
  float cur[kRows];  // D[row + t, j - 1]: the left boundary, then own cells
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    const bool in = row + t < n;
    xr[t] = in ? s.x[row + t] : 0.f;
    cur[t] = in && has_left ? s.left[row + t] : kBig;
  }
  // D[row - 1, j - 1] for the next column: lane 0 starts at the corner
  float up_prev = kBig;
  if (p == 0 && q == 0) {
    up_prev = 0.f;  // the origin's predecessor
  } else if (p > 0 && q > 0 && tile_in_band(p - 1, q - 1, r)) {
    up_prev = s.corner[3 * (p - 1) + (k + 1) % 3];
  }
  const int last = min(kCols, n - j0) - 1;  // the tile's last column
  // lanes that own a row of the grid; the last of them ends the sweep
  const int live = min(kLanes, (n - i0 + kRows - 1) / kRows);
  const int steps = last + live;
  // a lane before or past its columns reads an edge column and drops it
  float y_next = s.y[j0 + min(max(-lane, 0), last)];
  float top_next = s.top[j0];  // used by lane 0 only when has_top
  // one step; kEdge: some lane may be before or past its columns
  auto step = [&](int st, auto edge) {
    constexpr bool kEdge = decltype(edge)::value;
    const float yj = y_next;
    const float top = top_next;
    y_next = s.y[j0 + min(max(st + 1 - lane, 0), last)];
    top_next = s.top[j0 + min(st + 1, last)];
    float up = __shfl_up_sync(kAll, cur[kRows - 1], 1);
    if (lane == 0) up = has_top && (!kEdge || st <= last) ? top : kBig;
    const int c = st - lane;
    const bool own = !kEdge || (c >= 0 && c <= last);
    float diag = up_prev;
    float u = up;
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const float diff = __fsub_rn(xr[t], yj);
      float v = __fmaf_rn(diff, diff, min_nan(u, min_nan(cur[t], diag)));
      if (kBanded && abs(row + t - j0 - c) > r) v = kBig;
      diag = cur[t];
      if (own) cur[t] = v;
      u = v;
    }
    // lane 0 read this column of `top` 31 steps ago
    if (own && lane == kLanes - 1) s.top[j0 + c] = cur[kRows - 1];
    up_prev = up;
  };
  // fill (lanes still to reach column 0), the steady middle where every
  // lane is on a column of the tile, and the drain
  int st = 0;
  for (; st < min(kLanes - 1, steps); ++st) step(st, std::true_type{});
  for (; st <= last; ++st) step(st, std::false_type{});
  for (; st < steps; ++st) step(st, std::true_type{});
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    if (row + t < n) s.left[row + t] = cur[t];
  }
  // read only by tile (p + 1, q + 1), which exists only when this tile is
  // whole, so that lane 31 ended on the tile's last column
  if (lane == kLanes - 1) s.corner[3 * p + k % 3] = cur[kRows - 1];
}

// The buffers in shared memory (kSmem) or in the global scratch: two
// instantiations, so that the shared one addresses shared memory directly.
template <bool kSmem>
__global__ void __launch_bounds__(kWarps * kLanes)
dtw_kernel(const float* __restrict__ x, const float* __restrict__ y,
           float* __restrict__ out,
           float* scratch,  // (B, 2 n + 3 P) when not in shared memory
           int n, int r) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int warps = blockDim.x / kLanes;
  const int n_p = (n + kTileRows - 1) / kTileRows;
  const int n_q = (n + kCols - 1) / kCols;
  const float* xb = x + static_cast<size_t>(b) * n;
  const float* yb = y + static_cast<size_t>(b) * n;

  Buffers s;
  if constexpr (kSmem) {
    float* smem = reinterpret_cast<float*>(smem4);
    float* xs = smem;
    float* ys = smem + n;
    const bool vec = n % 4 == 0 &&
        ((reinterpret_cast<uintptr_t>(xb) | reinterpret_cast<uintptr_t>(yb))
         & 15) == 0;
    if (vec) {  // 16-byte coalesced loads
      for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
        reinterpret_cast<float4*>(xs)[i] =
            reinterpret_cast<const float4*>(xb)[i];
        reinterpret_cast<float4*>(ys)[i] =
            reinterpret_cast<const float4*>(yb)[i];
      }
    } else {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        xs[i] = xb[i];
        ys[i] = yb[i];
      }
    }
    s = {xs, ys, smem + 2 * n, smem + 3 * n, smem + 4 * n};
    __syncthreads();
  } else {
    float* sc = scratch + static_cast<size_t>(b) * (2 * n + 3 * n_p);
    s = {xb, yb, sc, sc + n, sc + 2 * n};
  }

  const int span = kTileRows + kCols;
  for (int k = 0; k < n_p + n_q - 1; ++k) {
    // the tiles (p, k - p) with a cell in the band: those with
    // kTileRows p - (kCols (k - p) + kCols - 1) <= r and
    // kCols (k - p) - (kTileRows p + kTileRows - 1) <= r
    int p_lo = max(0, k - n_q + 1);
    const int p_hi = min(min(n_p - 1, k), (r + (k + 1) * kCols - 1) / span);
    const int need = k * kCols - kTileRows + 1 - r;
    if (need > 0) p_lo = max(p_lo, (need + span - 1) / span);
    for (int p = p_lo + warp; p <= p_hi; p += warps) {
      const int q = k - p;
      const int i0 = p * kTileRows;
      const int j0 = q * kCols;
      if (i0 + kTileRows - 1 - j0 <= r && j0 + kCols - 1 - i0 <= r) {
        sweep_tile<false>(s, n, r, p, q, k, lane);  // wholly in the band
      } else {
        sweep_tile<true>(s, n, r, p, q, k, lane);
      }
    }
    __syncthreads();
  }
  // the last tile wrote D[n - 1, n - 1] into `left`
  if (threadIdx.x == 0) out[b] = __fsqrt_rn(s.left[n - 1]);
}

int tile_rows_of(int n) { return (n + kTileRows - 1) / kTileRows; }

}  // namespace

// Floats of global scratch one pair of length n needs when its buffers do
// not fit in shared memory: `top`, `left` and the corners.
extern "C" size_t dtw_scratch_floats(int n) {
  return 2 * static_cast<size_t>(n) + 3 * static_cast<size_t>(tile_rows_of(n));
}

// Shared-memory bytes one pair of length n needs (x, y and the buffers), or
// 0 when they do not fit and the caller must pass a global scratch.
extern "C" size_t dtw_smem_bytes(int n) {
  const size_t bytes =
      sizeof(float) * (2 * static_cast<size_t>(n) + dtw_scratch_floats(n));
  return bytes <= kMaxSmem ? bytes : 0;
}

// C entry point, bound with ctypes.  Pointers are device pointers of
// contiguous tensors: x, y (b, n) f32, out (b,) f32, scratch
// (b, dtw_scratch_floats(n)) f32 or null when dtw_smem_bytes(n) is not 0.
// r is the band radius (>= 0).  Returns cudaGetLastError() after the launch.
extern "C" int dtw_launch(const void* x, const void* y, void* out,
                          void* scratch, int b, int n, int r, void* stream) {
  if (b <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = dtw_smem_bytes(n);
  if (smem == 0 && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // no tile-diagonal holds more than min(P, Q) tiles
  const int n_q = (n + kCols - 1) / kCols;
  const int threads =
      kLanes * std::min(kWarps, std::min(tile_rows_of(n), n_q));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float* of = static_cast<float*>(out);
  r = std::min(r, n);
  if (smem == 0) {
    dtw_kernel<false><<<b, threads, 0, st>>>(
        xf, yf, of, static_cast<float*>(scratch), n, r);
    return static_cast<int>(cudaGetLastError());
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dtw_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dtw_kernel<true><<<b, threads, smem, st>>>(xf, yf, of, nullptr, n, r);
  return static_cast<int>(cudaGetLastError());
}

// EWMA / EWMV scan of a batch of streams, written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ewma.py::ewma_scan_pallas.  For
// every row of ts (B, T) it computes the paper's damped-window mean and
// variance (SymED Eq. 1-2), with a = f32(alpha) and b = f32(1 - alpha):
//   m_0 = t_0,  m_j = fma(a, t_j, b * m_{j-1})
//   v_0 = 1,    v_j = fma(b, v_{j-1}, (d_j * d_j) * a),  d_j = t_j - m_j
// which is, step for step, the plain PyTorch version
// repro_torch.core.normalize.ewm_scan (ewm_step's batched form).
//
// What bounds it on this card: per point it reads 4 bytes and writes 8 and
// does about 8 f32 operations, so by the roofline it is bound by bytes (at
// the fleet slab B = 256, T = 2048: 6.29 MB, 1.88 us at 3.35 TB/s).  The
// recurrence is a chain of T dependent steps per row, which a thread per
// row would walk alone.
//
// What the design does about it: each step is an affine map x -> A x + B,
// and maps compose, (A2, B2) o (A1, B1) = (A2 A1, A2 B1 + B2), so a warp
// scans them in parallel.  One warp per row (kRowsPerBlock rows per CTA)
// walks T in tiles of 32 * kPerLane points; each lane owns kPerLane
// consecutive points of a tile.  The mean pass composes each lane's local
// map, runs a five-step __shfl_up_sync inclusive scan of the maps across
// the warp, applies the exclusive prefix to the tile's carry-in to get the
// lane's start value, and then walks its points again with the plain
// version's exact step, keeping the means in registers.  The variance pass
// does the same over d = t - m.  Lane 31's last values carry into the next
// tile.  Unlike the TPU kernel's closed form over powers a^-i (valid for
// alpha <= 0.2 only), this multiplies only by powers of b <= 1, so every
// alpha in (0, 1] works.  The result differs from the plain version only
// by the rounding of the composed carries at lane and tile boundaries, so
// it is held to tolerance, not bitwise.  Point 0 is an identity step: its
// mean is t_0 and its variance 1.0 exactly.  No atomics: two calls give the
// same bits.  Loads and stores are scalar (no alignment of T is assumed);
// coalescing through shared memory and several tiles in flight are later
// work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kPerLane = 8;                // L points per lane
constexpr int kTile = kWarp * kPerLane;    // 256 points per tile
constexpr int kRowsPerBlock = 4;           // one warp per row
constexpr unsigned kFull = 0xffffffffu;

// Inclusive scan of the lanes' maps: afterwards lane l holds the map of
// lanes 0..l applied in order (lane l's own last).
__device__ __forceinline__ void scan_maps(float& A, float& B, int lane) {
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const float A0 = __shfl_up_sync(kFull, A, off);
    const float B0 = __shfl_up_sync(kFull, B, off);
    if (lane >= off) {  // (A, B) o (A0, B0): x -> A (A0 x + B0) + B
      B = __fmaf_rn(A, B0, B);
      A = __fmul_rn(A, A0);
    }
  }
}

// The value before the lane's first point: the maps of the lanes before it
// (the exclusive prefix) applied to the tile's carry-in.
__device__ __forceinline__ float start_value(float A, float B, float carry,
                                             int lane) {
  const float Ae = __shfl_up_sync(kFull, A, 1);
  const float Be = __shfl_up_sync(kFull, B, 1);
  return lane == 0 ? carry : __fmaf_rn(Ae, carry, Be);
}

__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
ewma_kernel(const float* __restrict__ ts, float* __restrict__ means,
            float* __restrict__ vars, int rows, int n, float a, float b) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;  // the whole warp leaves together
  const size_t base = static_cast<size_t>(row) * n;
  const float* t_row = ts + base;
  float* m_row = means + base;
  float* v_row = vars + base;

  // the paper's initialization: the carries enter point 0 as (t_0, 1.0)
  float carry_m = t_row[0];
  float carry_v = 1.f;

  for (int tile = 0; tile < n; tile += kTile) {
    const int j0 = tile + lane * kPerLane;
    float t[kPerLane];
    float m[kPerLane];
    float v[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      t[k] = j0 + k < n ? t_row[j0 + k] : 0.f;
    }

    // mean pass; point 0 and points past T are identity steps
    float A = 1.f, B = 0.f;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int j = j0 + k;
      if (j > 0 && j < n) {
        B = __fmaf_rn(a, t[k], __fmul_rn(b, B));
        A = __fmul_rn(b, A);
      }
    }
    scan_maps(A, B, lane);
    float x = start_value(A, B, carry_m, lane);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int j = j0 + k;
      if (j > 0 && j < n) x = __fmaf_rn(a, t[k], __fmul_rn(b, x));
      m[k] = x;
    }
    carry_m = __shfl_sync(kFull, x, kWarp - 1);

    // variance pass over d = t - m
    A = 1.f;
    B = 0.f;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int j = j0 + k;
      const float d = __fsub_rn(t[k], m[k]);
      t[k] = __fmul_rn(__fmul_rn(d, d), a);  // t is not needed any more
      if (j > 0 && j < n) {
        B = __fmaf_rn(b, B, t[k]);
        A = __fmul_rn(b, A);
      }
    }
    scan_maps(A, B, lane);
    x = start_value(A, B, carry_v, lane);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int j = j0 + k;
      if (j > 0 && j < n) x = __fmaf_rn(b, x, t[k]);
      v[k] = x;
    }
    carry_v = __shfl_sync(kFull, x, kWarp - 1);

#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      if (j0 + k < n) {
        m_row[j0 + k] = m[k];
        v_row[j0 + k] = v[k];
      }
    }
  }
}

}  // namespace

// C entry point, bound with ctypes.  Pointers are device pointers of
// contiguous tensors: ts, means, vars (b, t) f32.  a = f32(alpha) and
// bb = f32(1 - alpha), rounded by the caller as ewm_step rounds them.
// Returns cudaGetLastError() after the launch.
extern "C" int ewma_launch(const void* ts, void* means, void* vars, int b,
                           int t, float a, float bb, void* stream) {
  if (b <= 0 || t <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (b + kRowsPerBlock - 1) / kRowsPerBlock;
  ewma_kernel<<<blocks, kWarp * kRowsPerBlock, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ts), static_cast<float*>(means),
      static_cast<float*>(vars), b, t, a, bb);
  return static_cast<int>(cudaGetLastError());
}

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
// recurrence is a chain of T dependent steps per row; what a kernel can do
// about that chain is to break it into short pieces that run at once and to
// have every byte of a row in flight before it needs it.
//
// What the design does about it: each step is an affine map x -> A x + B,
// and maps compose, (A2, B2) o (A1, B1) = (A2 A1, A2 B1 + B2), so the chain
// is scanned in parallel at two levels.  One CTA of kWarps warps owns a row
// and walks it in chunks of kChunk points (2048: the whole row at the
// fleet's T in one chunk).  Warp w owns kSeg consecutive points of the
// chunk and lane l kPerLane consecutive points of the warp's segment.
//   1. The chunk arrives in shared memory by cp.async, 16 bytes per copy
//      with neighbouring threads on neighbouring addresses where the rows
//      are 16-byte aligned (T % 4 == 0 and aligned pointers), 4 bytes per
//      copy otherwise; the next chunk's copies are issued before this
//      chunk's scan (two buffers), so a long row's loads stay in flight.
//   2. The mean pass: each lane composes its points' maps; a five-step
//      __shfl_up_sync inclusive scan composes the lanes' maps across the
//      warp; lane 31 publishes the warp's map in shared memory; after one
//      barrier each warp applies the maps of the warps before it, in warp
//      order, to the chunk's carry-in, which gives the warp's start value;
//      lane l applies lane l-1's inclusive map to that; and then each lane
//      walks its points again with the plain version's exact step.  The
//      variance pass does the same over q = (t - m)^2 a.
//   3. The means and vars go back through shared memory, and leave in the
//      same coalesced pattern as the loads came in.  The chunk's last mean
//      and var are the next chunk's carries.
// Four block barriers per chunk: one after the loads, one per pass for the
// warps' maps, one before the stores.  Points 0 and past T are identity
// steps, so a warp whose segment lies wholly past T publishes (1, 0).
// Unlike the TPU kernel's closed form over powers a^-i (valid for alpha <=
// 0.2 only), only powers of b <= 1 are multiplied, so every alpha in (0, 1]
// works.  The result differs from the plain version only by the rounding
// of the composed carries at lane, warp and chunk boundaries, so it is held
// to tolerance, not bitwise; tests/test_torch_ewma.py replays this order on
// the CPU bit for bit.  Point 0 keeps t_0 and 1.0 exactly.  No atomics, and
// the composition order is fixed: two calls give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kPerLane = 8;                 // points per lane
constexpr int kWarps = 8;                   // warps per CTA
constexpr int kSeg = kWarp * kPerLane;      // 256 points per warp
constexpr int kChunk = kSeg * kWarps;       // 2048 points per chunk
constexpr int kThreads = kWarp * kWarps;    // 256
constexpr unsigned kFull = 0xffffffffu;
static_assert(kPerLane % 4 == 0, "a lane's points are read as float4s");
static_assert(kChunk % (4 * kThreads) == 0, "whole float4 copies per thread");

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Issue the copies of points [c0, c0 + kChunk) of a row into dst, as one
// cp.async group; points past n are written as 0 (they are identity steps).
// vec: 16-byte copies, which needs n % 4 == 0 and a 16-byte aligned row.
__device__ __forceinline__ void stage(float* dst, const float* row, int c0,
                                      int n, bool vec) {
  if (vec) {
#pragma unroll
    for (int r = 0; r < kChunk / 4 / kThreads; ++r) {
      const int f = threadIdx.x + r * kThreads;
      const int j = c0 + 4 * f;
      if (j < n) {
        cp_async16(dst + 4 * f, row + j);
      } else {
        *reinterpret_cast<float4*>(dst + 4 * f) = make_float4(0.f, 0.f, 0.f,
                                                              0.f);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kChunk / kThreads; ++r) {
      const int i = threadIdx.x + r * kThreads;
      if (c0 + i < n) {
        cp_async4(dst + i, row + c0 + i);
      } else {
        dst[i] = 0.f;
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

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

// The value before the lane's first point, from its inclusive map (A, B):
// lane 31 publishes the warp's map in (agg_a, agg_b); after a barrier the
// warp applies the maps of the warps before it, in warp order, to the
// chunk's carry-in; lane l > 0 then applies lane l-1's inclusive map.
// Every thread of the block calls it (it holds a __syncthreads()).
__device__ __forceinline__ float start_value(float A, float B, float carry,
                                             float* agg_a, float* agg_b,
                                             int warp, int lane) {
  if (lane == kWarp - 1) {
    agg_a[warp] = A;
    agg_b[warp] = B;
  }
  const float Ae = __shfl_up_sync(kFull, A, 1);
  const float Be = __shfl_up_sync(kFull, B, 1);
  __syncthreads();
  float x = carry;
#pragma unroll
  for (int u = 0; u < kWarps - 1; ++u) {
    if (u < warp) x = __fmaf_rn(agg_a[u], x, agg_b[u]);
  }
  return lane == 0 ? x : __fmaf_rn(Ae, x, Be);
}

__device__ __forceinline__ void load_lane(float (&x)[kPerLane],
                                          const float* src) {
#pragma unroll
  for (int k = 0; k < kPerLane; k += 4) {
    const float4 q = *reinterpret_cast<const float4*>(src + k);
    x[k] = q.x;
    x[k + 1] = q.y;
    x[k + 2] = q.z;
    x[k + 3] = q.w;
  }
}

__device__ __forceinline__ void store_lane(float* dst,
                                           const float (&x)[kPerLane]) {
#pragma unroll
  for (int k = 0; k < kPerLane; k += 4) {
    *reinterpret_cast<float4*>(dst + k) =
        make_float4(x[k], x[k + 1], x[k + 2], x[k + 3]);
  }
}

// One CTA per row.  vec: the rows are 16-byte aligned (see stage()).
__global__ void __launch_bounds__(kThreads)
ewma_kernel(const float* __restrict__ ts, float* __restrict__ means,
            float* __restrict__ vars, int n, float a, float b, int vec) {
  __shared__ __align__(16) float t_s[2][kChunk];
  __shared__ __align__(16) float m_s[kChunk];
  __shared__ __align__(16) float v_s[kChunk];
  __shared__ float agg[4][kWarps];  // the warps' maps: mean A, B; var A, B

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int own = warp * kSeg + lane * kPerLane;  // lane's first point
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const float* t_row = ts + base;
  float* m_row = means + base;
  float* v_row = vars + base;

  stage(t_s[0], t_row, 0, n, vec);
  // the paper's initialization: the carries enter point 0 as (t_0, 1.0)
  float carry_m = 0.f;
  float carry_v = 1.f;
  for (int c0 = 0, buf = 0; c0 < n; c0 += kChunk, buf ^= 1) {
    if (c0 + kChunk < n) {  // the next chunk's loads go out first
      stage(t_s[buf ^ 1], t_row, c0 + kChunk, n, vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (c0 == 0) carry_m = t_s[0][0];

    float t[kPerLane];
    float m[kPerLane];
    float v[kPerLane];
    load_lane(t, t_s[buf] + own);
    const int j0 = c0 + own;

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
    float x = start_value(A, B, carry_m, agg[0], agg[1], warp, lane);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int j = j0 + k;
      if (j > 0 && j < n) x = __fmaf_rn(a, t[k], __fmul_rn(b, x));
      m[k] = x;
    }

    // variance pass over q = (t - m)^2 a
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
    x = start_value(A, B, carry_v, agg[2], agg[3], warp, lane);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int j = j0 + k;
      if (j > 0 && j < n) x = __fmaf_rn(b, x, t[k]);
      v[k] = x;
    }

    store_lane(m_s + own, m);
    store_lane(v_s + own, v);
    __syncthreads();
    carry_m = m_s[kChunk - 1];  // read only when a next (full) chunk exists
    carry_v = v_s[kChunk - 1];
    if (vec) {
#pragma unroll
      for (int r = 0; r < kChunk / 4 / kThreads; ++r) {
        const int f = threadIdx.x + r * kThreads;
        const int j = c0 + 4 * f;
        if (j < n) {
          *reinterpret_cast<float4*>(m_row + j) =
              *reinterpret_cast<const float4*>(m_s + 4 * f);
          *reinterpret_cast<float4*>(v_row + j) =
              *reinterpret_cast<const float4*>(v_s + 4 * f);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < kChunk / kThreads; ++r) {
        const int i = threadIdx.x + r * kThreads;
        if (c0 + i < n) {
          m_row[c0 + i] = m_s[i];
          v_row[c0 + i] = v_s[i];
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// C entry point, bound with ctypes.  Pointers are device pointers of
// contiguous tensors: ts, means, vars (b, t) f32.  a = f32(alpha) and
// bb = f32(1 - alpha), rounded by the caller as ewm_step rounds them.
// Returns cudaGetLastError() after the launch.
extern "C" int ewma_launch(const void* ts, void* means, void* vars, int b,
                           int t, float a, float bb, void* stream) {
  if (b <= 0 || t <= 0) return static_cast<int>(cudaSuccess);
  const bool vec = t % 4 == 0 && aligned16(ts) && aligned16(means) &&
                   aligned16(vars);
  ewma_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ts), static_cast<float*>(means),
      static_cast<float*>(vars), t, a, bb, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

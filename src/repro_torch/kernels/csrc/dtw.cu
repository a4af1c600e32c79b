// Banded DTW distance of equal-length pairs, written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/dtw.py::dtw_pallas.  For every
// pair b it fills the cost matrix
//   D[i, j] = (x_i - y_j)^2 + min(D[i-1, j], D[i, j-1], D[i-1, j-1])
// one anti-diagonal d = i + j at a time (2N - 1 of them), with the origin's
// predecessor 0, every cell outside the grid or the Sakoe-Chiba band
// |i - j| <= r at 1e30, and writes sqrt(D[N-1, N-1]).
//
// What bounds it on this card: per pair the work is N^2 cells of five f32
// operations (a subtract, a fused multiply-add counted as two, two minima)
// against 8N bytes in and 4 out, so by the roofline it is bound
// by operations (at the monitor's B = 256, N = 2048: 5.4 GFLOP, 0.08 ms at
// the f32 peak).  In practice the 2N - 1 diagonals depend on one another: a
// pair is a chain of 4095 steps, each a block-wide barrier, and that
// latency, not the roofline, sets the time.
//
// What the design does about it: one CTA per pair (grid = B), so the pairs
// run side by side on all SMs and no step ever waits on another CTA.  Each
// thread owns the cells i = tid, tid + blockDim, ... of every diagonal, and
// one __syncthreads() separates two diagonals.  Three rotating diagonal
// buffers of N floats (d - 2, d - 1, d) live in dynamic shared memory while
// 3 N floats fit in the 227 KB a block may use, and otherwise in a global
// scratch of (B, 3, N) floats that the wrapper allocates: the same code over
// another pointer, so no stream length is refused.  Each cell is computed in
// the plain PyTorch version's order with explicit round-to-nearest
// intrinsics: __fsub_rn for x - y, then one __fmaf_rn for diff * diff +
// best (the reference's compiled program fuses that multiply-add in most
// cells, and the plain version's fma32 rounds it once in all), with a
// NaN-propagating min as
// torch.minimum: the kernel is bitwise equal to
// repro_torch.core.metrics.dtw_ref.  Tiling a
// diagonal per warp, skipping the cells outside the band and packing
// several short pairs per CTA are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;
constexpr size_t kMaxSmem = 227 * 1024;

// torch.minimum: NaN if either operand is NaN, else the smaller
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

__global__ void __launch_bounds__(1024)
dtw_kernel(const float* __restrict__ x, const float* __restrict__ y,
           float* __restrict__ out,
           float* scratch,  // (B, 3, n) when not in shared memory
           int n, int r, int use_smem) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* xb = x + static_cast<size_t>(b) * n;
  const float* yb = y + static_cast<size_t>(b) * n;
  float* diag = use_smem ? smem : scratch + static_cast<size_t>(b) * 3 * n;
  float* prev2 = diag;
  float* prev = diag + n;
  float* cur = diag + 2 * n;

  for (int i = tid; i < 2 * n; i += nt) diag[i] = kBig;
  __syncthreads();

  for (int d = 0; d < 2 * n - 1; ++d) {
    for (int i = tid; i < n; i += nt) {
      const int j = d - i;
      float v = kBig;
      if (j >= 0 && j < n && abs(i - j) <= r) {
        const float diff = __fsub_rn(xb[i], yb[j]);
        float best;
        if (d == 0) {
          best = 0.f;  // the origin (i = j = 0) has no predecessor
        } else {
          const float left = i > 0 ? prev[i - 1] : kBig;
          const float diag_prev = i > 0 ? prev2[i - 1] : kBig;
          best = min_nan(min_nan(left, prev[i]), diag_prev);
        }
        v = __fmaf_rn(diff, diff, best);
      }
      cur[i] = v;
    }
    __syncthreads();
    float* t = prev2;
    prev2 = prev;
    prev = cur;
    cur = t;
  }
  // the last diagonal (d = 2n - 2) is now ``prev``; its cell n - 1 was
  // written by the thread that owns i = n - 1
  if ((n - 1) % nt == tid) out[b] = __fsqrt_rn(prev[n - 1]);
}

}  // namespace

// Shared-memory bytes one pair of length n needs, or 0 when its three
// diagonals do not fit and the caller must pass a global scratch.
extern "C" size_t dtw_smem_bytes(int n) {
  const size_t bytes = 3 * sizeof(float) * static_cast<size_t>(n);
  return bytes <= kMaxSmem ? bytes : 0;
}

// C entry point, bound with ctypes.  Pointers are device pointers of
// contiguous tensors: x, y (b, n) f32, out (b,) f32, scratch (b, 3, n) f32
// or null when dtw_smem_bytes(n) is not 0.  r is the band radius (>= 0).
// Returns cudaGetLastError() after the launch.
extern "C" int dtw_launch(const void* x, const void* y, void* out,
                          void* scratch, int b, int n, int r, void* stream) {
  if (b <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = dtw_smem_bytes(n);
  if (smem == 0 && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dtw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = n < 1024 ? (n + 31) / 32 * 32 : 1024;
  dtw_kernel<<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), static_cast<float*>(scratch), n, r,
      smem != 0 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

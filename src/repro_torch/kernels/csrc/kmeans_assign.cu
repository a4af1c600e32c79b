// Fused k-means assign half-step for a table of independent clustering
// problems, written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/kmeans.py::kmeans_assign_pallas.
// For every slot s it computes
//   d[n, j]   = max(|x_n|^2 - 2 x_n.c_j + |c_j|^2, 0), 1e30 for inactive c_j
//   labels[n] = argmin_j d[n, j] (first index on ties), 0 on masked rows
//   sums[j]   = sum of x_n over unmasked rows labelled j, counts[j] likewise.
//
// What bounds it on this card: at the service's shapes (N = 512 pieces,
// D = 2, K = 100 centers per slot) one call moves a few MB and does about
// 0.1 GFLOP of f32 work, i.e. a few microseconds at peak.  D = 2 leaves
// nothing for the tensor cores, and the launch itself costs about as much as
// the work: the launch count (lloyd_iters launches per k-means call) sets
// the time, not bytes or FLOPs.
//
// What the design does about it: one CTA per slot (grid = S) keeps the
// whole problem of a slot on one SM with its centers in shared memory, so
// a launch needs no second pass and no atomics; N is walked in tiles inside
// the block (the TPU's sequential N-tile grid axis).  One thread per piece
// computes the distances and the argmin, with the arithmetic of the plain
// PyTorch version spelled out in round-to-nearest intrinsics so that nvcc
// cannot contract it differently.  The per-cluster sums and counts are then
// reduced deterministically: each (cluster, dim) pair is owned by one
// thread, which adds the tile's pieces in row order.  Results are identical
// from run to run.  Fusing the Lloyd loop into one launch is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 1e30f;

// sum_e a[e] * b[e] as the plain version rounds it: the first product on
// its own, every further term fused into the running sum.
__device__ __forceinline__ float dot_chain(const float* a, const float* b,
                                           int d) {
  float acc = __fmul_rn(a[0], b[0]);
  for (int e = 1; e < d; ++e) acc = __fmaf_rn(a[e], b[e], acc);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
kmeans_assign_kernel(const float* __restrict__ x,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ centers,
                     const uint8_t* __restrict__ active,
                     int32_t* __restrict__ labels,
                     float* __restrict__ sums,
                     float* __restrict__ counts,
                     int n, int d, int k) {
  extern __shared__ float smem[];
  float* c_sh = smem;                       // k * d centers
  float* acc_sh = c_sh + k * d;             // k * d running sums
  float* c2_sh = acc_sh + k * d;            // k     |c_j|^2
  float* cnt_sh = c2_sh + k;                // k     running counts
  int* lab_sh = reinterpret_cast<int*>(cnt_sh + k);         // kThreads
  uint8_t* act_sh = reinterpret_cast<uint8_t*>(lab_sh + kThreads);  // k

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const float* xs = x + static_cast<size_t>(s) * n * d;
  const uint8_t* ms = mask + static_cast<size_t>(s) * n;
  const float* cs = centers + static_cast<size_t>(s) * k * d;
  int32_t* ls = labels + static_cast<size_t>(s) * n;

  for (int i = tid; i < k * d; i += kThreads) {
    c_sh[i] = cs[i];
    acc_sh[i] = 0.f;
  }
  for (int j = tid; j < k; j += kThreads) {
    act_sh[j] = active[static_cast<size_t>(s) * k + j];
    cnt_sh[j] = 0.f;
  }
  __syncthreads();
  for (int j = tid; j < k; j += kThreads) {
    c2_sh[j] = dot_chain(c_sh + j * d, c_sh + j * d, d);
  }
  __syncthreads();

  for (int base = 0; base < n; base += kThreads) {
    const int i = base + tid;
    int lab = -1;
    if (i < n) {
      const float* xi = xs + static_cast<size_t>(i) * d;
      const float x2 = dot_chain(xi, xi, d);
      float best = INFINITY;
      int arg = 0;
      for (int j = 0; j < k; ++j) {
        float dist = kBig;
        if (act_sh[j]) {
          const float cross = dot_chain(xi, c_sh + j * d, d);
          dist = __fadd_rn(__fsub_rn(x2, __fmul_rn(2.f, cross)), c2_sh[j]);
          dist = fmaxf(dist, 0.f);
        }
        if (dist < best) {  // strict: the first index wins ties
          best = dist;
          arg = j;
        }
      }
      const bool valid = ms[i] != 0;
      ls[i] = valid ? arg : 0;
      lab = valid ? arg : -1;
    }
    lab_sh[tid] = lab;
    __syncthreads();

    const int len = min(kThreads, n - base);
    for (int p = tid; p < k * d; p += kThreads) {
      const int j = p / d;
      const int e = p - j * d;
      float acc = acc_sh[p];
      float cnt = 0.f;
      for (int t = 0; t < len; ++t) {
        if (lab_sh[t] == j) {
          acc = __fadd_rn(acc, xs[static_cast<size_t>(base + t) * d + e]);
          cnt += 1.f;
        }
      }
      acc_sh[p] = acc;
      if (e == 0) cnt_sh[j] += cnt;
    }
    __syncthreads();
  }

  for (int i = tid; i < k * d; i += kThreads) {
    sums[static_cast<size_t>(s) * k * d + i] = acc_sh[i];
  }
  for (int j = tid; j < k; j += kThreads) {
    counts[static_cast<size_t>(s) * k + j] = cnt_sh[j];
  }
}

size_t smem_bytes(int d, int k) {
  return sizeof(float) * (2 * static_cast<size_t>(k) * d + 2 * k)
         + sizeof(int) * kThreads + static_cast<size_t>(k);
}

}  // namespace

// C entry point, bound with ctypes.  Pointers are device pointers of
// contiguous tensors: x (s, n, d) f32, mask (s, n) bool, centers (s, k, d)
// f32, active (s, k) bool; outputs labels (s, n) i32, sums (s, k, d) f32,
// counts (s, k) f32.  Returns cudaGetLastError() after the launch.
extern "C" int kmeans_assign_launch(const void* x, const void* mask,
                                    const void* centers, const void* active,
                                    void* labels, void* sums, void* counts,
                                    int s, int n, int d, int k,
                                    void* stream) {
  if (s <= 0 || k <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = smem_bytes(d, k);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kmeans_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kmeans_assign_kernel<<<s, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(centers), static_cast<const uint8_t*>(active),
      static_cast<int32_t*>(labels), static_cast<float*>(sums),
      static_cast<float*>(counts), n, d, k);
  return static_cast<int>(cudaGetLastError());
}

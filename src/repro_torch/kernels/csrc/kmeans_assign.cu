// k-means for a table of independent clustering problems, written for
// Hopper (sm_90a): the assign half-step, and the whole Lloyd loop in one
// launch.
//
// Replaces the TPU kernel src/repro/kernels/kmeans.py::kmeans_assign_pallas
// (kmeans_assign_launch) and, with it, the loop that calls it in
// src/repro/core/digitize.py::masked_kmeans_table, a fori_loop of `iters`
// half-steps and center updates (kmeans_lloyd_launch).  For every slot s:
//   d[n, j]    = max(|x_n|^2 - 2 x_n.c_j + |c_j|^2, 0), 1e30 for inactive c_j
//   labels[n]  = argmin_j d[n, j] (first index on ties), 0 on masked rows
//   sums[j]    = sum of x_n over unmasked rows labelled j, counts[j] likewise
//   centers[j] = sums[j] / max(counts[j], 1) where counts[j] > 0 (Lloyd)
//
// What bounds it on this card: f32 operations.  At the service's shape
// (S = 256 slots, N = 512 pieces, D = 2, K = 100 centers) one half-step is
// about 85 MFLOP, 1.27 us at the 67 TFLOP/s of the f32 units, so ten Lloyd
// iterations take at least 12.7 us; the bytes (2.2 MB) take 0.67 us at
// 3.35 TB/s, and the fused loop moves them once.  D = 2 leaves the tensor
// cores nothing to do (a product of depth 2 per distance), so all of it
// runs on the f32 units.
//
// What the design does about it:
// 1. One CTA per slot.  The slot's pieces and mask are copied into shared
//    memory once (cp.async, 16-byte pieces where the addresses allow) and
//    stay there for all iterations, with the centers, (c, |c|^2) packed in
//    one 16-byte load per center, and the per-warp partial sums; nothing is
//    read twice from device memory.  One thread owns one piece (512
//    threads at n_max = 512); a tile loop covers N > 512, and a slot too
//    large for shared memory is staged one tile at a time.
// 2. Only the active centers enter the distance loop: the Lloyd kernel's
//    active set is the prefix [0, k), the half-step compacts its mask.  The
//    masked semantics stay exact: if every active distance exceeds 1e30
//    the first inactive center wins, as it does in the plain version.
//    Masked pieces skip the loop (their label is 0 whatever it is).
// 3. A parallel reduction without float atomics, the same every run: each
//    warp groups its 32 rows by label (__match_any_sync), and the group's
//    first lane adds the group's pieces in lane order, loading four rows
//    ahead of its adds.  The per-warp partials (sums and count in one
//    16-byte entry at D = 2) go to shared memory, and one thread per
//    cluster adds them in warp order.  Counts are exact.
// 4. kmeans_lloyd_launch runs every iteration in one launch, the center
//    update (__fdiv_rn, as the plain version divides) included, where the
//    host used to launch a half-step and five update ops per iteration.
// The distance arithmetic is the plain version's, spelled out in
// round-to-nearest intrinsics so that nvcc cannot contract it differently,
// with a strict < so that the first index wins ties: given the same
// centers, labels equal the plain version's.  Both entry points share the
// assign-and-reduce routine, so iterating the half-step and updating the
// centers gives the Lloyd kernel's results bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e30f;
// a block's shared memory on H100, less room for the static `meta`
constexpr size_t kSmemLimit = 232448 - 64;

// sum_e a[e] * b[e] as the plain version rounds it: the first product on
// its own, every further term fused into the running sum.
__device__ __forceinline__ float dot_chain(const float* a, const float* b,
                                           int d) {
  float acc = __fmul_rn(a[0], b[0]);
  for (int e = 1; e < d; ++e) acc = __fmaf_rn(a[e], b[e], acc);
  return acc;
}

__device__ __forceinline__ float distance(float x2, float cross, float c2) {
  return fmaxf(__fadd_rn(__fsub_rn(x2, __fmul_rn(2.f, cross)), c2), 0.f);
}

// Floats per partial entry: the D sums and the count, padded to 16 bytes
// at D = 2.
__host__ __device__ inline int part_stride(int d) {
  return d == 2 ? 4 : d + 1;
}

// Byte offsets of a block's shared arrays; the host sizes the launch with
// the same function.  `rows` pieces are held (the slot, or one tile).
struct Layout {
  size_t x, m, c, c2, pk, acc, cnt, part, idx, total;
};

__host__ __device__ inline size_t align16(size_t v) {
  return (v + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline Layout layout(int rows, int d, int k, int warps) {
  Layout L;
  size_t o = 0;
  L.x = o;    o = align16(o + 4ull * rows * d);         // pieces
  L.c = o;    o = align16(o + 4ull * k * d);            // centers
  L.c2 = o;   o = align16(o + (d == 2 ? 0 : 4ull * k));   // |c_j|^2
  L.pk = o;   o = align16(o + (d == 2 ? 16ull * k : 0));  // (c, |c|^2)
  L.acc = o;  o = align16(o + 4ull * k * d);            // running sums
  L.cnt = o;  o = align16(o + 4ull * k);                // running counts
  L.part = o; o = align16(o + 4ull * warps * k * part_stride(d));
  L.idx = o;  o = align16(o + 4ull * k);                // active centers
  L.m = o;    o = align16(o + rows);                    // mask
  L.total = o;
  return L;
}

struct Shared {
  float* x;
  uint8_t* m;
  float* c;
  float* c2;
  float4* pk;
  float* acc;
  float* cnt;
  float* part;
  int* idx;
};

__device__ inline Shared carve(unsigned char* base, const Layout& L) {
  return {reinterpret_cast<float*>(base + L.x), base + L.m,
          reinterpret_cast<float*>(base + L.c),
          reinterpret_cast<float*>(base + L.c2),
          reinterpret_cast<float4*>(base + L.pk),
          reinterpret_cast<float*>(base + L.acc),
          reinterpret_cast<float*>(base + L.cnt),
          reinterpret_cast<float*>(base + L.part),
          reinterpret_cast<int*>(base + L.idx)};
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

// Copy `count` floats and `rows` mask bytes of one slot into shared memory.
// Each thread waits for its own copies; the caller synchronizes the block.
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int count, uint8_t* m_dst,
                                      const uint8_t* m_src, int rows) {
  const bool wide = ((reinterpret_cast<uintptr_t>(src)
                      | reinterpret_cast<uintptr_t>(dst)) & 15) == 0
                    && (count & 3) == 0;
  if (wide) {
    for (int i = 4 * threadIdx.x; i < count; i += 4 * blockDim.x)
      cp_async_16(dst + i, src + i);
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x)
      cp_async_4(dst + i, src + i);
  }
  for (int i = threadIdx.x; i < rows; i += blockDim.x) m_dst[i] = m_src[i];
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// |c_a|^2 of center a for the distance loop: packed with the center when
// D = 2, else on its own.
template <int kD>
__device__ __forceinline__ void set_norm(const Shared& sh, int a, int d) {
  const float* ca = sh.c + a * d;
  const float n2 = dot_chain(ca, ca, d);
  if constexpr (kD == 2) {
    sh.pk[a] = make_float4(ca[0], ca[1], n2, 0.f);
  } else {
    sh.c2[a] = n2;
  }
}

// Where the nearest active center stands at (best, arg): its index, or
// first_inactive where every active distance exceeds 1e30 (the plain
// version's masked distances).
__device__ __forceinline__ int resolve(const Shared& sh, float best, int arg,
                                       int k, int n_act, bool indexed,
                                       int first_inactive) {
  int lab = (indexed && n_act > 0) ? sh.idx[arg] : arg;
  if (kBig < best) {
    if (first_inactive < k) lab = first_inactive;
  } else if (best == kBig && first_inactive < lab) {
    lab = first_inactive;
  }
  return lab;
}

// The label of row `r` of a tile: the nearest of the n_act centers in
// sh.c (their indices in sh.idx when `indexed`, else 0..n_act-1); -1 for a
// masked row or one past the tile's end.
template <int kD>
__device__ __forceinline__ int nearest(const Shared& sh, const float* xt,
                                       const uint8_t* mt, int r, int len,
                                       int d, int k, int n_act, bool indexed,
                                       int first_inactive) {
  if (r >= len || !mt[r]) return -1;
  float best = INFINITY;
  int arg = 0;
  if constexpr (kD == 2) {
    const float2 xi = reinterpret_cast<const float2*>(xt)[r];
    const float x2 = __fmaf_rn(xi.y, xi.y, __fmul_rn(xi.x, xi.x));
#pragma unroll 8
    for (int a = 0; a < n_act; ++a) {
      const float4 q = sh.pk[a];
      const float dist =
          distance(x2, __fmaf_rn(xi.y, q.y, __fmul_rn(xi.x, q.x)), q.z);
      if (dist < best) {  // strict: the first index wins ties
        best = dist;
        arg = a;
      }
    }
  } else {
    const float* xi = xt + r * d;
    const float x2 = dot_chain(xi, xi, d);
    for (int a = 0; a < n_act; ++a) {
      const float dist = distance(x2, dot_chain(xi, sh.c + a * d, d),
                                  sh.c2[a]);
      if (dist < best) {
        best = dist;
        arg = a;
      }
    }
  }
  return resolve(sh, best, arg, k, n_act, indexed, first_inactive);
}

// Warp w of a tile (rows 32w .. 32w+31, lane l on row 32w+l, labelled
// `lab`): each label's rows added in lane order by the group's first lane,
// into the warp's partial entry (sums, then the count) of that label.
template <int kD>
__device__ __forceinline__ void reduce_warp(const Shared& sh,
                                            const float* xt, int lab, int d,
                                            int k) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int ps = part_stride(d);
  float* pw = sh.part + static_cast<size_t>(w) * k * ps;
  for (int j = lane; j < k; j += 32) pw[j * ps + d] = 0.f;
  __syncwarp();
  const unsigned peers = __match_any_sync(kFull, lab);
  if (lab < 0 || lane != __ffs(peers) - 1) return;
  const float* xw = xt + 32 * w * d;  // the warp's rows
  float* pj = pw + lab * ps;
  if constexpr (kD > 0) {
    float acc[kD];
#pragma unroll
    for (int e = 0; e < kD; ++e) acc[e] = xw[lane * kD + e];
    unsigned rest = peers & (peers - 1);
    while (rest) {  // four members' loads issued ahead of their adds
      int q[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        q[u] = rest ? __ffs(rest) - 1 : -1;
        rest &= rest - 1;
      }
      float v[4][kD];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int e = 0; e < kD; ++e)
          v[u][e] = xw[(q[u] < 0 ? lane : q[u]) * kD + e];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (q[u] < 0) break;
#pragma unroll
        for (int e = 0; e < kD; ++e) acc[e] = __fadd_rn(acc[e], v[u][e]);
      }
    }
#pragma unroll
    for (int e = 0; e < kD; ++e) pj[e] = acc[e];
  } else {
    for (int e = 0; e < d; ++e) {
      float acc = xw[lane * d + e];
      for (unsigned rest = peers & (peers - 1); rest; rest &= rest - 1)
        acc = __fadd_rn(acc, xw[(__ffs(rest) - 1) * d + e]);
      pj[e] = acc;
    }
  }
  pj[d] = static_cast<float>(__popc(peers));
}

// One tile of rows [base, base + len), len <= blockDim.x: label each
// row (written to `labels_out` when it is not null, 0 on masked rows) and
// add the tile's per-cluster sums and counts into sh.acc and sh.cnt.  With
// `update`, each cluster's owner then moves its center to the mean of its
// rows (where it has any), refreshes |c|^2 and clears the running sums for
// the next iteration.  Every thread of the block calls it; it ends
// synchronized.
template <int kD>
__device__ __forceinline__ void assign_tile(const Shared& sh, const float* xt,
                                            const uint8_t* mt, int len, int d,
                                            int k, int n_act, bool indexed,
                                            int first_inactive,
                                            int32_t* labels_out,
                                            bool update) {
  const int tid = threadIdx.x;
  const int lab = nearest<kD>(sh, xt, mt, tid, len, d, k, n_act, indexed,
                              first_inactive);
  if (labels_out != nullptr && tid < len) labels_out[tid] = lab < 0 ? 0 : lab;
  reduce_warp<kD>(sh, xt, lab, d, k);
  __syncthreads();

  // per cluster: the warps' partials added in warp order
  const int warps = (len + 31) / 32;
  const int ps = part_stride(d);
  for (int j = tid; j < k; j += blockDim.x) {
    float* aj = sh.acc + j * d;
    float n_j = 0.f;
    if constexpr (kD == 2) {
      float s0 = aj[0];
      float s1 = aj[1];
#pragma unroll 4
      for (int v = 0; v < warps; ++v) {
        const float4 p = reinterpret_cast<const float4*>(sh.part)[v * k + j];
        if (p.z > 0.f) {
          s0 = __fadd_rn(s0, p.x);
          s1 = __fadd_rn(s1, p.y);
          n_j += p.z;
        }
      }
      aj[0] = s0;
      aj[1] = s1;
    } else {
      for (int v = 0; v < warps; ++v) n_j += sh.part[(v * k + j) * ps + d];
      if (n_j > 0.f) {
        for (int e = 0; e < d; ++e) {
          float a = aj[e];
          for (int v = 0; v < warps; ++v) {
            const float* p = sh.part + (v * k + j) * ps;
            if (p[d] > 0.f) a = __fadd_rn(a, p[e]);
          }
          aj[e] = a;
        }
      }
    }
    const float c_j = sh.cnt[j] + n_j;
    sh.cnt[j] = c_j;
    if (update) {
      if (c_j > 0.f) {
        for (int e = 0; e < d; ++e)
          sh.c[j * d + e] = __fdiv_rn(aj[e], fmaxf(c_j, 1.f));
        set_norm<kD>(sh, j, d);
      }
      for (int e = 0; e < d; ++e) aj[e] = 0.f;
      sh.cnt[j] = 0.f;
    }
  }
  __syncthreads();
}

template <int kD>
__global__ void __launch_bounds__(kMaxThreads)
kmeans_assign_kernel(const float* __restrict__ x,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ centers,
                     const uint8_t* __restrict__ active,
                     int32_t* __restrict__ labels, float* __restrict__ sums,
                     float* __restrict__ counts, int n, int d_rt, int k,
                     int resident) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int meta[2];  // active count, first inactive index
  const int d = kD > 0 ? kD : d_rt;
  const int tid = threadIdx.x;
  const int tile = blockDim.x;
  const Layout L = layout(resident ? n : tile, d, k, tile / 32);
  const Shared sh = carve(smem, L);
  const size_t s = blockIdx.x;
  const float* xs = x + s * n * d;
  const uint8_t* ms = mask + s * n;
  const float* cs = centers + s * k * d;
  int32_t* ls = labels + s * n;

  if (resident) stage(sh.x, xs, n * d, sh.m, ms, n);
  // warp 0 lists the active centers in index order
  if (tid < 32) {
    int n_act = 0;
    int first_inactive = k;
    for (int j0 = 0; j0 < k; j0 += 32) {
      const int j = j0 + tid;
      const bool on = j < k && active[s * k + j] != 0;
      const unsigned on_mask = __ballot_sync(kFull, on);
      const unsigned off_mask = __ballot_sync(kFull, j < k && !on);
      if (on) sh.idx[n_act + __popc(on_mask & ((1u << tid) - 1))] = j;
      n_act += __popc(on_mask);
      if (first_inactive == k && off_mask)
        first_inactive = j0 + __ffs(off_mask) - 1;
    }
    if (tid == 0) {
      meta[0] = n_act;
      meta[1] = first_inactive;
    }
  }
  for (int p = tid; p < k * d; p += blockDim.x) sh.acc[p] = 0.f;
  for (int j = tid; j < k; j += blockDim.x) sh.cnt[j] = 0.f;
  __syncthreads();
  const int n_act = meta[0];
  const int first_inactive = meta[1];
  for (int a = tid; a < n_act; a += blockDim.x) {
    const int j = sh.idx[a];
    for (int e = 0; e < d; ++e) sh.c[a * d + e] = cs[j * d + e];
    set_norm<kD>(sh, a, d);
  }
  __syncthreads();

  for (int base = 0; base < n; base += tile) {
    const int len = min(tile, n - base);
    if (!resident) {
      stage(sh.x, xs + static_cast<size_t>(base) * d, len * d, sh.m,
            ms + base, len);
      __syncthreads();
    }
    const int off = resident ? base : 0;
    assign_tile<kD>(sh, sh.x + off * d, sh.m + off, len, d, k, n_act, true,
                    first_inactive, ls + base, false);
  }

  for (int p = tid; p < k * d; p += blockDim.x)
    sums[s * k * d + p] = sh.acc[p];
  for (int j = tid; j < k; j += blockDim.x) counts[s * k + j] = sh.cnt[j];
}

template <int kD>
__global__ void __launch_bounds__(kMaxThreads)
kmeans_lloyd_kernel(const float* __restrict__ x,
                    const uint8_t* __restrict__ mask,
                    const float* __restrict__ c_init,
                    const int32_t* __restrict__ k_active,
                    float* __restrict__ centers, int32_t* __restrict__ labels,
                    int n, int d_rt, int k, int iters, int resident) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = kD > 0 ? kD : d_rt;
  const int tid = threadIdx.x;
  const int tile = blockDim.x;
  const Layout L = layout(resident ? n : tile, d, k, tile / 32);
  const Shared sh = carve(smem, L);
  const size_t s = blockIdx.x;
  const float* xs = x + s * n * d;
  const uint8_t* ms = mask + s * n;
  const float* cs = c_init + s * k * d;
  float* co = centers + s * k * d;
  int32_t* ls = labels + s * n;

  if (iters == 0) {  // the plain loop's initial carry
    for (int i = tid; i < n; i += blockDim.x) ls[i] = 0;
    for (int p = tid; p < k * d; p += blockDim.x) co[p] = cs[p];
    return;
  }
  // the active centers are the prefix [0, k_s)
  const int n_act = min(max(k_active[s], 0), k);
  if (resident) stage(sh.x, xs, n * d, sh.m, ms, n);
  for (int p = tid; p < k * d; p += blockDim.x) {
    sh.c[p] = cs[p];
    sh.acc[p] = 0.f;
  }
  for (int j = tid; j < k; j += blockDim.x) sh.cnt[j] = 0.f;
  __syncthreads();
  for (int j = tid; j < k; j += blockDim.x) set_norm<kD>(sh, j, d);
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    const bool last = it == iters - 1;
    for (int base = 0; base < n; base += tile) {
      const int len = min(tile, n - base);
      if (!resident) {
        stage(sh.x, xs + static_cast<size_t>(base) * d, len * d, sh.m,
              ms + base, len);
        __syncthreads();
      }
      const int off = resident ? base : 0;
      assign_tile<kD>(sh, sh.x + off * d, sh.m + off, len, d, k, n_act,
                      false, n_act, last ? ls + base : nullptr,
                      base + tile >= n);
    }
  }

  for (int p = tid; p < k * d; p += blockDim.x) co[p] = sh.c[p];
}

struct Plan {
  int threads;
  int resident;
  size_t smem;
};

int round_up32(int v) { return (v + 31) / 32 * 32; }

// The block: one thread per piece up to 512, fewer while the shared arrays
// do not fit; the slot's pieces resident if they fit, else one tile.
bool make_plan(int n, int d, int k, Plan* plan) {
  const int top = n >= kMaxThreads ? kMaxThreads : round_up32(n > 0 ? n : 1);
  for (int resident = 1; resident >= 0; --resident) {
    for (int t = top;; t = round_up32(t / 2)) {
      const size_t bytes = layout(resident ? n : t, d, k, t / 32).total;
      if (bytes <= kSmemLimit) {
        *plan = {t, resident, bytes};
        return true;
      }
      if (t == 32) break;
    }
  }
  return false;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// C entry points, bound with ctypes.  Pointers are device pointers of
// contiguous tensors; each returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue when a block's shared arrays cannot fit.

// The assign half-step.  x (s, n, d) f32, mask (s, n) bool, centers
// (s, k, d) f32, active (s, k) bool; outputs labels (s, n) i32, sums
// (s, k, d) f32, counts (s, k) f32.
extern "C" int kmeans_assign_launch(const void* x, const void* mask,
                                    const void* centers, const void* active,
                                    void* labels, void* sums, void* counts,
                                    int s, int n, int d, int k,
                                    void* stream) {
  if (s <= 0 || k <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  Plan plan;
  if (!make_plan(n, d, k, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = d == 2 ? kmeans_assign_kernel<2> : kmeans_assign_kernel<0>;
  cudaError_t err = allow_smem(kernel, plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<s, plan.threads, plan.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(centers), static_cast<const uint8_t*>(active),
      static_cast<int32_t*>(labels), static_cast<float*>(sums),
      static_cast<float*>(counts), n, d, k, plan.resident);
  return static_cast<int>(cudaGetLastError());
}

// The whole Lloyd loop of masked_kmeans_table.  coords (s, n, d) f32, mask
// (s, n) bool, c_init (s, k, d) f32, k_active (s,) i32 (centers [0, k_s)
// are active), iters >= 0; outputs centers (s, k, d) f32 and labels (s, n)
// i32 of the last iteration (0 on masked rows; all 0 and centers = c_init
// when iters = 0).
extern "C" int kmeans_lloyd_launch(const void* coords, const void* mask,
                                   const void* c_init, const void* k_active,
                                   void* centers, void* labels, int s, int n,
                                   int d, int k, int iters, void* stream) {
  if (s <= 0) return static_cast<int>(cudaSuccess);
  if (k <= 0 || d <= 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  if (!make_plan(n, d, k, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = d == 2 ? kmeans_lloyd_kernel<2> : kmeans_lloyd_kernel<0>;
  cudaError_t err = allow_smem(kernel, plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<s, plan.threads, plan.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coords), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(c_init), static_cast<const int32_t*>(k_active),
      static_cast<float*>(centers), static_cast<int32_t*>(labels), n, d, k,
      iters, plan.resident);
  return static_cast<int>(cudaGetLastError());
}

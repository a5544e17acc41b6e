// Fused InstanceNorm(affine=False) + LeakyReLU, forward and backward, for
// Hopper (sm_90a).
//
// The forward replaces the Pallas TPU kernel `_fwd_kernel`, the backward
// `_bwd_kernel`, both in multi_task_breast_cancer_tpu/ops/pallas_kernels.py
// (launched through `_block_call` -> `pl.pallas_call`; the backward is the
// custom VJP `_inlr_bwd` of `instance_norm_leaky_relu`). The pair is the
// epilogue of every ConvInNormLeReLU: 25 forward launches per MTnnUNet
// forward and 25 backward launches per training step.
//
// What it computes, per (sample n, channel c) plane of an NCHW-contiguous
// tensor (each plane is a contiguous run of H*W elements):
//   mean = sum(x) / HW                       (f32)
//   var  = sum((x - mean)^2) / HW            (f32, two-pass: the centred
//                                             values, never E[x^2]-mean^2,
//                                             which cancels badly)
//   xhat = (x - mean) * rsqrt(var + eps)
//   y    = xhat >= 0 ? xhat : slope * xhat   (in f32, then cast to x's type)
// f32 and bf16 inputs; bf16 is widened with __bfloat162float and narrowed
// once, at the end, with __float2bfloat16.
//
// Bound: memory. The work is a few flops per element, far below the H100's
// ~20 flops per byte balance point in f32. The least traffic is one read and
// one write of every element (forward) and two reads and one write
// (backward): at the flagship's 25 shapes (128^2 input) 3,368,960 elements
// per image, i.e. 26.95 MB per image in f32 and 1.72 GB for a batch of 64
// (~0.51 ms at the data sheet's 3.35 TB/s).
//
// Design. Every launch follows a plan that the wrapper computes on the host
// (`_plan` in ops/hopper_kernels.py) from the number of planes, H*W, the type
// and the pointers' alignment, and passes in; the kernel never picks another.
// Three variants:
//  - subwarp (H*W <= 256: the 4x4, 8x8 and 16x16 levels): an aligned group
//    of `group` lanes (1..32) owns one plane and holds it in registers, one
//    16-byte vector (4 f32 or 8 bf16) per slot; the statistics are butterfly
//    shuffles within the group. A block holds many planes; no shared memory
//    and no __syncthreads.
//  - resident (larger planes up to 128 KB): a plane is split over `cluster`
//    blocks of a thread-block cluster (1, 2, 4 or 8 blocks), each thread
//    loading its `V` vectors of the plane (and of the gradient) once into a
//    register array sized at compile time. Each statistic is a block sum
//    (warp butterfly, then the warps in order) plus a cluster sum: every block
//    pushes its partial into the same slot of every block's shared memory
//    (`st.async` through distributed shared memory, counted in bytes on the
//    receiver's mbarrier), and each block adds the k partials in rank order,
//    so every block gets the same bits and a run repeats bit for bit. One
//    cluster barrier, overlapped with the loads, publishes the mbarriers;
//    no block reads another's shared memory, so none waits for the others
//    before it exits. The plane is then written once from registers. Device
//    traffic is what the bound counts: x read once (and g once), y (dx)
//    written once.
//  - streaming (planes above 128 KB, a pointer not 16-byte aligned, or H*W
//    not a multiple of the vector width): the first design, one block of at
//    most 256 threads per plane that re-reads the plane for every pass (three
//    times forward; x four times and g twice backward), kept as it was.
//
// Split statistics (the `space` axis of a spatial partition, where each rank
// holds some rows of every plane). The caller combines the partial sums of
// all the parts, in one fixed order, between the launches; `total` is the
// element count of the whole plane. Still two-pass, never E[x^2]-mean^2:
//   split_sums (no sums given)  part[p] = sum(x)               over the rows
//   split_sums (sums given)     part[p] = sum((x - mean)^2),   mean = S/total
//   split_apply                 y = LeakyReLU((x - mean) * rsqrt(Q/total + eps))
//   split_backward_sums         part[p] = (sum(dxhat), sum(dxhat * xhat))
//   split_backward_apply        dx = rstd * (dxhat - G1/total - xhat * G2/total)
// where S, Q, (G1, G2) are the combined parts. mean and rstd are formed from
// S and Q exactly as the fused kernels form them, so a plane cut into parts
// differs from the fused kernel only by the order of the sums. The sums take
// one block per plane part (the streaming design's loops); the applies are
// elementwise over a flat grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr unsigned kFull = 0xffffffffu;

enum Variant { kStreaming = 0, kSubwarp = 1, kResident = 2 };

// ---------------------------------------------------------------------------
// Streaming variant: the first design, unchanged.

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Sum of `v` over the block; every thread receives the total. `scratch`
// holds one float per warp. blockDim.x is a multiple of 32.
__device__ float block_sum(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // earlier readers of `scratch` are done
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? scratch[lane] : 0.0f;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
instance_norm_leaky_relu_kernel(const T* __restrict__ x, T* __restrict__ y,
                                int hw, float eps, float slope) {
  __shared__ float scratch[kMaxWarps];
  const size_t base = static_cast<size_t>(blockIdx.x) * hw;
  const T* xp = x + base;
  T* yp = y + base;
  const float inv_hw = 1.0f / static_cast<float>(hw);

  float s = 0.0f;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) s += load_f32(xp + i);
  const float mean = block_sum(s, scratch) * inv_hw;

  float ss = 0.0f;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) {
    const float d = load_f32(xp + i) - mean;
    ss += d * d;
  }
  const float rstd = rsqrtf(block_sum(ss, scratch) * inv_hw + eps);

  for (int i = threadIdx.x; i < hw; i += blockDim.x) {
    const float v = (load_f32(xp + i) - mean) * rstd;
    store_f32(yp + i, v >= 0.0f ? v : slope * v);
  }
}

// Backward, per plane, as the Pallas `_bwd_kernel` computes it: the
// statistics are recomputed from x (nothing but x is saved by the forward),
// then
//   dxhat = xhat >= 0 ? g : slope * g       (the forward's `>= 0` branch)
//   m1    = mean(dxhat),  m2 = mean(dxhat * xhat)
//   dx    = rstd * (dxhat - m1 - xhat * m2)
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
instance_norm_leaky_relu_backward_kernel(const T* __restrict__ x,
                                         const T* __restrict__ g,
                                         T* __restrict__ dx, int hw, float eps,
                                         float slope) {
  __shared__ float scratch[kMaxWarps];
  const size_t base = static_cast<size_t>(blockIdx.x) * hw;
  const T* xp = x + base;
  const T* gp = g + base;
  T* dp = dx + base;
  const float inv_hw = 1.0f / static_cast<float>(hw);

  float s = 0.0f;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) s += load_f32(xp + i);
  const float mean = block_sum(s, scratch) * inv_hw;

  float ss = 0.0f;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) {
    const float d = load_f32(xp + i) - mean;
    ss += d * d;
  }
  const float rstd = rsqrtf(block_sum(ss, scratch) * inv_hw + eps);

  float s1 = 0.0f, s2 = 0.0f;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) {
    const float xhat = (load_f32(xp + i) - mean) * rstd;
    const float gv = load_f32(gp + i);
    const float dxhat = xhat >= 0.0f ? gv : slope * gv;
    s1 += dxhat;
    s2 += dxhat * xhat;
  }
  const float m1 = block_sum(s1, scratch) * inv_hw;
  const float m2 = block_sum(s2, scratch) * inv_hw;

  for (int i = threadIdx.x; i < hw; i += blockDim.x) {
    const float xhat = (load_f32(xp + i) - mean) * rstd;
    const float gv = load_f32(gp + i);
    const float dxhat = xhat >= 0.0f ? gv : slope * gv;
    store_f32(dp + i, rstd * (dxhat - m1 - xhat * m2));
  }
}

// one warp at least, whole warps, at most kMaxThreads
int threads_for(int hw) {
  return hw >= kMaxThreads ? kMaxThreads : ((hw + 31) / 32) * 32;
}

// ---------------------------------------------------------------------------
// 16-byte vectors: element e of a vector of kN values, widened to f32, and
// kN f32 values narrowed (once) into a vector.

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ unsigned bf16_bits(float f) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(f)));
}

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static __forceinline__ float get(const uint4& v, int e) {
    return __uint_as_float(word(v, e));
  }
  __device__ static __forceinline__ uint4 pack(const float (&f)[kN]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static __forceinline__ float get(const uint4& v, int e) {
    const unsigned w = word(v, e >> 1);  // element 2i in the low half
    return __bfloat162float(__ushort_as_bfloat16(
        static_cast<unsigned short>((e & 1) ? (w >> 16) : (w & 0xffffu))));
  }
  __device__ static __forceinline__ uint4 pack(const float (&f)[kN]) {
    return make_uint4(bf16_bits(f[0]) | (bf16_bits(f[1]) << 16),
                      bf16_bits(f[2]) | (bf16_bits(f[3]) << 16),
                      bf16_bits(f[4]) | (bf16_bits(f[5]) << 16),
                      bf16_bits(f[6]) | (bf16_bits(f[7]) << 16));
  }
};

// ---------------------------------------------------------------------------
// Reductions in one fixed order. A butterfly step adds the same two values on
// both partners, so every lane of a group ends with the same bits.

__device__ __forceinline__ float group_sum(float v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The values of lanes 0..n-1, summed in lane order; every lane gets the sum.
__device__ __forceinline__ float lane_order_sum(float v, int n) {
  float t = __shfl_sync(kFull, v, 0);
  for (int r = 1; r < n; ++r) t += __shfl_sync(kFull, v, r);
  return t;
}

// Split cluster barrier (every thread of every block of the cluster arrives;
// the wait returns once all have).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address of the same shared variable in block `rank` of the cluster.
__device__ __forceinline__ unsigned cluster_addr(const void* p, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}

// An mbarrier of one phase that completes once `bytes` have been pushed into
// this block's shared memory (the one arrival is made here).
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar) {
  asm volatile("{\n"
               ".reg .pred done;\n"
               "WAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
               "@!done bra WAIT;\n"
               "}\n" :: "r"(smem_addr(bar)) : "memory");
}

// Stores `v` into `slot` of block `rank` and counts its 4 bytes on that
// block's `bar` (the same variables, mapped into the other block).
__device__ __forceinline__ void push(float* slot, float v, unsigned long long* bar,
                                     unsigned rank) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n"
               :: "r"(cluster_addr(slot, rank)), "f"(v), "r"(cluster_addr(bar, rank))
               : "memory");
}

// One cluster reduction's shared state: the k blocks' partials, pushed here
// by their owners, and the mbarrier that counts their bytes. Each reduction
// has its own, so a push for a later reduction never lands on a partial
// still being read, and no block has to wait for the others before it exits
// (nothing is read from another block's shared memory).
template <int N>
struct Exchange {
  float parts[N][kMaxCluster];
  unsigned long long bar;
};

// Thread 0 readies the block's exchanges for the partials of k blocks; the
// cluster barrier then publishes them. Called by every thread before the
// loads; `cluster_wait()` follows them, before the first push.
template <int... Ns>
__device__ __forceinline__ void ready_exchanges(int k, Exchange<Ns>&... ex) {
  if (threadIdx.x == 0) {
    (mbar_expect(&ex.bar, static_cast<unsigned>(k * Ns * sizeof(float))), ...);
    mbar_init_fence();
  }
  cluster_arrive();
}

// Sums each of v[0..N) over the block, then over the k blocks of the
// cluster: the warp's butterfly, the warps in order, the ranks in order.
// Every thread of every block of the cluster gets the same bits. Lanes
// 0..k-1 of warp 0 push the block's partials into slot `rank` of every
// block; each block waits for all k and adds them in rank order.
template <int N>
__device__ __forceinline__ void block_cluster_sum(float (&v)[N],
                                                  float (&scratch)[N][kMaxWarps],
                                                  Exchange<N>& ex, int k, int rank) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = group_sum(v[i], 32);
    if (lane == 0) scratch[i][threadIdx.x >> 5] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = lane_order_sum(lane < warps ? scratch[i][lane] : 0.0f, warps);
  if (k == 1) return;
  if (static_cast<int>(threadIdx.x) < k) {
#pragma unroll
    for (int i = 0; i < N; ++i) push(&ex.parts[i][rank], v[i], &ex.bar, threadIdx.x);
  }
  mbar_wait(&ex.bar);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float t = ex.parts[i][0];
    for (int r = 1; r < k; ++r) t += ex.parts[i][r];
    v[i] = t;
  }
}

// ---------------------------------------------------------------------------
// Resident variant. Block b serves plane b / k as rank b % k of its cluster;
// thread t of rank r holds the vectors r*V*T + s*T + t (s < V, T threads),
// those below H*W / kN: neighbouring threads on neighbouring 16 bytes.

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
instance_norm_leaky_relu_resident_kernel(const T* __restrict__ x,
                                         T* __restrict__ y, int hw, int k,
                                         float eps, float slope) {
  constexpr int kN = Vec<T>::kN;
  __shared__ float scratch_mean[1][kMaxWarps], scratch_var[1][kMaxWarps];
  __shared__ Exchange<1> ex_mean, ex_var;
  const int nvec = hw / kN;
  const int plane = blockIdx.x / k;
  const int rank = blockIdx.x - plane * k;
  const int first = rank * V * blockDim.x + threadIdx.x;
  const size_t base = static_cast<size_t>(plane) * nvec;
  const uint4* xp = reinterpret_cast<const uint4*>(x) + base;
  const float inv_hw = 1.0f / static_cast<float>(hw);
  if (k > 1) ready_exchanges(k, ex_mean, ex_var);

  uint4 xr[V];
#pragma unroll
  for (int s = 0; s < V; ++s) {
    const int j = first + s * blockDim.x;
    xr[s] = j < nvec ? __ldg(xp + j) : make_uint4(0u, 0u, 0u, 0u);
  }
  if (k > 1) cluster_wait();  // every block's exchanges are ready

  float sum[1] = {0.0f};
#pragma unroll
  for (int s = 0; s < V; ++s) {
    if (first + s * static_cast<int>(blockDim.x) >= nvec) continue;
#pragma unroll
    for (int e = 0; e < kN; ++e) sum[0] += Vec<T>::get(xr[s], e);
  }
  block_cluster_sum(sum, scratch_mean, ex_mean, k, rank);
  const float mean = sum[0] * inv_hw;

  float ss[1] = {0.0f};
#pragma unroll
  for (int s = 0; s < V; ++s) {
    if (first + s * static_cast<int>(blockDim.x) >= nvec) continue;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const float d = Vec<T>::get(xr[s], e) - mean;
      ss[0] += d * d;
    }
  }
  block_cluster_sum(ss, scratch_var, ex_var, k, rank);
  const float rstd = rsqrtf(ss[0] * inv_hw + eps);

  uint4* yp = reinterpret_cast<uint4*>(y) + base;
#pragma unroll
  for (int s = 0; s < V; ++s) {
    const int j = first + s * blockDim.x;
    if (j >= nvec) continue;
    float o[kN];
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const float v = (Vec<T>::get(xr[s], e) - mean) * rstd;
      o[e] = v >= 0.0f ? v : slope * v;
    }
    yp[j] = Vec<T>::pack(o);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
instance_norm_leaky_relu_backward_resident_kernel(const T* __restrict__ x,
                                                  const T* __restrict__ g,
                                                  T* __restrict__ dx, int hw,
                                                  int k, float eps, float slope) {
  constexpr int kN = Vec<T>::kN;
  __shared__ float scratch_mean[1][kMaxWarps], scratch_var[1][kMaxWarps];
  __shared__ float scratch_m[2][kMaxWarps];
  __shared__ Exchange<1> ex_mean, ex_var;
  __shared__ Exchange<2> ex_m;
  const int nvec = hw / kN;
  const int plane = blockIdx.x / k;
  const int rank = blockIdx.x - plane * k;
  const int first = rank * V * blockDim.x + threadIdx.x;
  const size_t base = static_cast<size_t>(plane) * nvec;
  const uint4* xp = reinterpret_cast<const uint4*>(x) + base;
  const uint4* gp = reinterpret_cast<const uint4*>(g) + base;
  const float inv_hw = 1.0f / static_cast<float>(hw);
  if (k > 1) ready_exchanges(k, ex_mean, ex_var, ex_m);

  uint4 xr[V], gr[V];
#pragma unroll
  for (int s = 0; s < V; ++s) {
    const int j = first + s * blockDim.x;
    xr[s] = j < nvec ? __ldg(xp + j) : make_uint4(0u, 0u, 0u, 0u);
    gr[s] = j < nvec ? __ldg(gp + j) : make_uint4(0u, 0u, 0u, 0u);
  }
  if (k > 1) cluster_wait();

  float sum[1] = {0.0f};
#pragma unroll
  for (int s = 0; s < V; ++s) {
    if (first + s * static_cast<int>(blockDim.x) >= nvec) continue;
#pragma unroll
    for (int e = 0; e < kN; ++e) sum[0] += Vec<T>::get(xr[s], e);
  }
  block_cluster_sum(sum, scratch_mean, ex_mean, k, rank);
  const float mean = sum[0] * inv_hw;

  float ss[1] = {0.0f};
#pragma unroll
  for (int s = 0; s < V; ++s) {
    if (first + s * static_cast<int>(blockDim.x) >= nvec) continue;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const float d = Vec<T>::get(xr[s], e) - mean;
      ss[0] += d * d;
    }
  }
  block_cluster_sum(ss, scratch_var, ex_var, k, rank);
  const float rstd = rsqrtf(ss[0] * inv_hw + eps);

  float m[2] = {0.0f, 0.0f};  // sum(dxhat), sum(dxhat * xhat)
#pragma unroll
  for (int s = 0; s < V; ++s) {
    if (first + s * static_cast<int>(blockDim.x) >= nvec) continue;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const float xhat = (Vec<T>::get(xr[s], e) - mean) * rstd;
      const float gv = Vec<T>::get(gr[s], e);
      const float dxhat = xhat >= 0.0f ? gv : slope * gv;
      m[0] += dxhat;
      m[1] += dxhat * xhat;
    }
  }
  block_cluster_sum(m, scratch_m, ex_m, k, rank);
  const float m1 = m[0] * inv_hw, m2 = m[1] * inv_hw;

  uint4* dp = reinterpret_cast<uint4*>(dx) + base;
#pragma unroll
  for (int s = 0; s < V; ++s) {
    const int j = first + s * blockDim.x;
    if (j >= nvec) continue;
    float o[kN];
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const float xhat = (Vec<T>::get(xr[s], e) - mean) * rstd;
      const float gv = Vec<T>::get(gr[s], e);
      const float dxhat = xhat >= 0.0f ? gv : slope * gv;
      o[e] = rstd * (dxhat - m1 - xhat * m2);
    }
    dp[j] = Vec<T>::pack(o);
  }
}

// ---------------------------------------------------------------------------
// Subwarp variant. Global thread t serves plane t >> group_log2 as lane
// t & (group - 1) of its group and holds the vectors s*group + lane (s < V),
// those below H*W / kN. Threads past the last plane load nothing but still
// take part in the shuffles.

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
instance_norm_leaky_relu_subwarp_kernel(const T* __restrict__ x,
                                        T* __restrict__ y, int planes, int hw,
                                        int group_log2, float eps, float slope) {
  constexpr int kN = Vec<T>::kN;
  const int nvec = hw / kN;
  const int group = 1 << group_log2;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int plane = t >> group_log2;
  const int lane = t & (group - 1);
  const bool live = plane < planes;
  const size_t base = static_cast<size_t>(live ? plane : 0) * nvec;
  const uint4* xp = reinterpret_cast<const uint4*>(x) + base;
  const float inv_hw = 1.0f / static_cast<float>(hw);

  uint4 xr[V];
#pragma unroll
  for (int s = 0; s < V; ++s) {
    const int j = s * group + lane;
    xr[s] = live && j < nvec ? __ldg(xp + j) : make_uint4(0u, 0u, 0u, 0u);
  }

  float sum = 0.0f;
#pragma unroll
  for (int s = 0; s < V; ++s) {
    if (!live || s * group + lane >= nvec) continue;
#pragma unroll
    for (int e = 0; e < kN; ++e) sum += Vec<T>::get(xr[s], e);
  }
  const float mean = group_sum(sum, group) * inv_hw;

  float ss = 0.0f;
#pragma unroll
  for (int s = 0; s < V; ++s) {
    if (!live || s * group + lane >= nvec) continue;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const float d = Vec<T>::get(xr[s], e) - mean;
      ss += d * d;
    }
  }
  const float rstd = rsqrtf(group_sum(ss, group) * inv_hw + eps);

  uint4* yp = reinterpret_cast<uint4*>(y) + base;
#pragma unroll
  for (int s = 0; s < V; ++s) {
    const int j = s * group + lane;
    if (!live || j >= nvec) continue;
    float o[kN];
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const float v = (Vec<T>::get(xr[s], e) - mean) * rstd;
      o[e] = v >= 0.0f ? v : slope * v;
    }
    yp[j] = Vec<T>::pack(o);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
instance_norm_leaky_relu_backward_subwarp_kernel(const T* __restrict__ x,
                                                 const T* __restrict__ g,
                                                 T* __restrict__ dx, int planes,
                                                 int hw, int group_log2,
                                                 float eps, float slope) {
  constexpr int kN = Vec<T>::kN;
  const int nvec = hw / kN;
  const int group = 1 << group_log2;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int plane = t >> group_log2;
  const int lane = t & (group - 1);
  const bool live = plane < planes;
  const size_t base = static_cast<size_t>(live ? plane : 0) * nvec;
  const uint4* xp = reinterpret_cast<const uint4*>(x) + base;
  const uint4* gp = reinterpret_cast<const uint4*>(g) + base;
  const float inv_hw = 1.0f / static_cast<float>(hw);

  uint4 xr[V], gr[V];
#pragma unroll
  for (int s = 0; s < V; ++s) {
    const int j = s * group + lane;
    const bool ok = live && j < nvec;
    xr[s] = ok ? __ldg(xp + j) : make_uint4(0u, 0u, 0u, 0u);
    gr[s] = ok ? __ldg(gp + j) : make_uint4(0u, 0u, 0u, 0u);
  }

  float sum = 0.0f;
#pragma unroll
  for (int s = 0; s < V; ++s) {
    if (!live || s * group + lane >= nvec) continue;
#pragma unroll
    for (int e = 0; e < kN; ++e) sum += Vec<T>::get(xr[s], e);
  }
  const float mean = group_sum(sum, group) * inv_hw;

  float ss = 0.0f;
#pragma unroll
  for (int s = 0; s < V; ++s) {
    if (!live || s * group + lane >= nvec) continue;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const float d = Vec<T>::get(xr[s], e) - mean;
      ss += d * d;
    }
  }
  const float rstd = rsqrtf(group_sum(ss, group) * inv_hw + eps);

  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int s = 0; s < V; ++s) {
    if (!live || s * group + lane >= nvec) continue;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const float xhat = (Vec<T>::get(xr[s], e) - mean) * rstd;
      const float gv = Vec<T>::get(gr[s], e);
      const float dxhat = xhat >= 0.0f ? gv : slope * gv;
      s1 += dxhat;
      s2 += dxhat * xhat;
    }
  }
  const float m1 = group_sum(s1, group) * inv_hw;
  const float m2 = group_sum(s2, group) * inv_hw;

  uint4* dp = reinterpret_cast<uint4*>(dx) + base;
#pragma unroll
  for (int s = 0; s < V; ++s) {
    const int j = s * group + lane;
    if (!live || j >= nvec) continue;
    float o[kN];
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const float xhat = (Vec<T>::get(xr[s], e) - mean) * rstd;
      const float gv = Vec<T>::get(gr[s], e);
      const float dxhat = xhat >= 0.0f ? gv : slope * gv;
      o[e] = rstd * (dxhat - m1 - xhat * m2);
    }
    dp[j] = Vec<T>::pack(o);
  }
}

// ---------------------------------------------------------------------------
// Split statistics (see the header). `sums`, `sq`, `gsums`: the combined
// parts, f32, one (or two, gsums) per plane.

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
split_sums_kernel(const T* __restrict__ x, const float* __restrict__ sums,
                  float* __restrict__ part, int hw, float inv_total) {
  __shared__ float scratch[kMaxWarps];
  const T* xp = x + static_cast<size_t>(blockIdx.x) * hw;
  float s = 0.0f;
  if (sums == nullptr) {
    for (int i = threadIdx.x; i < hw; i += blockDim.x) s += load_f32(xp + i);
  } else {
    const float mean = sums[blockIdx.x] * inv_total;
    for (int i = threadIdx.x; i < hw; i += blockDim.x) {
      const float d = load_f32(xp + i) - mean;
      s += d * d;
    }
  }
  s = block_sum(s, scratch);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
split_apply_kernel(const T* __restrict__ x, const float* __restrict__ sums,
                   const float* __restrict__ sq, T* __restrict__ y, long long n,
                   int hw, float inv_total, float eps, float slope) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int p = static_cast<int>(i / hw);
    const float mean = sums[p] * inv_total;
    const float rstd = rsqrtf(sq[p] * inv_total + eps);
    const float v = (load_f32(x + i) - mean) * rstd;
    store_f32(y + i, v >= 0.0f ? v : slope * v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
split_backward_sums_kernel(const T* __restrict__ x, const T* __restrict__ g,
                           const float* __restrict__ sums,
                           const float* __restrict__ sq, float* __restrict__ part,
                           int hw, float inv_total, float eps, float slope) {
  __shared__ float scratch[kMaxWarps];
  const size_t base = static_cast<size_t>(blockIdx.x) * hw;
  const T* xp = x + base;
  const T* gp = g + base;
  const float mean = sums[blockIdx.x] * inv_total;
  const float rstd = rsqrtf(sq[blockIdx.x] * inv_total + eps);
  float s1 = 0.0f, s2 = 0.0f;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) {
    const float xhat = (load_f32(xp + i) - mean) * rstd;
    const float gv = load_f32(gp + i);
    const float dxhat = xhat >= 0.0f ? gv : slope * gv;
    s1 += dxhat;
    s2 += dxhat * xhat;
  }
  s1 = block_sum(s1, scratch);
  s2 = block_sum(s2, scratch);
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = s1;
    part[2 * blockIdx.x + 1] = s2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
split_backward_apply_kernel(const T* __restrict__ x, const T* __restrict__ g,
                            const float* __restrict__ sums,
                            const float* __restrict__ sq,
                            const float* __restrict__ gsums, T* __restrict__ dx,
                            long long n, int hw, float inv_total, float eps,
                            float slope) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int p = static_cast<int>(i / hw);
    const float mean = sums[p] * inv_total;
    const float rstd = rsqrtf(sq[p] * inv_total + eps);
    const float m1 = gsums[2 * p] * inv_total;
    const float m2 = gsums[2 * p + 1] * inv_total;
    const float xhat = (load_f32(x + i) - mean) * rstd;
    const float gv = load_f32(g + i);
    const float dxhat = xhat >= 0.0f ? gv : slope * gv;
    store_f32(dx + i, rstd * (dxhat - m1 - xhat * m2));
  }
}

__global__ void instance_norm_leaky_relu_empty_kernel() {}

// ---------------------------------------------------------------------------
// Launch, by the plan the wrapper computed. A plan this file does not take
// is refused with cudaErrorInvalidValue; nothing falls back to another
// variant.

struct Plan {
  int variant, cluster, threads, vectors, group;
};

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

bool is_pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

int log2_of(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// The vector plans' common conditions: 16-byte aligned pointers, whole
// vectors per plane, whole warps of at most kMaxThreads threads.
template <typename T>
bool vector_plan_ok(const Plan& p, int hw, const void* const* ptrs, int n_ptrs) {
  for (int i = 0; i < n_ptrs; ++i)
    if (!aligned16(ptrs[i])) return false;
  return hw % Vec<T>::kN == 0 && p.threads >= 32 && p.threads <= kMaxThreads &&
         p.threads % 32 == 0;
}

cudaError_t last_error(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error
  return err != cudaSuccess ? err : last;
}

// A plane per cluster of k blocks; k = 1 is an ordinary launch.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int blocks, int threads,
                            int k, cudaStream_t stream, Args... args) {
  if (k == 1) {
    kernel<<<blocks, threads, 0, stream>>>(args...);
    return last_error(cudaSuccess);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return last_error(cudaLaunchKernelEx(&cfg, kernel, args...));
}

template <typename T>
cudaError_t launch(const void* x, void* y, int planes, int hw, float eps,
                   float slope, cudaStream_t stream, const Plan& p) {
  if (planes <= 0 || hw <= 0) return cudaErrorInvalidValue;
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  const void* ptrs[2] = {x, y};
  constexpr int kN = Vec<T>::kN;
  if (p.variant == kStreaming) {
    instance_norm_leaky_relu_kernel<T><<<planes, threads_for(hw), 0, stream>>>(
        xs, ys, hw, eps, slope);
    return last_error(cudaSuccess);
  }
  if (!vector_plan_ok<T>(p, hw, ptrs, 2)) return cudaErrorInvalidValue;
  if (p.variant == kSubwarp) {
    if (!is_pow2(p.group) || p.group > 32 || p.group * p.vectors * kN < hw)
      return cudaErrorInvalidValue;
    const long long threads = static_cast<long long>(planes) * p.group;
    const int blocks = static_cast<int>((threads + p.threads - 1) / p.threads);
    const int gl = log2_of(p.group);
    switch (p.vectors) {
      case 1:
        instance_norm_leaky_relu_subwarp_kernel<T, 1>
            <<<blocks, p.threads, 0, stream>>>(xs, ys, planes, hw, gl, eps, slope);
        return last_error(cudaSuccess);
      case 2:
        instance_norm_leaky_relu_subwarp_kernel<T, 2>
            <<<blocks, p.threads, 0, stream>>>(xs, ys, planes, hw, gl, eps, slope);
        return last_error(cudaSuccess);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (p.variant != kResident || !is_pow2(p.cluster) || p.cluster > kMaxCluster ||
      p.cluster * p.threads * p.vectors * kN < hw)
    return cudaErrorInvalidValue;
  const int blocks = planes * p.cluster;
  switch (p.vectors) {
    case 1:
      return launch_clusters(instance_norm_leaky_relu_resident_kernel<T, 1>, blocks,
                             p.threads, p.cluster, stream, xs, ys, hw, p.cluster, eps, slope);
    case 2:
      return launch_clusters(instance_norm_leaky_relu_resident_kernel<T, 2>, blocks,
                             p.threads, p.cluster, stream, xs, ys, hw, p.cluster, eps, slope);
    case 4:
      return launch_clusters(instance_norm_leaky_relu_resident_kernel<T, 4>, blocks,
                             p.threads, p.cluster, stream, xs, ys, hw, p.cluster, eps, slope);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_backward(const void* x, const void* g, void* dx, int planes,
                            int hw, float eps, float slope,
                            cudaStream_t stream, const Plan& p) {
  if (planes <= 0 || hw <= 0) return cudaErrorInvalidValue;
  const T* xs = static_cast<const T*>(x);
  const T* gs = static_cast<const T*>(g);
  T* ds = static_cast<T*>(dx);
  const void* ptrs[3] = {x, g, dx};
  constexpr int kN = Vec<T>::kN;
  if (p.variant == kStreaming) {
    instance_norm_leaky_relu_backward_kernel<T>
        <<<planes, threads_for(hw), 0, stream>>>(xs, gs, ds, hw, eps, slope);
    return last_error(cudaSuccess);
  }
  if (!vector_plan_ok<T>(p, hw, ptrs, 3)) return cudaErrorInvalidValue;
  if (p.variant == kSubwarp) {
    if (!is_pow2(p.group) || p.group > 32 || p.group * p.vectors * kN < hw)
      return cudaErrorInvalidValue;
    const long long threads = static_cast<long long>(planes) * p.group;
    const int blocks = static_cast<int>((threads + p.threads - 1) / p.threads);
    const int gl = log2_of(p.group);
    switch (p.vectors) {
      case 1:
        instance_norm_leaky_relu_backward_subwarp_kernel<T, 1>
            <<<blocks, p.threads, 0, stream>>>(xs, gs, ds, planes, hw, gl, eps, slope);
        return last_error(cudaSuccess);
      case 2:
        instance_norm_leaky_relu_backward_subwarp_kernel<T, 2>
            <<<blocks, p.threads, 0, stream>>>(xs, gs, ds, planes, hw, gl, eps, slope);
        return last_error(cudaSuccess);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (p.variant != kResident || !is_pow2(p.cluster) || p.cluster > kMaxCluster ||
      p.cluster * p.threads * p.vectors * kN < hw)
    return cudaErrorInvalidValue;
  const int blocks = planes * p.cluster;
  switch (p.vectors) {
    case 1:
      return launch_clusters(instance_norm_leaky_relu_backward_resident_kernel<T, 1>,
                             blocks, p.threads, p.cluster, stream, xs, gs, ds, hw,
                             p.cluster, eps, slope);
    case 2:
      return launch_clusters(instance_norm_leaky_relu_backward_resident_kernel<T, 2>,
                             blocks, p.threads, p.cluster, stream, xs, gs, ds, hw,
                             p.cluster, eps, slope);
    case 4:
      return launch_clusters(instance_norm_leaky_relu_backward_resident_kernel<T, 4>,
                             blocks, p.threads, p.cluster, stream, xs, gs, ds, hw,
                             p.cluster, eps, slope);
    default:
      return cudaErrorInvalidValue;
  }
}

// The split launches: one block per plane part for the sums, a flat grid of
// at most kApplyBlocks blocks for the applies.
constexpr long long kApplyBlocks = 132 * 16;

int apply_blocks(long long n) {
  const long long b = (n + kMaxThreads - 1) / kMaxThreads;
  return static_cast<int>(b < kApplyBlocks ? b : kApplyBlocks);
}

float inverse(int total) { return 1.0f / static_cast<float>(total); }

template <typename T>
cudaError_t launch_split_sums(const void* x, const float* sums, float* part,
                              int planes, int hw, int total, cudaStream_t stream) {
  if (planes <= 0 || hw <= 0 || total < hw) return cudaErrorInvalidValue;
  split_sums_kernel<T><<<planes, threads_for(hw), 0, stream>>>(
      static_cast<const T*>(x), sums, part, hw, inverse(total));
  return last_error(cudaSuccess);
}

template <typename T>
cudaError_t launch_split_apply(const void* x, const float* sums, const float* sq,
                               void* y, int planes, int hw, int total, float eps,
                               float slope, cudaStream_t stream) {
  if (planes <= 0 || hw <= 0 || total < hw) return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(planes) * hw;
  split_apply_kernel<T><<<apply_blocks(n), kMaxThreads, 0, stream>>>(
      static_cast<const T*>(x), sums, sq, static_cast<T*>(y), n, hw,
      inverse(total), eps, slope);
  return last_error(cudaSuccess);
}

template <typename T>
cudaError_t launch_split_backward_sums(const void* x, const void* g,
                                       const float* sums, const float* sq,
                                       float* part, int planes, int hw, int total,
                                       float eps, float slope, cudaStream_t stream) {
  if (planes <= 0 || hw <= 0 || total < hw) return cudaErrorInvalidValue;
  split_backward_sums_kernel<T><<<planes, threads_for(hw), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), sums, sq, part, hw,
      inverse(total), eps, slope);
  return last_error(cudaSuccess);
}

template <typename T>
cudaError_t launch_split_backward_apply(const void* x, const void* g,
                                        const float* sums, const float* sq,
                                        const float* gsums, void* dx, int planes,
                                        int hw, int total, float eps, float slope,
                                        cudaStream_t stream) {
  if (planes <= 0 || hw <= 0 || total < hw) return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(planes) * hw;
  split_backward_apply_kernel<T><<<apply_blocks(n), kMaxThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), sums, sq, gsums,
      static_cast<T*>(dx), n, hw, inverse(total), eps, slope);
  return last_error(cudaSuccess);
}

}  // namespace

// C entry points, bound with ctypes. `x` and `y` are NCHW-contiguous device
// buffers of planes = N*C planes of hw = H*W elements each; the last five
// arguments are the launch plan (variant 0 streaming, 1 subwarp, 2 resident;
// blocks per plane; threads per block; 16-byte vectors per thread and input;
// lanes per plane in the subwarp variant). Returns the CUDA error of the
// launch (0 on success).
extern "C" cudaError_t instance_norm_leaky_relu_f32(
    const void* x, void* y, int planes, int hw, float eps, float slope,
    cudaStream_t stream, int variant, int cluster, int threads, int vectors,
    int group) {
  return launch<float>(x, y, planes, hw, eps, slope, stream,
                       Plan{variant, cluster, threads, vectors, group});
}

extern "C" cudaError_t instance_norm_leaky_relu_bf16(
    const void* x, void* y, int planes, int hw, float eps, float slope,
    cudaStream_t stream, int variant, int cluster, int threads, int vectors,
    int group) {
  return launch<__nv_bfloat16>(x, y, planes, hw, eps, slope, stream,
                               Plan{variant, cluster, threads, vectors, group});
}

// Backward entry points: `x` the forward's input, `g` the gradient of the
// output, `dx` the gradient of the input; all NCHW-contiguous device buffers
// of the same type and shape; the plan as above.
extern "C" cudaError_t instance_norm_leaky_relu_backward_f32(
    const void* x, const void* g, void* dx, int planes, int hw, float eps,
    float slope, cudaStream_t stream, int variant, int cluster, int threads,
    int vectors, int group) {
  return launch_backward<float>(x, g, dx, planes, hw, eps, slope, stream,
                                Plan{variant, cluster, threads, vectors, group});
}

extern "C" cudaError_t instance_norm_leaky_relu_backward_bf16(
    const void* x, const void* g, void* dx, int planes, int hw, float eps,
    float slope, cudaStream_t stream, int variant, int cluster, int threads,
    int vectors, int group) {
  return launch_backward<__nv_bfloat16>(x, g, dx, planes, hw, eps, slope, stream,
                                        Plan{variant, cluster, threads, vectors, group});
}

// Split-statistics entry points (see the header): `x`, `g`, `y`, `dx`
// NCHW-contiguous device buffers of this part's rows, planes = N*C planes
// of hw = rows*W elements; `total` the whole plane's element count; `sums`
// (null for the first pass), `sq` and `gsums` the combined parts, `part` the
// f32 output (one value per plane, two for the backward sums).
#define SPLIT_ENTRIES(SUFFIX, T)                                                  \
  extern "C" cudaError_t instance_norm_split_sums_##SUFFIX(                      \
      const void* x, const float* sums, float* part, int planes, int hw,         \
      int total, cudaStream_t stream) {                                          \
    return launch_split_sums<T>(x, sums, part, planes, hw, total, stream);       \
  }                                                                              \
  extern "C" cudaError_t instance_norm_leaky_relu_split_apply_##SUFFIX(          \
      const void* x, const float* sums, const float* sq, void* y, int planes,    \
      int hw, int total, float eps, float slope, cudaStream_t stream) {          \
    return launch_split_apply<T>(x, sums, sq, y, planes, hw, total, eps, slope,  \
                                 stream);                                        \
  }                                                                              \
  extern "C" cudaError_t instance_norm_leaky_relu_split_backward_sums_##SUFFIX(  \
      const void* x, const void* g, const float* sums, const float* sq,          \
      float* part, int planes, int hw, int total, float eps, float slope,        \
      cudaStream_t stream) {                                                     \
    return launch_split_backward_sums<T>(x, g, sums, sq, part, planes, hw,       \
                                         total, eps, slope, stream);             \
  }                                                                              \
  extern "C" cudaError_t instance_norm_leaky_relu_split_backward_apply_##SUFFIX( \
      const void* x, const void* g, const float* sums, const float* sq,          \
      const float* gsums, void* dx, int planes, int hw, int total, float eps,    \
      float slope, cudaStream_t stream) {                                        \
    return launch_split_backward_apply<T>(x, g, sums, sq, gsums, dx, planes, hw, \
                                          total, eps, slope, stream);            \
  }

SPLIT_ENTRIES(f32, float)
SPLIT_ENTRIES(bf16, __nv_bfloat16)

// One launch of an empty kernel of this library: the floor under every
// launch above, for the measurements.
extern "C" cudaError_t instance_norm_leaky_relu_empty(cudaStream_t stream) {
  instance_norm_leaky_relu_empty_kernel<<<1, 32, 0, stream>>>();
  return cudaGetLastError();
}

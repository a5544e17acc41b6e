// Affine InstanceNorm with its epilogue (an optional residual add, then an
// optional LeakyReLU), forward and backward, for Hopper (sm_90a).
//
// It replaces no Pallas TPU kernel: the JAX package runs SwinUNETR's UNETR
// blocks (`models/swin_unetr.py::UnetrBasicBlock`) as plain jnp arithmetic,
// which XLA fuses on the TPU. In the PyTorch port the same arithmetic in
// plain torch is about forty kernels a site and training step (statistics,
// normalisation, affine, add, activation and the autograd of each), most at
// the launch floor. SwinUNETR has 26 such sites a forward: norm1 (activation,
// no residual), norm2 (residual add, then activation) and norm_skip (neither)
// of its ten UNETR blocks. This source does a site in one launch forward and
// two backward.
//
// What it computes, per (sample n, channel c) plane of an NCHW-contiguous
// tensor (each plane is a contiguous run of H*W elements), in f32:
//   mean = sum(x) / HW,  var = sum((x - mean)^2) / HW   (centred, two-pass)
//   rstd = rsqrt(var + eps),  xhat = (x - mean) * rstd
//   pre  = T(xhat) * scale[c] + bias[c]  (+ residual)
//   y    = act ? (pre > 0 ? pre : slope * pre) : pre
// where T() rounds to the input's type, and every product and sum of the
// epilogue rounds to that type as the module's separate torch operations do
// (no fused multiply-add): in f32 the epilogue's bits are the module's for
// the same xhat. The forward saves (mean, rstd) per plane, 8 bytes.
//
// The backward, with dpre = act ? (y > 0 ? dy : slope * dy) : dy (y > 0
// exactly where pre > 0) and g = dpre * scale[c]:
//   dx       = rstd * (g - mean(g) - xhat * mean(g * xhat))
//   dresidual = dpre
//   dscale[c] = sum over n and the plane of dpre * T(xhat),  dbias[c] = sum of dpre
// The plane kernel writes dx, dresidual and each plane's two sums; a second
// launch adds the planes of each channel over the batch in order n = 0, 1, ...
//
// Bound: memory, and at SwinUNETR's batch 2 the launch floor. The least
// traffic is x (and the residual) read and y written forward; x, y and dy
// read, dx (and dresidual) written backward. At 128^2 and batch 2 the
// largest site moves 3.15 MB a tensor (48 planes of 16,384 f32): about a
// microsecond each at 3.35 TB/s.
//
// Design. A plan computed on the host (`_plan` in ops/instance_norm_affine.py)
// from the plane count, H*W and the type; the kernel never picks another.
// Two variants of one kernel body:
//  - group (H*W <= 256: the 16^2 to 4^2 sites): an aligned group of `group`
//    lanes (1..32) owns a plane and holds it in registers, one 16-byte vector
//    (4 f32 or 8 bf16) per slot; the statistics are butterfly shuffles in the
//    group; a warp holds several planes (8 at 4^2 f32).
//  - cluster (larger planes): a plane is split over the `k` blocks of a
//    thread-block cluster (1, 2, 4 or 8), so that the 48 planes of a 128^2
//    site at batch 2 fill 384 blocks and not 48 SMs. Each thread holds V
//    vectors of the plane (and of the gradient) in registers between the
//    statistics and the apply, so x is read from device memory once. A
//    statistic is a block sum (the warp's butterfly, then the warps in order)
//    plus a cluster sum: every block pushes its partial into the same slot of
//    every block's shared memory (`st.async` through distributed shared
//    memory, counted in bytes on the receiver's mbarrier), and each block
//    adds the k partials in rank order, so every block gets the same bits. A
//    plane larger than the cluster's registers hold (above 128 KB) is walked
//    in tiles and read again for each pass.
// No atomics anywhere: the order of every sum depends on the plan alone, so
// two runs of a step give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxGroupVectors = 2;  // a group's vectors a lane (a 16^2 f32 plane: 2)
constexpr unsigned kFull = 0xffffffffu;

enum Variant { kGroup = 0, kCluster = 1 };

// ---------------------------------------------------------------------------
// 16-byte vectors: element e of a vector of kN values, widened to f32; kN
// f32 values narrowed into a vector; and a value rounded to the type.

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
  __device__ static __forceinline__ float round(float f) { return f; }
  __device__ static __forceinline__ float scalar(const float* p) { return *p; }
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
  __device__ static __forceinline__ float round(float f) {
    return __bfloat162float(__float2bfloat16(f));
  }
  __device__ static __forceinline__ float scalar(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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
// Which vectors of which plane a thread serves. Vector j of the plane (16
// bytes at j * kN elements) for slot s of tile `tile` is
//   tile * span + s * stride + first,
// kept only below nvec. Group variant: global thread t serves plane
// t >> group_log2 as lane t & (group - 1) (first = lane, stride = group, one
// tile); threads past the last plane load nothing but take part in the
// shuffles. Cluster variant: block b serves plane b / k as rank b % k (first
// = rank * T + thread, stride = k * T), neighbouring threads on neighbouring
// 16 bytes.

struct Lanes {
  int plane, rank, first, stride, span, tiles;
  bool live;
};

template <int V, bool kClustered>
__device__ __forceinline__ Lanes lanes_of(int planes, int nvec, int k, int group_log2) {
  Lanes l;
  if (kClustered) {
    l.plane = blockIdx.x / k;
    l.rank = blockIdx.x - l.plane * k;
    l.first = l.rank * blockDim.x + threadIdx.x;
    l.stride = k * blockDim.x;
    l.live = true;
  } else {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    l.plane = t >> group_log2;
    l.rank = 0;
    l.first = t & ((1 << group_log2) - 1);
    l.stride = 1 << group_log2;
    l.live = l.plane < planes;
    if (!l.live) l.plane = 0;
  }
  l.span = l.stride * V;
  l.tiles = (nvec + l.span - 1) / l.span;
  return l;
}

__device__ __forceinline__ bool has(const Lanes& l, int tile, int s, int nvec) {
  return l.live && tile * l.span + s * l.stride + l.first < nvec;
}

template <int V>
__device__ __forceinline__ void load_tile(uint4 (&r)[V], const uint4* p, const Lanes& l,
                                          int tile, int nvec) {
#pragma unroll
  for (int s = 0; s < V; ++s)
    r[s] = has(l, tile, s, nvec) ? __ldg(p + tile * l.span + s * l.stride + l.first)
                                 : make_uint4(0u, 0u, 0u, 0u);
}

// The variants' reduction: a group's butterfly, or the block and cluster sum.
template <int N, bool kClustered>
__device__ __forceinline__ void plane_sum(float (&v)[N], float (&scratch)[N][kMaxWarps],
                                          Exchange<N>& ex, int k, int rank, int group) {
  if (kClustered) {
    block_cluster_sum(v, scratch, ex, k, rank);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = group_sum(v[i], group);
  }
}

// ---------------------------------------------------------------------------
// Forward.

template <typename T, int V, bool kClustered>
__global__ void __launch_bounds__(kMaxThreads)
instance_norm_affine_forward_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                                    const T* __restrict__ bias,
                                    const T* __restrict__ residual, T* __restrict__ y,
                                    float2* __restrict__ stats, int planes, int channels,
                                    int hw, int k, int group_log2, float eps, float slope,
                                    int act) {
  constexpr int kN = Vec<T>::kN;
  __shared__ float scratch_mean[1][kMaxWarps], scratch_var[1][kMaxWarps];
  __shared__ Exchange<1> ex_mean, ex_var;
  const int nvec = hw / kN;
  const Lanes l = lanes_of<V, kClustered>(planes, nvec, k, group_log2);
  const size_t base = static_cast<size_t>(l.plane) * nvec;
  const uint4* xp = reinterpret_cast<const uint4*>(x) + base;
  const float inv_hw = 1.0f / static_cast<float>(hw);
  if (kClustered && k > 1) ready_exchanges(k, ex_mean, ex_var);

  uint4 xr[V];
  if (l.tiles == 1) load_tile(xr, xp, l, 0, nvec);  // held for every pass
  if (kClustered && k > 1) cluster_wait();           // every block's exchanges are ready

  float sum[1] = {0.0f};
  for (int tile = 0; tile < l.tiles; ++tile) {
    if (l.tiles > 1) load_tile(xr, xp, l, tile, nvec);
#pragma unroll
    for (int s = 0; s < V; ++s) {
#pragma unroll
      for (int e = 0; e < kN; ++e) sum[0] += Vec<T>::get(xr[s], e);  // 0 where not loaded
    }
  }
  plane_sum<1, kClustered>(sum, scratch_mean, ex_mean, k, l.rank, l.stride);
  const float mean = sum[0] * inv_hw;

  float ss[1] = {0.0f};
  for (int tile = 0; tile < l.tiles; ++tile) {
    if (l.tiles > 1) load_tile(xr, xp, l, tile, nvec);
#pragma unroll
    for (int s = 0; s < V; ++s) {
      if (!has(l, tile, s, nvec)) continue;
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float d = Vec<T>::get(xr[s], e) - mean;
        ss[0] += d * d;
      }
    }
  }
  plane_sum<1, kClustered>(ss, scratch_var, ex_var, k, l.rank, l.stride);
  const float rstd = rsqrtf(ss[0] * inv_hw + eps);
  if (!l.live) return;  // no shuffle follows
  if (l.first == 0) stats[l.plane] = make_float2(mean, rstd);

  const int c = l.plane % channels;
  const float sc = Vec<T>::scalar(scale + c), bi = Vec<T>::scalar(bias + c);
  const uint4* rp = residual == nullptr ? nullptr : reinterpret_cast<const uint4*>(residual) + base;
  uint4* yp = reinterpret_cast<uint4*>(y) + base;
  for (int tile = 0; tile < l.tiles; ++tile) {
    if (l.tiles > 1) load_tile(xr, xp, l, tile, nvec);
#pragma unroll
    for (int s = 0; s < V; ++s) {
      if (!has(l, tile, s, nvec)) continue;
      const int j = tile * l.span + s * l.stride + l.first;
      const uint4 rv = rp == nullptr ? make_uint4(0u, 0u, 0u, 0u) : __ldg(rp + j);
      float o[kN];
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        float v = Vec<T>::round((Vec<T>::get(xr[s], e) - mean) * rstd);
        v = Vec<T>::round(__fadd_rn(Vec<T>::round(__fmul_rn(v, sc)), bi));
        if (rp != nullptr) v = Vec<T>::round(__fadd_rn(v, Vec<T>::get(rv, e)));
        if (act) v = v > 0.0f ? v : __fmul_rn(v, slope);
        o[e] = v;
      }
      yp[j] = Vec<T>::pack(o);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: dx, dresidual (where given) and each plane's sums of
// dpre * T(xhat) and dpre into partials[0][plane] and partials[1][plane].

// dpre of element e of slot s from the loaded x, y and dy, rounded to T as
// the module's autograd rounds the activation's gradient.
template <typename T>
__device__ __forceinline__ float dpre_of(const uint4& yv, const uint4& gv, int e, float slope,
                                         int act) {
  const float g = Vec<T>::get(gv, e);
  if (!act || Vec<T>::get(yv, e) > 0.0f) return g;
  return Vec<T>::round(__fmul_rn(g, slope));
}

// Loads a tile of x, y and dy and replaces dy by dpre (exact in T, so the
// registers keep its bits).
template <typename T, int V>
__device__ __forceinline__ void load_backward_tile(uint4 (&xr)[V], uint4 (&dr)[V],
                                                   const uint4* xp, const uint4* yp,
                                                   const uint4* gp, const Lanes& l, int tile,
                                                   int nvec, float slope, int act) {
  constexpr int kN = Vec<T>::kN;
  load_tile(xr, xp, l, tile, nvec);
  load_tile(dr, gp, l, tile, nvec);
  if (!act) return;
#pragma unroll
  for (int s = 0; s < V; ++s) {
    if (!has(l, tile, s, nvec)) continue;
    const uint4 yv = __ldg(yp + tile * l.span + s * l.stride + l.first);
    float d[kN];
#pragma unroll
    for (int e = 0; e < kN; ++e) d[e] = dpre_of<T>(yv, dr[s], e, slope, act);
    dr[s] = Vec<T>::pack(d);
  }
}

template <typename T, int V, bool kClustered>
__global__ void __launch_bounds__(kMaxThreads)
instance_norm_affine_backward_kernel(const T* __restrict__ x, const T* __restrict__ y,
                                     const T* __restrict__ dy, const T* __restrict__ scale,
                                     const float2* __restrict__ stats, T* __restrict__ dx,
                                     T* __restrict__ dres, float* __restrict__ partials,
                                     int planes, int channels, int hw, int dy_batch, int k,
                                     int group_log2, float slope, int act) {
  constexpr int kN = Vec<T>::kN;
  __shared__ float scratch[4][kMaxWarps];
  __shared__ Exchange<4> ex;
  const int nvec = hw / kN;
  const Lanes l = lanes_of<V, kClustered>(planes, nvec, k, group_log2);
  const size_t base = static_cast<size_t>(l.plane) * nvec;
  const uint4* xp = reinterpret_cast<const uint4*>(x) + base;
  const uint4* yp = act ? reinterpret_cast<const uint4*>(y) + base : nullptr;
  // dy's planes are contiguous, its samples dy_batch vectors apart (a
  // channel slice of a larger tensor, as torch.cat's backward hands it on)
  const uint4* gp = reinterpret_cast<const uint4*>(dy) +
                    static_cast<size_t>(l.plane / channels) * dy_batch +
                    static_cast<size_t>(l.plane % channels) * nvec;
  const float inv_hw = 1.0f / static_cast<float>(hw);
  const float2 st = stats[l.plane];
  const float mean = st.x, rstd = st.y;
  const float sc = Vec<T>::scalar(scale + l.plane % channels);
  if (kClustered && k > 1) ready_exchanges(k, ex);

  uint4 xr[V], dr[V];  // x, and dpre in dy's place
  if (l.tiles == 1) load_backward_tile<T, V>(xr, dr, xp, yp, gp, l, 0, nvec, slope, act);
  if (kClustered && k > 1) cluster_wait();

  // sum(g), sum(g * xhat), sum(dpre * T(xhat)), sum(dpre)
  float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int tile = 0; tile < l.tiles; ++tile) {
    if (l.tiles > 1) load_backward_tile<T, V>(xr, dr, xp, yp, gp, l, tile, nvec, slope, act);
#pragma unroll
    for (int s = 0; s < V; ++s) {
      if (!has(l, tile, s, nvec)) continue;
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float xhat = (Vec<T>::get(xr[s], e) - mean) * rstd;
        const float dp = Vec<T>::get(dr[s], e);
        const float g = Vec<T>::round(__fmul_rn(dp, sc));
        m[0] += g;
        m[1] += g * xhat;
        m[2] += Vec<T>::round(__fmul_rn(dp, Vec<T>::round(xhat)));
        m[3] += dp;
      }
    }
  }
  plane_sum<4, kClustered>(m, scratch, ex, k, l.rank, l.stride);
  if (!l.live) return;  // no shuffle follows
  if (l.first == 0) {
    partials[l.plane] = m[2];
    partials[planes + l.plane] = m[3];
  }
  const float m1 = m[0] * inv_hw, m2 = m[1] * inv_hw;

  uint4* dp_out = reinterpret_cast<uint4*>(dx) + base;
  uint4* rp_out = dres == nullptr ? nullptr : reinterpret_cast<uint4*>(dres) + base;
  for (int tile = 0; tile < l.tiles; ++tile) {
    if (l.tiles > 1) load_backward_tile<T, V>(xr, dr, xp, yp, gp, l, tile, nvec, slope, act);
#pragma unroll
    for (int s = 0; s < V; ++s) {
      if (!has(l, tile, s, nvec)) continue;
      const int j = tile * l.span + s * l.stride + l.first;
      float o[kN];
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float xhat = (Vec<T>::get(xr[s], e) - mean) * rstd;
        const float g = Vec<T>::round(__fmul_rn(Vec<T>::get(dr[s], e), sc));
        o[e] = rstd * (g - m1 - xhat * m2);
      }
      dp_out[j] = Vec<T>::pack(o);
      if (rp_out != nullptr) rp_out[j] = dr[s];
    }
  }
}

// dscale and dbias: thread i of the grid adds partials[q][n * C + c] over n
// in order, q = i / C (0: dscale, 1: dbias), c = i % C.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
instance_norm_affine_param_grad_kernel(const float* __restrict__ partials,
                                       T* __restrict__ dscale, T* __restrict__ dbias,
                                       int batch, int channels) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * channels) return;
  const int q = i / channels, c = i - q * channels;
  const float* p = partials + static_cast<size_t>(q) * batch * channels + c;
  float total = 0.0f;
  for (int n = 0; n < batch; ++n) total += p[static_cast<size_t>(n) * channels];
  (q == 0 ? dscale : dbias)[c] = from_f32<T>(total);
}

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

cudaError_t last_error(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error
  return err != cudaSuccess ? err : last;
}

// The plan's conditions: 16-byte aligned planes (null ones aside; the
// per-channel parameters are read one element at a time), whole
// vectors per plane, whole warps of at most kMaxThreads threads, 1, 2 or 4
// vectors a thread, a group of at most 32 lanes and 2 vectors a lane that
// covers the plane, or a cluster of at most 8 blocks.
template <typename T>
bool plan_ok(const Plan& p, int planes, int channels, int hw, const void* const* ptrs,
             int n_ptrs) {
  if (planes <= 0 || channels <= 0 || planes % channels || hw <= 0 || hw % Vec<T>::kN)
    return false;
  for (int i = 0; i < n_ptrs; ++i)
    if (ptrs[i] != nullptr && !aligned16(ptrs[i])) return false;
  if (p.threads < 32 || p.threads > kMaxThreads || p.threads % 32) return false;
  if (p.vectors != 1 && p.vectors != 2 && p.vectors != 4) return false;
  if (p.variant == kGroup)
    return is_pow2(p.group) && p.group <= 32 && p.vectors <= kMaxGroupVectors &&
           static_cast<long long>(p.group) * p.vectors * Vec<T>::kN >= hw;
  return p.variant == kCluster && is_pow2(p.cluster) && p.cluster <= kMaxCluster;
}

// The grid: a group's lanes per plane, or a cluster of blocks per plane.
int blocks_of(const Plan& p, int planes) {
  if (p.variant == kGroup)
    return static_cast<int>((static_cast<long long>(planes) * p.group + p.threads - 1) /
                            p.threads);
  return planes * p.cluster;
}

// A plane per cluster of k blocks; k = 1 is an ordinary launch.
template <typename... Params, typename... Args>
cudaError_t launch_kernel(void (*kernel)(Params...), int blocks, int threads, int k,
                          cudaStream_t stream, Args... args) {
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

template <typename T, int V>
cudaError_t forward_v(const Plan& p, int blocks, cudaStream_t stream, const T* x,
                      const T* scale, const T* bias, const T* residual, T* y, float2* stats,
                      int planes, int channels, int hw, float eps, float slope, int act) {
  if constexpr (V <= kMaxGroupVectors) {
    if (p.variant == kGroup)
      return launch_kernel(instance_norm_affine_forward_kernel<T, V, false>, blocks,
                           p.threads, 1, stream, x, scale, bias, residual, y, stats, planes,
                           channels, hw, 1, log2_of(p.group), eps, slope, act);
  }
  return launch_kernel(instance_norm_affine_forward_kernel<T, V, true>, blocks, p.threads,
                       p.cluster, stream, x, scale, bias, residual, y, stats, planes,
                       channels, hw, p.cluster, 0, eps, slope, act);
}

template <typename T>
cudaError_t forward(const void* x, const void* scale, const void* bias, const void* residual,
                    void* y, void* stats, int planes, int channels, int hw, float eps,
                    float slope, int act, cudaStream_t stream, const Plan& p) {
  const void* ptrs[3] = {x, residual, y};
  if (!plan_ok<T>(p, planes, channels, hw, ptrs, 3)) return cudaErrorInvalidValue;
  const int blocks = blocks_of(p, planes);
  const T* xs = static_cast<const T*>(x);
  const T* ss = static_cast<const T*>(scale);
  const T* bs = static_cast<const T*>(bias);
  const T* rs = static_cast<const T*>(residual);
  T* ys = static_cast<T*>(y);
  float2* st = static_cast<float2*>(stats);
  switch (p.vectors) {
    case 1:
      return forward_v<T, 1>(p, blocks, stream, xs, ss, bs, rs, ys, st, planes, channels, hw,
                             eps, slope, act);
    case 2:
      return forward_v<T, 2>(p, blocks, stream, xs, ss, bs, rs, ys, st, planes, channels, hw,
                             eps, slope, act);
    default:
      return forward_v<T, 4>(p, blocks, stream, xs, ss, bs, rs, ys, st, planes, channels, hw,
                             eps, slope, act);
  }
}

template <typename T, int V>
cudaError_t backward_v(const Plan& p, int blocks, cudaStream_t stream, const T* x, const T* y,
                       const T* dy, const T* scale, const float2* stats, T* dx, T* dres,
                       float* partials, int planes, int channels, int hw, int dy_batch,
                       float slope, int act) {
  if constexpr (V <= kMaxGroupVectors) {
    if (p.variant == kGroup)
      return launch_kernel(instance_norm_affine_backward_kernel<T, V, false>, blocks,
                           p.threads, 1, stream, x, y, dy, scale, stats, dx, dres, partials,
                           planes, channels, hw, dy_batch, 1, log2_of(p.group), slope, act);
  }
  return launch_kernel(instance_norm_affine_backward_kernel<T, V, true>, blocks, p.threads,
                       p.cluster, stream, x, y, dy, scale, stats, dx, dres, partials, planes,
                       channels, hw, dy_batch, p.cluster, 0, slope, act);
}

template <typename T>
cudaError_t backward(const void* x, const void* y, const void* dy, const void* scale,
                     const void* stats, void* dx, void* dres, void* partials, int planes,
                     int channels, int hw, int dy_stride, float slope, int act,
                     cudaStream_t stream, const Plan& p) {
  const void* ptrs[5] = {x, y, dy, dx, dres};
  if (!plan_ok<T>(p, planes, channels, hw, ptrs, 5) || (act && y == nullptr) ||
      dy_stride % Vec<T>::kN || dy_stride < channels * hw)
    return cudaErrorInvalidValue;
  const int dy_batch = dy_stride / Vec<T>::kN;
  const int blocks = blocks_of(p, planes);
  const T* xs = static_cast<const T*>(x);
  const T* ys = static_cast<const T*>(y);
  const T* gs = static_cast<const T*>(dy);
  const T* ss = static_cast<const T*>(scale);
  const float2* st = static_cast<const float2*>(stats);
  T* ds = static_cast<T*>(dx);
  T* rs = static_cast<T*>(dres);
  float* ps = static_cast<float*>(partials);
  switch (p.vectors) {
    case 1:
      return backward_v<T, 1>(p, blocks, stream, xs, ys, gs, ss, st, ds, rs, ps, planes,
                              channels, hw, dy_batch, slope, act);
    case 2:
      return backward_v<T, 2>(p, blocks, stream, xs, ys, gs, ss, st, ds, rs, ps, planes,
                              channels, hw, dy_batch, slope, act);
    default:
      return backward_v<T, 4>(p, blocks, stream, xs, ys, gs, ss, st, ds, rs, ps, planes,
                              channels, hw, dy_batch, slope, act);
  }
}

template <typename T>
cudaError_t param_grad(const void* partials, void* dscale, void* dbias, int batch,
                       int channels, cudaStream_t stream) {
  if (batch <= 0 || channels <= 0) return cudaErrorInvalidValue;
  const int blocks = (2 * channels + kMaxThreads - 1) / kMaxThreads;
  instance_norm_affine_param_grad_kernel<T><<<blocks, kMaxThreads, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<T*>(dscale), static_cast<T*>(dbias),
      batch, channels);
  return last_error(cudaSuccess);
}

}  // namespace

// C entry points, bound with ctypes. `x`, `y`, `residual`, `dy`, `dx`,
// `dres`: NCHW-contiguous device buffers of `planes` = N * `channels` planes
// of `hw` elements; `residual` and `dres` may be null (no residual), `y`
// too in a backward without activation; `scale`, `bias`, `dscale`, `dbias`:
// `channels` elements of the same type; `stats`: (mean, rstd) f32 pairs per
// plane; `partials`: f32 [2][planes]. `dy`'s planes are contiguous, its
// samples `dy_stride` elements apart (C * hw when it is contiguous; a
// multiple of the 16-byte vector). `act`: 1 for the LeakyReLU of slope
// `slope`, 0 for none. The last five arguments of the forward and backward
// are the launch plan: variant (0 group, 1 cluster), blocks per cluster,
// threads per block, 16-byte vectors per thread (1, 2 or 4; at most 2 in
// the group variant), lanes per
// plane of the group variant. Each returns the CUDA error of its launch (0 on
// success).
#define INSTANCE_NORM_AFFINE_ENTRIES(SUFFIX, T)                                              \
  extern "C" cudaError_t instance_norm_affine_forward_##SUFFIX(                             \
      const void* x, const void* scale, const void* bias, const void* residual, void* y,    \
      void* stats, int planes, int channels, int hw, float eps, float slope, int act,       \
      cudaStream_t stream, int variant, int cluster, int threads, int vectors, int group) { \
    return forward<T>(x, scale, bias, residual, y, stats, planes, channels, hw, eps, slope, \
                      act, stream, Plan{variant, cluster, threads, vectors, group});        \
  }                                                                                         \
  extern "C" cudaError_t instance_norm_affine_backward_##SUFFIX(                            \
      const void* x, const void* y, const void* dy, const void* scale, const void* stats,   \
      void* dx, void* dres, void* partials, int planes, int channels, int hw,               \
      int dy_stride, float slope, int act, cudaStream_t stream, int variant, int cluster,   \
      int threads, int vectors, int group) {                                                \
    return backward<T>(x, y, dy, scale, stats, dx, dres, partials, planes, channels, hw,    \
                       dy_stride, slope, act, stream,                                       \
                       Plan{variant, cluster, threads, vectors, group});                    \
  }                                                                                         \
  extern "C" cudaError_t instance_norm_affine_param_grad_##SUFFIX(                          \
      const void* partials, void* dscale, void* dbias, int batch, int channels,             \
      cudaStream_t stream) {                                                                \
    return param_grad<T>(partials, dscale, dbias, batch, channels, stream);                 \
  }

INSTANCE_NORM_AFFINE_ENTRIES(f32, float)
INSTANCE_NORM_AFFINE_ENTRIES(bf16, __nv_bfloat16)

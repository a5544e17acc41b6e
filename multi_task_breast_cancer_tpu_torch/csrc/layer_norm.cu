// flax's LayerNorm over the last axis, forward and backward, for Hopper
// (sm_90a).
//
// It replaces no Pallas TPU kernel: the JAX package runs this norm as plain
// jnp arithmetic, which XLA fuses on the TPU. In the PyTorch port the same
// arithmetic in plain torch is about a dozen kernels a forward and some
// thirty a backward, each at the launch floor (every tensor of SwinUNETR's 20
// norm sites at 128^2 and batch 2 is <= 786 KB). This source does a site in
// one launch forward and two backward.
//
// What it computes, per row (a token's C channels, the last axis of a
// contiguous tensor), in f32 for f32 and bf16 input:
//   mean = sum(x) / C,  raw = sum(x^2) / C - mean^2   (flax's fast variance)
//   var  = max(raw, 0),  rstd = rsqrt(var + eps)
//   y    = (x - mean) * (rstd * scale) + bias          (cast to x's type)
// The forward saves (mean, rstd) per row, rstd negated where the clamp was
// active (raw < 0): 8 bytes a row. The backward is the exact gradient of that
// formula, with g = dy * scale and xhat = (x - mean) * rstd:
//   dx     = rstd * (g - mean(g) - xhat * mean(g * xhat))
//            (the last term, the variance's path, is 0 where the clamp was
//            active; at raw == 0 it passes, as torch's clamp does)
//   dscale = sum over rows of dy * xhat,  dbias = sum over rows of dy
//
// Bound: memory, and below it the launch floor. The least traffic is x read
// and y written (forward), x and dy read and dx written (backward), plus the
// per-row statistics and the per-channel parameters; at SwinUNETR's sites that
// is 0.1-0.8 MB a launch, well under a microsecond at 3.35 TB/s.
//
// Design. A plan computed on the host (`_plan` in ops/layer_norm.py) from the
// row count, C and the type gives a group of `group` lanes (a power of two up
// to 32) to each row; each lane holds `vectors` chunks of the row in
// registers, chunk j at lane j % group, so neighbouring lanes load
// neighbouring bytes. A chunk is 16 bytes (4 f32 or 8 bf16): every pointer is
// 16-byte aligned and C a multiple of it (SwinUNETR's widths are multiples of
// 24); the wrapper refuses other rows. Sum(x) and sum(x^2) are taken in the
// one pass the fast variance allows and reduced with butterfly shuffles inside
// the group: no shared memory, no __syncthreads, every lane of the group gets
// the same bits.
//
// The backward writes dx and, in the same kernel, each block's partial column
// sums of dy * xhat and dy: every lane accumulates its channels over the rows
// its group takes, then the block adds its groups' accumulators in group order
// through shared memory. A second launch adds the blocks' partials, a warp per
// column, into dscale and dbias. No atomics: the order of every sum depends on
// the plan alone, so two runs of a step give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSharedBytes = 48 * 1024;  // the backward's column buffer
constexpr int kWarps = 8;                   // columns per block of the parameter gradients

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// A 16-byte chunk of kN elements of T as one load or store, widened to /
// narrowed from f32.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kN = 4;
  __device__ static __forceinline__ void load(const float* p, float (&f)[kN]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  __device__ static __forceinline__ void store(float* p, const float (&f)[kN]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

__device__ __forceinline__ void bf16_unpair(unsigned w, float& lo, float& hi) {
  lo = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w & 0xffffu)));
  hi = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w >> 16)));
}

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static __forceinline__ void load(const __nv_bfloat16* p, float (&f)[kN]) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    bf16_unpair(v.x, f[0], f[1]);
    bf16_unpair(v.y, f[2], f[3]);
    bf16_unpair(v.z, f[4], f[5]);
    bf16_unpair(v.w, f[6], f[7]);
  }
  __device__ static __forceinline__ void store(__nv_bfloat16* p, const float (&f)[kN]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(bf16_pair(f[0], f[1]), bf16_pair(f[2], f[3]),
                                              bf16_pair(f[4], f[5]), bf16_pair(f[6], f[7]));
  }
};

// Butterfly sum over an aligned group of `width` lanes: each step adds the
// same two values on both partners, so every lane ends with the same bits.
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Forward. Global thread t serves row t >> group_log2 as lane t & (group - 1).
// Threads past the last row load nothing but take part in the shuffles.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
layer_norm_forward_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                          const T* __restrict__ bias, T* __restrict__ y,
                          float2* __restrict__ stats, int rows, int c, int group_log2,
                          float eps) {
  constexpr int N = Chunk<T>::kN;
  const int group = 1 << group_log2;
  const int chunks = c / N;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = t >> group_log2;
  const int lane = t & (group - 1);
  const bool live = row < rows;
  const size_t base = static_cast<size_t>(live ? row : 0) * c;

  float xr[V][N];
#pragma unroll
  for (int s = 0; s < V; ++s) {
    const int j = s * group + lane;
    if (live && j < chunks) {
      Chunk<T>::load(x + base + j * N, xr[s]);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) xr[s][e] = 0.0f;
    }
  }
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int s = 0; s < V; ++s) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      s1 += xr[s][e];
      s2 += xr[s][e] * xr[s][e];
    }
  }
  s1 = group_sum(s1, group);
  s2 = group_sum(s2, group);
  const float inv_c = 1.0f / static_cast<float>(c);
  const float mean = s1 * inv_c;
  const float raw = s2 * inv_c - mean * mean;
  const float rstd = rsqrtf(fmaxf(raw, 0.0f) + eps);
  if (!live) return;  // no shuffle follows
  if (lane == 0) stats[row] = make_float2(mean, raw < 0.0f ? -rstd : rstd);
#pragma unroll
  for (int s = 0; s < V; ++s) {
    const int j = s * group + lane;
    if (j >= chunks) continue;
    float sc[N], bi[N], o[N];
    Chunk<T>::load(scale + j * N, sc);
    Chunk<T>::load(bias + j * N, bi);
#pragma unroll
    for (int e = 0; e < N; ++e) o[e] = (xr[s][e] - mean) * (rstd * sc[e]) + bi[e];
    Chunk<T>::store(y + base + j * N, o);
  }
}

// Backward: dx, and the block's column sums of dy * xhat and dy into
// partials[0][col][block] and partials[1][col][block]. The block's groups take rows first + slot, first stepping by the
// grid's rows, so every lane of a warp runs the same iterations.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
layer_norm_backward_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                           const T* __restrict__ scale, const float2* __restrict__ stats,
                           T* __restrict__ dx, float* __restrict__ partials, int rows, int c,
                           int group_log2) {
  constexpr int N = Chunk<T>::kN;
  extern __shared__ float columns[];  // [groups of the block][c]
  const int group = 1 << group_log2;
  const int chunks = c / N;
  const int lane = threadIdx.x & (group - 1);
  const int slot = threadIdx.x >> group_log2;
  const int per_block = blockDim.x >> group_log2;
  const float inv_c = 1.0f / static_cast<float>(c);

  float sc[V][N], acc_scale[V][N], acc_bias[V][N];
#pragma unroll
  for (int s = 0; s < V; ++s) {
    const int j = s * group + lane;
    if (j < chunks) {
      Chunk<T>::load(scale + j * N, sc[s]);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) sc[s][e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) acc_scale[s][e] = acc_bias[s][e] = 0.0f;
  }

  for (int first = blockIdx.x * per_block; first < rows; first += gridDim.x * per_block) {
    const int row = first + slot;
    const bool live = row < rows;
    const size_t base = static_cast<size_t>(live ? row : 0) * c;
    const float2 st = live ? stats[row] : make_float2(0.0f, 1.0f);
    const float mean = st.x, rstd = fabsf(st.y);
    float xh[V][N], gr[V][N];
#pragma unroll
    for (int s = 0; s < V; ++s) {
      const int j = s * group + lane;
      if (live && j < chunks) {
        Chunk<T>::load(x + base + j * N, xh[s]);
        Chunk<T>::load(dy + base + j * N, gr[s]);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) xh[s][e] = gr[s][e] = 0.0f;
      }
    }
    float sg = 0.0f, sgx = 0.0f;
#pragma unroll
    for (int s = 0; s < V; ++s) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        xh[s][e] = (xh[s][e] - mean) * rstd;  // 0 where nothing was loaded
        const float g = gr[s][e] * sc[s][e];
        sg += g;
        sgx += g * xh[s][e];
        acc_scale[s][e] += gr[s][e] * xh[s][e];
        acc_bias[s][e] += gr[s][e];
      }
    }
    sg = group_sum(sg, group);
    sgx = group_sum(sgx, group);
    if (!live) continue;  // the next iteration's rows lie past this one's too
    const float m1 = sg * inv_c;
    const float m2 = st.y > 0.0f ? sgx * inv_c : 0.0f;  // the clamp cut the variance's path
#pragma unroll
    for (int s = 0; s < V; ++s) {
      const int j = s * group + lane;
      if (j >= chunks) continue;
      float o[N];
#pragma unroll
      for (int e = 0; e < N; ++e) o[e] = rstd * (gr[s][e] * sc[s][e] - m1 - xh[s][e] * m2);
      Chunk<T>::store(dx + base + j * N, o);
    }
  }

  // The block's groups' accumulators, added in group order, one quantity at a time.
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    __syncthreads();  // the previous quantity's readers are done
#pragma unroll
    for (int s = 0; s < V; ++s) {
      const int j = s * group + lane;
      if (j >= chunks) continue;
#pragma unroll
      for (int e = 0; e < N; ++e)
        columns[slot * c + j * N + e] = q == 0 ? acc_scale[s][e] : acc_bias[s][e];
    }
    __syncthreads();
    for (int col = threadIdx.x; col < c; col += blockDim.x) {
      float total = columns[col];
      for (int r = 1; r < per_block; ++r) total += columns[r * c + col];
      partials[(static_cast<size_t>(q) * c + col) * gridDim.x + blockIdx.x] = total;
    }
  }
}

// dscale and dbias: warp i adds row i of partials[2C][parts] (dscale's C
// rows, then dbias's), lane l the parts l, l + 32, ... in order, then the 32
// lanes by a butterfly.
template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
layer_norm_param_grad_kernel(const float* __restrict__ partials, T* __restrict__ dscale,
                             T* __restrict__ dbias, int parts, int c) {
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (col >= 2 * c) return;  // a whole warp
  const float* row = partials + static_cast<size_t>(col) * parts;
  float total = 0.0f;
  for (int p = lane; p < parts; p += 32) total += row[p];
  total = group_sum(total, 32);
  if (lane != 0) return;
  if (col < c) {
    dscale[col] = from_f32<T>(total);
  } else {
    dbias[col - c] = from_f32<T>(total);
  }
}

bool is_pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

int log2_of(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

cudaError_t last_error() { return cudaGetLastError(); }

// The plan's conditions: a power-of-two group of at most 32 lanes that
// divides a block of whole warps (at most kMaxThreads threads), whole 16-byte
// chunks that cover the row, and 16-byte aligned pointers.
template <typename T>
bool plan_ok(int rows, int c, int group, int vectors, int threads, int blocks,
             const void* const* ptrs, int n_ptrs) {
  if (rows <= 0 || c <= 0 || blocks <= 0 || !is_pow2(group) || group > 32) return false;
  if (threads < 32 || threads > kMaxThreads || threads % 32 || threads % group) return false;
  if (c % Chunk<T>::kN || static_cast<long long>(group) * vectors * Chunk<T>::kN < c)
    return false;
  for (int i = 0; i < n_ptrs; ++i)
    if (!aligned16(ptrs[i])) return false;
  return true;
}

template <typename T>
cudaError_t forward(const void* x, const void* scale, const void* bias, void* y, void* stats,
                    int rows, int c, float eps, cudaStream_t stream, int group, int vectors,
                    int threads, int blocks) {
  const void* ptrs[4] = {x, scale, bias, y};
  if (!plan_ok<T>(rows, c, group, vectors, threads, blocks, ptrs, 4) ||
      static_cast<long long>(blocks) * threads < static_cast<long long>(rows) * group)
    return cudaErrorInvalidValue;
  const T* xs = static_cast<const T*>(x);
  const T* ss = static_cast<const T*>(scale);
  const T* bs = static_cast<const T*>(bias);
  T* ys = static_cast<T*>(y);
  float2* st = static_cast<float2*>(stats);
  const int gl = log2_of(group);
  switch (vectors) {
    case 1:
      layer_norm_forward_kernel<T, 1><<<blocks, threads, 0, stream>>>(
          xs, ss, bs, ys, st, rows, c, gl, eps);
      return last_error();
    case 2:
      layer_norm_forward_kernel<T, 2><<<blocks, threads, 0, stream>>>(
          xs, ss, bs, ys, st, rows, c, gl, eps);
      return last_error();
    case 4:
      layer_norm_forward_kernel<T, 4><<<blocks, threads, 0, stream>>>(
          xs, ss, bs, ys, st, rows, c, gl, eps);
      return last_error();
    case 8:
      layer_norm_forward_kernel<T, 8><<<blocks, threads, 0, stream>>>(
          xs, ss, bs, ys, st, rows, c, gl, eps);
      return last_error();
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t backward(const void* x, const void* dy, const void* scale, const void* stats,
                     void* dx, void* partials, int rows, int c, cudaStream_t stream, int group,
                     int vectors, int threads, int blocks) {
  const void* ptrs[4] = {x, dy, scale, dx};
  if (!plan_ok<T>(rows, c, group, vectors, threads, blocks, ptrs, 4)) return cudaErrorInvalidValue;
  const size_t shared = static_cast<size_t>(threads / group) * c * sizeof(float);
  if (shared > static_cast<size_t>(kMaxSharedBytes)) return cudaErrorInvalidValue;
  const T* xs = static_cast<const T*>(x);
  const T* gs = static_cast<const T*>(dy);
  const T* ss = static_cast<const T*>(scale);
  const float2* st = static_cast<const float2*>(stats);
  T* ds = static_cast<T*>(dx);
  float* ps = static_cast<float*>(partials);
  const int gl = log2_of(group);
  switch (vectors) {
    case 1:
      layer_norm_backward_kernel<T, 1><<<blocks, threads, shared, stream>>>(
          xs, gs, ss, st, ds, ps, rows, c, gl);
      return last_error();
    case 2:
      layer_norm_backward_kernel<T, 2><<<blocks, threads, shared, stream>>>(
          xs, gs, ss, st, ds, ps, rows, c, gl);
      return last_error();
    case 4:
      layer_norm_backward_kernel<T, 4><<<blocks, threads, shared, stream>>>(
          xs, gs, ss, st, ds, ps, rows, c, gl);
      return last_error();
    case 8:
      layer_norm_backward_kernel<T, 8><<<blocks, threads, shared, stream>>>(
          xs, gs, ss, st, ds, ps, rows, c, gl);
      return last_error();
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t param_grad(const void* partials, void* dscale, void* dbias, int parts, int c,
                       cudaStream_t stream) {
  if (parts <= 0 || c <= 0) return cudaErrorInvalidValue;
  const int blocks = (2 * c + kWarps - 1) / kWarps;
  layer_norm_param_grad_kernel<T><<<blocks, 32 * kWarps, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<T*>(dscale), static_cast<T*>(dbias),
      parts, c);
  return last_error();
}

}  // namespace

// C entry points, bound with ctypes. `x`, `y`, `dy`, `dx`: contiguous device
// buffers of `rows` rows of `c` elements; `scale`, `bias`, `dscale`, `dbias`:
// `c` elements of the same type; `stats`: rows (mean, signed rstd) f32 pairs;
// `partials`: f32 [2][c][blocks] (`parts` the backward's blocks). The last
// four arguments of the forward and backward are the launch plan: lanes per
// row, chunks per lane (1, 2, 4 or 8), threads per block, blocks. Each
// returns the CUDA error of its launch (0 on success).
#define LAYER_NORM_ENTRIES(SUFFIX, T)                                                      \
  extern "C" cudaError_t layer_norm_forward_##SUFFIX(                                     \
      const void* x, const void* scale, const void* bias, void* y, void* stats, int rows, \
      int c, float eps, cudaStream_t stream, int group, int vectors, int threads,         \
      int blocks) {                                                                       \
    return forward<T>(x, scale, bias, y, stats, rows, c, eps, stream, group, vectors,     \
                      threads, blocks);                                                   \
  }                                                                                       \
  extern "C" cudaError_t layer_norm_backward_##SUFFIX(                                    \
      const void* x, const void* dy, const void* scale, const void* stats, void* dx,      \
      void* partials, int rows, int c, cudaStream_t stream, int group, int vectors,       \
      int threads, int blocks) {                                                          \
    return backward<T>(x, dy, scale, stats, dx, partials, rows, c, stream, group,         \
                       vectors, threads, blocks);                                         \
  }                                                                                       \
  extern "C" cudaError_t layer_norm_param_grad_##SUFFIX(                                  \
      const void* partials, void* dscale, void* dbias, int parts, int c,                  \
      cudaStream_t stream) {                                                              \
    return param_grad<T>(partials, dscale, dbias, parts, c, stream);                      \
  }

LAYER_NORM_ENTRIES(f32, float)
LAYER_NORM_ENTRIES(bf16, __nv_bfloat16)

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
// with __float2bfloat16.
//
// Bound: memory. The work is a few flops per element, far below the H100's
// ~20 flops per byte balance point in f32. The least traffic is one read and
// one write of every element: at the flagship's 25 shapes (128^2 input)
// 3,368,960 elements per image, i.e. 26.95 MB per image in f32 and 1.72 GB
// for a batch of 64 (~0.51 ms at the data sheet's 3.35 TB/s).
//
// Design: one thread block per plane; each thread strides over the plane, the
// partial sums reduce with warp shuffles and then across warps through shared
// memory. The kernel reads the plane three times (sum, centred sum of
// squares, normalise+store); a plane is at most 64 KB, so the second and third
// reads mostly hit L1/L2 and device-memory traffic stays near one read and one
// write. Planes of 16 elements (the 4x4 bottleneck) get one warp of 32
// threads, half of it idle, and planes under 256 elements leave most of a
// larger block idle; a later version can give one warp to each small plane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

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
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // earlier readers of `scratch` are done
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? scratch[lane] : 0.0f;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
instance_norm_leaky_relu_kernel(const T* __restrict__ x, T* __restrict__ y,
                                int hw, float eps, float slope) {
  __shared__ float scratch[kMaxThreads / 32];
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
// Bound: memory, like the forward: x and g read once, dx written once, i.e.
// 3 x elements x itemsize. The design is the forward's (a block per plane,
// block sums through warp shuffles), with two more block sums and five reads
// of the plane (mean, variance, the two sums, the store), the later ones
// mostly from L1/L2.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
instance_norm_leaky_relu_backward_kernel(const T* __restrict__ x,
                                         const T* __restrict__ g,
                                         T* __restrict__ dx, int hw, float eps,
                                         float slope) {
  __shared__ float scratch[kMaxThreads / 32];
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

template <typename T>
cudaError_t launch(const void* x, void* y, int planes, int hw, float eps,
                   float slope, cudaStream_t stream) {
  if (planes <= 0 || hw <= 0) return cudaErrorInvalidValue;
  instance_norm_leaky_relu_kernel<T><<<planes, threads_for(hw), 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), hw, eps, slope);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_backward(const void* x, const void* g, void* dx, int planes,
                            int hw, float eps, float slope,
                            cudaStream_t stream) {
  if (planes <= 0 || hw <= 0) return cudaErrorInvalidValue;
  instance_norm_leaky_relu_backward_kernel<T>
      <<<planes, threads_for(hw), 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(g),
          static_cast<T*>(dx), hw, eps, slope);
  return cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes. `x` and `y` are NCHW-contiguous device
// buffers of planes = N*C planes of hw = H*W elements each. Returns the CUDA
// error of the launch (0 on success).
extern "C" cudaError_t instance_norm_leaky_relu_f32(
    const void* x, void* y, int planes, int hw, float eps, float slope,
    cudaStream_t stream) {
  return launch<float>(x, y, planes, hw, eps, slope, stream);
}

extern "C" cudaError_t instance_norm_leaky_relu_bf16(
    const void* x, void* y, int planes, int hw, float eps, float slope,
    cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, y, planes, hw, eps, slope, stream);
}

// Backward entry points: `x` the forward's input, `g` the gradient of the
// output, `dx` the gradient of the input; all NCHW-contiguous device buffers
// of the same type and shape.
extern "C" cudaError_t instance_norm_leaky_relu_backward_f32(
    const void* x, const void* g, void* dx, int planes, int hw, float eps,
    float slope, cudaStream_t stream) {
  return launch_backward<float>(x, g, dx, planes, hw, eps, slope, stream);
}

extern "C" cudaError_t instance_norm_leaky_relu_backward_bf16(
    const void* x, const void* g, void* dx, int planes, int hw, float eps,
    float slope, cudaStream_t stream) {
  return launch_backward<__nv_bfloat16>(x, g, dx, planes, hw, eps, slope,
                                        stream);
}

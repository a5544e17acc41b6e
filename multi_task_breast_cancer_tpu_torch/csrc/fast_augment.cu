// Joint flip + 3-shear rotation of packed augmentation planes, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` (with its helper `_lane_gather`)
// in multi_task_breast_cancer_tpu/ops/fast_augment.py, launched by
// `pallas_pipeline` -> `pl.pallas_call`. One launch per training step when
// `training.fast_augmentation` is on (the default).
//
// What it computes, per sample i and plane p: the source plane
// src = packed[batch_idx[i], p] (an S x S int32 canvas), then three row-wise
// gathers x_k[y, x] = x_{k-1}'[y, idx_k[y, x]] (zero where the index falls
// outside [0, S)), a transpose after the first two, and a final transpose iff
// t1[i]. The Pallas kernel runs those stages in VMEM; its 128-lane tiling
// and the nb^2 tile loop of `_lane_gather` are Mosaic constraints (a gather
// may not cross one vreg) that do not exist here.
//
// Design: the stages compose into ONE gather per output pixel. Tracing the
// output (y, x) back through the stages:
//   (r, c) = t1 ? (x, y) : (y, x)
//   j = idx2[r, c]     (stage 3 reads stage 2's transposed output at (j, r))
//   k = idx1[j, r]     (stage 2 reads stage 1's transposed output at (k, j))
//   m = idx0[k, j]
//   out[y, x] = src[k, m], or 0 if any of j, k, m lies outside [0, S).
// That is pure integer indexing, so the result is bit-identical to the staged
// executor, and no stage is staged in shared memory. One thread per output
// pixel; neighbouring threads write neighbouring pixels. The idx reads are
// row-contiguous for idx2 and scattered for idx1/idx0; the src read is a
// gather.
//
// Bound: memory. Each output pixel costs one int32 write, three index reads
// and one source read, so the least traffic is the selected source planes,
// the three index planes of each sample and the output, read or written once:
// (2 * B * P + 3 * B) * S^2 * 4 bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fast_augment_kernel(const int32_t* __restrict__ packed,
                    const int32_t* __restrict__ batch_idx,
                    const int32_t* __restrict__ idx,
                    const int32_t* __restrict__ t1, int32_t* __restrict__ out,
                    int n, int planes, int s, int64_t total) {
  const int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= total) return;
  const int x = static_cast<int>(o % s);
  int64_t t = o / s;
  const int y = static_cast<int>(t % s);
  t /= s;
  const int p = static_cast<int>(t % planes);
  const int i = static_cast<int>(t / planes);

  const int64_t ss = static_cast<int64_t>(s) * s;
  const int32_t* id = idx + static_cast<int64_t>(i) * 3 * ss;  // idx0 | idx1 | idx2
  const bool transpose = t1[i] > 0;
  const int r = transpose ? x : y;
  const int c = transpose ? y : x;
  const int row = batch_idx[i];

  int32_t v = 0;
  const int j = id[2 * ss + static_cast<int64_t>(r) * s + c];
  if (row >= 0 && row < n && j >= 0 && j < s) {
    const int k = id[ss + static_cast<int64_t>(j) * s + r];
    if (k >= 0 && k < s) {
      const int m = id[static_cast<int64_t>(k) * s + j];
      if (m >= 0 && m < s)
        v = packed[(static_cast<int64_t>(row) * planes + p) * ss +
                   static_cast<int64_t>(k) * s + m];
    }
  }
  out[o] = v;
}

}  // namespace

// C entry point, bound with ctypes. `packed` (n, planes, s, s) int32,
// `batch_idx` (b,) int32, `idx` (b, 3, s, s) int32, `t1` (b,) int32 and `out`
// (b, planes, s, s) int32 are contiguous device buffers. Returns the CUDA
// error of the launch (0 on success).
extern "C" cudaError_t fast_augment_i32(const void* packed, const void* batch_idx,
                                        const void* idx, const void* t1,
                                        void* out, int n, int b, int planes,
                                        int s, cudaStream_t stream) {
  if (n <= 0 || b <= 0 || planes <= 0 || s <= 0) return cudaErrorInvalidValue;
  const int64_t total = static_cast<int64_t>(b) * planes * s * s;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  fast_augment_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(packed), static_cast<const int32_t*>(batch_idx),
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(t1),
      static_cast<int32_t*>(out), n, planes, s, total);
  return cudaGetLastError();
}

// Joint flip + 3-shear rotation of packed augmentation planes, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` (with its helper `_lane_gather`)
// in multi_task_breast_cancer_tpu/ops/fast_augment.py, launched by
// `pallas_pipeline` -> `pl.pallas_call`. One launch per training step when
// `training.fast_augmentation` is on (the default).
//
// What it computes, per sample i and plane p: the source plane
// src = packed[rows[i], p] (an S x S int32 canvas), then three row-wise
// gathers x_k[y, x] = x_{k-1}'[y, idx_k[y, x]] (zero where the index falls
// outside [0, S)), a transpose after the first two, and a final transpose iff
// t1[i]. The Pallas kernel runs those stages in VMEM and takes the index
// planes idx_k as (B, 3, S, S) inputs because Mosaic's gather cannot cross a
// vreg; none of that carries over.
//
// The index planes are affine: idx_k[y, x] = d_k * x + c_k + s_k[y], with
// d_k, c_k scalars and s_k a vector of S per sample (ops/fast_augment.py,
// `pipeline_factors_from_draws`). So the kernel takes those factors,
// 3 * (S + 2) integers per sample, and composes the three stages into one
// gather per output pixel (y, x), in registers:
//   (r, c) = t1 ? (x, y) : (y, x)
//   j = d2 * c + c2 + s2[r]   (stage 3 reads stage 2's transposed output at (j, r))
//   k = d1 * r + c1 + s1[j]   (stage 2 reads stage 1's transposed output at (k, j))
//   m = d0 * j + c0 + s0[k]
//   out[y, x] = src[k, m], or 0 if any of j, k, m lies outside [0, S).
// Pure integer indexing: bit-identical to the staged executor.
//
// Bound: memory. The function reads the selected source planes and the
// factors once and writes the output once: (2*B*P*S^2 + 3*B*(S+2) + 2*B) * 4
// bytes; its integer arithmetic is a dozen operations per pixel. The gathers
// are what stands in the way: neighbouring output pixels read along a rotated
// line of the source, so straight from device memory a warp touches many
// 32-byte sectors for 128 useful bytes. Hence the design:
//
//   - staged (planes up to 128^2): a block stages the whole source plane in
//     shared memory with 16-byte cp.async from every thread (row-sized TMA
//     bulk copies issued by one warp staged 0.5-2 us slower on an H100),
//     rows padded to S + 4 words: the copies stay 16-byte aligned and the
//     bank of (k, m) is 4k + m (mod 32), which spreads a warp's reads along
//     a rotated line (the padding was chosen by emulating the banks over
//     random draws: 2.3 wavefronts per read, 5.3 unpadded). The sample's
//     three s vectors sit beside it; every gather then runs from shared
//     memory. `split` blocks per plane each take a share of the output
//     (each stages the whole plane; the second copy comes from L2).
//   - direct (planes too large for one block's shared memory, 256^2 and
//     up): no staging; the gathers read the source through the read-only
//     cache, many blocks of 8 warps per plane. The s vectors are still
//     staged. A two-block cluster holding half the plane each, read across
//     blocks through distributed shared memory, was 1.7x slower than this
//     at 256^2 on an H100 and was dropped.
//
// A warp computes one segment of an output row (up to 128 pixels) at a
// time, lane l the pixels l + 32q (q = 0..3), so each gather instruction
// follows the rotated line with neighbouring lanes on neighbouring source
// pixels, and what depends on the row alone is computed once per segment.
// Each store instruction writes 32 consecutive pixels, 128 bytes, straight
// from registers. Four consecutive pixels per thread as one 16-byte store,
// through a per-warp buffer in shared memory, measured 0.4 us slower at
// B = 64 on an H100 (the kernel is bound by shared-memory wavefronts, and
// the buffer adds two per 32 pixels).
//
// The output is plane-major, (P, B, S, S): out[p, i] is sample i's plane p,
// so a single-channel slice of the batch is already a contiguous NCHW tensor.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStaged = 0;
constexpr int kDirect = 1;

constexpr int kMaxThreads = 1024;
constexpr int kChunk = 128;          // output pixels per row segment (one warp step)
constexpr int kPad = 4;              // words of padding per staged row
constexpr int kMaxSmem = 232448;     // the H100's shared memory per block (227 KB)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy `rows` rows of `s` int32 from global `src` (row stride s) into shared
// `dst` (row stride `pitch`) with 16-byte cp.async by every thread of the
// block; the block waits with cp_async_wait_all() and __syncthreads().
__device__ __forceinline__ void stage_rows_cp_async(int32_t* dst, const int32_t* src,
                                                    int rows, int s, int pitch) {
  const int per_row = s / 4;
  const int total = rows * per_row;
  for (int v = threadIdx.x; v < total; v += blockDim.x) {
    const int k = v / per_row, e = 4 * (v - k * per_row);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst + k * pitch + e)),
                    "l"(src + static_cast<int64_t>(k) * s + e) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One launch. Block b serves plane-sample t = b / split (t = p * nb + i,
// the plane-major output order) as part b % split.
template <int kVariant>
__global__ void __launch_bounds__(kMaxThreads, 1)
fast_augment_kernel(const int32_t* __restrict__ packed, const int32_t* __restrict__ rows,
                    const int32_t* __restrict__ dv, const int32_t* __restrict__ cv,
                    const int32_t* __restrict__ sv, const int32_t* __restrict__ t1v,
                    int32_t* __restrict__ out, int n, int nb, int planes, int s,
                    int split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pitch = kVariant == kDirect ? s : s + kPad;
  const int held = kVariant == kDirect ? 0 : s;
  int32_t* plane = reinterpret_cast<int32_t*>(smem_raw);
  int32_t* svec = plane + held * pitch;              // s0 | s1 | s2
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int part = blockIdx.x % split;
  const int t = blockIdx.x / split;
  const int i = t % nb, p = t / nb;
  const int64_t ss = static_cast<int64_t>(s) * s;
  int32_t* dst = out + static_cast<int64_t>(t) * ss;
  const int row = __ldg(rows + i);
  const bool valid = row >= 0 && row < n;   // uniform over the block
  const int32_t* src = packed + (static_cast<int64_t>(row) * planes + p) * ss;

  if (kVariant == kStaged && valid) stage_rows_cp_async(plane, src, s, s, pitch);
  const int32_t* svi = sv + static_cast<int64_t>(i) * 3 * s;
  for (int e = threadIdx.x; e < 3 * s; e += blockDim.x) svec[e] = __ldg(svi + e);
  const int d0 = __ldg(dv + 3 * i), d1 = __ldg(dv + 3 * i + 1), d2 = __ldg(dv + 3 * i + 2);
  const int c0 = __ldg(cv + 3 * i), c1 = __ldg(cv + 3 * i + 1), c2 = __ldg(cv + 3 * i + 2);
  const bool tr = __ldg(t1v + i) > 0;
  if (kVariant == kStaged) cp_async_wait_all();
  __syncthreads();

  // Per output row y the composed indices are affine in x up to one table
  // lookup each; what depends on y alone is hoisted out of the pixels:
  //   t1 = 0: j = d2*x + (c2 + s2[y]),          k = s1[j] + (d1*y + c1)
  //   t1 = 1: j = s2[x] + (d2*y + c2),          k = s1[j] + d1*x + c1
  //   both:   m = d0*j + c0 + s0[k]
  const int32_t* s0 = svec;
  const int32_t* s1 = svec + s;
  const int32_t* s2 = svec + 2 * s;
  const unsigned us = static_cast<unsigned>(s);
  const int dj = tr ? 0 : d2, dk = tr ? d1 : 0;
  const int segs = (s + kChunk - 1) / kChunk;   // 128-pixel segments per row
  const int units = s * segs;
  const int lo = units * part / split, hi = units * (part + 1) / split;

  for (int u = lo + warp; u < hi; u += warps) {
    const int y = segs == 1 ? u : u / segs;
    const int x0 = (u - y * segs) * kChunk;
    const int len = min(kChunk, s - x0);
    const int aj = tr ? d2 * y + c2 : c2 + s2[y];
    const int bk = tr ? c1 : d1 * y + c1;
    int32_t* out_row = dst + y * s;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int x = x0 + lane + 32 * q;
      if (lane + 32 * q >= len) continue;
      int32_t v = 0;
      if (valid) {
        int j = dj * x + aj;
        if (tr) j += s2[x];
        bool ok = static_cast<unsigned>(j) < us;
        j = ok ? j : 0;
        int k = dk * x + bk + s1[j];
        ok = ok && static_cast<unsigned>(k) < us;
        k = ok ? k : 0;
        const int m = d0 * j + c0 + s0[k];
        ok = ok && static_cast<unsigned>(m) < us;
        if (ok) {
          if constexpr (kVariant == kDirect)
            v = __ldg(src + k * s + m);
          else
            v = plane[k * pitch + m];
        }
      }
      out_row[x] = v;
    }
  }
}

int smem_bytes(int variant, int s) {
  const int64_t held = variant == kDirect ? 0 : s;
  const int64_t pitch = variant == kDirect ? s : s + kPad;
  const int64_t bytes = 4 * (held * pitch + 3LL * s);
  return bytes > kMaxSmem ? -1 : static_cast<int>(bytes);
}

cudaError_t last_error(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error
  return err != cudaSuccess ? err : last;
}

template <int kVariant, typename... Args>
cudaError_t launch(int blocks, int threads, int smem, cudaStream_t stream, Args... args) {
  auto kernel = fast_augment_kernel<kVariant>;
  static int opted_in = 48 * 1024;  // dynamic shared memory allowed without opting in
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return last_error(err);
    opted_in = kMaxSmem;
  }
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return last_error(cudaSuccess);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// C entry point, bound with ctypes. `packed` (n, planes, s, s) int32, `rows`
// (b,) int32, the factors `d` (b, 3), `c` (b, 3), `s_vec` (b, 3, s) and `t1`
// (b,) int32, and `out` (planes, b, s, s) int32 are contiguous device
// buffers. The plan (`variant`, `split` blocks per plane, `threads` per
// block) is the wrapper's (ops/fast_augment.py, `_plan`); a plan this file
// does not take is refused with cudaErrorInvalidValue, and nothing falls
// back to another variant. Returns the CUDA error of the launch (0 on
// success).
extern "C" cudaError_t fast_augment_i32(const void* packed, const void* rows,
                                        const void* d, const void* c, const void* s_vec,
                                        const void* t1, void* out, int n, int b,
                                        int planes, int s, cudaStream_t stream,
                                        int variant, int split, int threads) {
  if (n <= 0 || b <= 0 || planes <= 0 || s <= 0 || s % 8) return cudaErrorInvalidValue;
  const int64_t units = static_cast<int64_t>(s) * ((s + kChunk - 1) / kChunk);
  const int64_t blocks = static_cast<int64_t>(b) * planes * split;
  if (static_cast<int64_t>(s) * s > 0x7fffffff || threads < 32 || threads > kMaxThreads ||
      threads % 32 || split < 1 || split > units || blocks > 0x7fffffff || !aligned16(out))
    return cudaErrorInvalidValue;
  const int smem = smem_bytes(variant, s);
  if (smem < 0) return cudaErrorInvalidValue;
  const auto* pk = static_cast<const int32_t*>(packed);
  const auto* rw = static_cast<const int32_t*>(rows);
  const auto* dv = static_cast<const int32_t*>(d);
  const auto* cv = static_cast<const int32_t*>(c);
  const auto* sv = static_cast<const int32_t*>(s_vec);
  const auto* tv = static_cast<const int32_t*>(t1);
  auto* o = static_cast<int32_t*>(out);
  const int grid = static_cast<int>(blocks);
  switch (variant) {
    case kStaged:
      if (!aligned16(packed)) return cudaErrorInvalidValue;  // 16-byte cp.async
      return launch<kStaged>(grid, threads, smem, stream, pk, rw, dv, cv, sv, tv, o, n, b,
                             planes, s, split);
    case kDirect:
      return launch<kDirect>(grid, threads, smem, stream, pk, rw, dv, cv, sv, tv, o, n, b,
                             planes, s, split);
    default:
      return cudaErrorInvalidValue;
  }
}

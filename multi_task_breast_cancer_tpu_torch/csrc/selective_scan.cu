// Mamba's selective scan (Gu & Dao 2023, arXiv:2312.00752, Algorithm 2), with
// the softplus of the step, the D skip and the SiLU(z) gate fused in, forward
// and backward, for Hopper (sm_90a).
//
// It replaces no Pallas TPU kernel: the JAX package has no state-space model.
// It is U-Mamba's layer (models/umamba.py), whose recurrence in plain torch is
// a Python loop of several launches a token: ~100k launches a forward at
// U-Mamba_Enc's first stage (16,384 tokens), which no CUDA graph can hold.
//
// What it computes (mamba_ssm's selective_scan_fn with delta_softplus=True and
// z given), per sample b and channel d of d_inner, with N = 16 states, over
// the L steps of the sequence, in f32:
//   delta_l = softplus(dhat_l + delta_bias[d])        (torch's, threshold 20)
//   h_l[n]  = exp(delta_l * A[d,n]) * h_{l-1}[n] + delta_l * u_l * B_l[n]
//   y_l     = sum_n h_l[n] * C_l[n] + D[d] * u_l,      h_{-1} = 0
//   out_l   = y_l * z_l * sigmoid(z_l)
// u, dhat, z and out are (batch, L, d_inner) rows, channels last; B and C are
// (batch, L, 16) rows, shared by the channels. Each tensor comes with its row
// stride, so views into the layer's projections are read in place: z is the
// second half of in_proj's output, and B and C are neighbouring columns of
// x_proj's output, read as one row of 32 ([B | C]).
//
// The backward, with g = dout, sz = sigmoid(z), s = sigmoid(dhat + bias) and
// the adjoint dh_l = dy_l * C_l + exp(delta_{l+1} A) * dh_{l+1} run in reverse:
//   dz  = g * y * sz * (1 + z * (1 - sz)),   dy = g * z * sz
//   du  = dy * D + sum_n dh[n] * delta * B[n]
//   dā[n] = dh[n] * h_{l-1}[n]    (ā = exp(delta * A))
//   ddhat = s * sum_n (dā[n] * ā[n] * A[n] + dh[n] * u * B[n])
//   dA[d,n]  = sum over b, l of dā[n] * ā[n] * delta
//   dB_l[n]  = sum over d of dh[n] * delta * u,   dC_l[n] = sum over d of dy * h_l[n]
//   dD[d]    = sum over b, l of dy * u,           ddelta_bias[d] = sum of ddhat
//
// Bound: latency. A channel's L steps are a chain, and at U-Mamba_Enc's batch
// 2 the first stage has only 2 x 64 channels of 16,384 steps. The least
// traffic (every input read and every output written once) is ~38 MB forward
// at that stage, ~11 us at 3.35 TB/s; the chain takes far longer.
//
// Design. One warp a block: a block owns 32 channels of one sample and walks
// L in chunks, carrying the 16 states of each channel in its lane's registers
// across chunks. Each chunk's rows are staged into shared memory with 4-byte
// cp.async, double-buffered, so the next chunk loads while this one runs; a
// row of [B | C] is read by all 32 lanes from shared memory as a broadcast.
// The forward of a training step saves every state h_l (batch, L, 16, d_inner:
// 16 floats a channel and step, 262 MB at U-Mamba_Enc's batch 2) for the
// backward, which walks L in reverse with the states read back: recomputing
// them from checkpoints would add a forward chain to every backward chunk, and
// the chain, not the bytes, sets the time. Validation saves none.
// The backward reduces each step's 32 per-channel terms of dB and dC over the
// warp with a reduce-scatter (31 shuffles: lane i ends with term i's sum) and
// writes them as the block's partial; dA, dD and the bias's gradient are per
// (sample, channel) partials. A second launch adds the partials in a fixed
// order: dB and dC over the channel groups, the rest over the samples.
// No atomics anywhere: the order of every sum depends on the shapes alone, so
// two runs of a step give the same bits.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kN = 16;          // the states of a channel (d_state)
constexpr int kLanes = 32;      // channels a block: one warp
constexpr int kRow = 2 * kN;    // a staged row of [B | C]
constexpr int kFwdChunk = 32;   // steps a staged chunk, forward (32 KB, double-buffered)
constexpr int kBwdChunk = 8;    // steps a staged chunk, backward (46 KB with the states)
constexpr int kReduceThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x * log2(e))

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float softplus(float x) {  // torch's: beta 1, threshold 20
  return x > 20.f ? x : log1pf(expf(x));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// The layer's tensors: rows of a sample are `stride` elements apart, samples L
// rows apart; `bc` points at B, whose row continues with C.
struct ScanInputs {
  const float* u;
  const float* delta;
  const float* z;
  const float* bc;
  const float* A;           // (d_inner, 16)
  const float* D;           // (d_inner,)
  const float* delta_bias;  // (d_inner,)
  int batch, L, dn;
  int su, sdelta, sz, sbc;
};

struct ForwardOutputs {
  float* out;     // (batch, L, d_inner)
  float* states;  // (batch, L, 16, d_inner), or null: not saved
};

struct BackwardArgs {
  const float* dout;    // rows of `sdout`
  const float* states;  // as the forward saved them
  int sdout;
  float* du;            // (batch, L, d_inner)
  float* ddelta;        // (batch, L, d_inner)
  float* dz;            // (batch, L, d_inner)
  float* part_bc;       // (groups, batch, L, 32): [dB | dC] summed over a block's channels
  float* part_a;        // (batch, d_inner, 16)
  float* part_d;        // (batch, d_inner)
  float* part_bias;     // (batch, d_inner)
};

__global__ void __launch_bounds__(kLanes)
    selective_scan_forward_kernel(ScanInputs in, ForwardOutputs o) {
  __shared__ float s_u[2][kFwdChunk][kLanes];
  __shared__ float s_delta[2][kFwdChunk][kLanes];
  __shared__ float s_z[2][kFwdChunk][kLanes];
  __shared__ float s_bc[2][kFwdChunk][kRow];

  const int lane = threadIdx.x;
  const int b = blockIdx.y;
  const int d = blockIdx.x * kLanes + lane;
  const int L = in.L;
  const size_t row0 = static_cast<size_t>(b) * L;  // the sample's first row
  const float* u = in.u + row0 * in.su + blockIdx.x * kLanes + lane;
  const float* delta = in.delta + row0 * in.sdelta + blockIdx.x * kLanes + lane;
  const float* z = in.z + row0 * in.sz + blockIdx.x * kLanes + lane;
  const float* bc = in.bc + row0 * in.sbc + lane;

  float a[kN], h[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a[n] = in.A[d * kN + n];
    h[n] = 0.f;
  }
  const float dd = in.D[d];
  const float bias = in.delta_bias[d];

  auto stage = [&](int chunk, int buf) {
    const int l0 = chunk * kFwdChunk;
    const int rows = min(kFwdChunk, L - l0);
    for (int r = 0; r < rows; ++r) {
      const size_t l = l0 + r;
      cp_async4(&s_u[buf][r][lane], u + l * in.su);
      cp_async4(&s_delta[buf][r][lane], delta + l * in.sdelta);
      cp_async4(&s_z[buf][r][lane], z + l * in.sz);
      cp_async4(&s_bc[buf][r][lane], bc + l * in.sbc);
    }
    cp_async_commit();
  };

  const int chunks = (L + kFwdChunk - 1) / kFwdChunk;
  stage(0, 0);
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < chunks) {
      stage(c + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const int l0 = c * kFwdChunk;
    const int rows = min(kFwdChunk, L - l0);
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {  // unrolled: only the state update chains the steps
      const float uu = s_u[buf][r][lane];
      const float dt = softplus(s_delta[buf][r][lane] + bias);
      const float zz = s_z[buf][r][lane];
      const float dtu = dt * uu;
      const float dt2 = dt * kLog2e;
      float y = 0.f;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        h[n] = exp2f(dt2 * a[n]) * h[n] + dtu * s_bc[buf][r][n];
        y += h[n] * s_bc[buf][r][kN + n];
      }
      y += dd * uu;
      const size_t row = row0 + l0 + r;
      o.out[row * in.dn + d] = y * (zz / (1.f + expf(-zz)));
      if (o.states != nullptr) {
#pragma unroll
        for (int n = 0; n < kN; ++n) o.states[(row * kN + n) * in.dn + d] = h[n];
      }
    }
    __syncwarp();  // every lane is done with `buf` before it is staged again
  }
}

// v[i] summed over the warp's lanes ends in lane i: at each level a lane keeps
// the half of its values its lane bit selects and adds its partner's copy.
__device__ __forceinline__ float reduce_scatter(float (&v)[kLanes], int lane) {
#pragma unroll
  for (int off = kLanes / 2; off >= 1; off >>= 1) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int j = 0; j < off; ++j) {
      const float send = upper ? v[j] : v[j + off];
      const float keep = upper ? v[j + off] : v[j];
      v[j] = keep + __shfl_xor_sync(kFull, send, off);
    }
  }
  return v[0];
}

__global__ void __launch_bounds__(kLanes)
    selective_scan_backward_kernel(ScanInputs in, BackwardArgs g) {
  __shared__ float s_u[2][kBwdChunk][kLanes];
  __shared__ float s_delta[2][kBwdChunk][kLanes];
  __shared__ float s_z[2][kBwdChunk][kLanes];
  __shared__ float s_g[2][kBwdChunk][kLanes];
  __shared__ float s_bc[2][kBwdChunk][kRow];
  __shared__ float s_h[2][kBwdChunk + 1][kN][kLanes];  // row 0: the state before the chunk

  const int lane = threadIdx.x;
  const int b = blockIdx.y;
  const int group = blockIdx.x;
  const int d = group * kLanes + lane;
  const int L = in.L;
  const size_t row0 = static_cast<size_t>(b) * L;
  const float* u = in.u + row0 * in.su + group * kLanes + lane;
  const float* delta = in.delta + row0 * in.sdelta + group * kLanes + lane;
  const float* z = in.z + row0 * in.sz + group * kLanes + lane;
  const float* bc = in.bc + row0 * in.sbc + lane;
  const float* dout = g.dout + row0 * g.sdout + group * kLanes + lane;
  const float* states = g.states + row0 * kN * in.dn + d;  // + (l * 16 + n) * dn

  float a[kN], dh[kN], da_sum[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a[n] = in.A[d * kN + n];
    dh[n] = 0.f;
    da_sum[n] = 0.f;
  }
  const float dd = in.D[d];
  const float bias = in.delta_bias[d];
  float dd_sum = 0.f, bias_sum = 0.f;

  auto stage = [&](int chunk, int buf) {
    const int l0 = chunk * kBwdChunk;
    const int rows = min(kBwdChunk, L - l0);
    for (int r = 0; r < rows; ++r) {
      const size_t l = l0 + r;
      cp_async4(&s_u[buf][r][lane], u + l * in.su);
      cp_async4(&s_delta[buf][r][lane], delta + l * in.sdelta);
      cp_async4(&s_z[buf][r][lane], z + l * in.sz);
      cp_async4(&s_g[buf][r][lane], dout + l * g.sdout);
      cp_async4(&s_bc[buf][r][lane], bc + l * in.sbc);
#pragma unroll
      for (int n = 0; n < kN; ++n)
        cp_async4(&s_h[buf][r + 1][n][lane], states + (l * kN + n) * in.dn);
    }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      if (l0 > 0) {
        cp_async4(&s_h[buf][0][n][lane], states + (static_cast<size_t>(l0 - 1) * kN + n) * in.dn);
      } else {
        s_h[buf][0][n][lane] = 0.f;
      }
    }
    cp_async_commit();
  };

  const int chunks = (L + kBwdChunk - 1) / kBwdChunk;
  stage(chunks - 1, 0);
  for (int k = 0; k < chunks; ++k) {  // chunks in reverse order
    const int c = chunks - 1 - k;
    const int buf = k & 1;
    if (c > 0) {
      stage(c - 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const int l0 = c * kBwdChunk;
    const int rows = min(kBwdChunk, L - l0);
#pragma unroll 2
    for (int r = rows - 1; r >= 0; --r) {
      const float uu = s_u[buf][r][lane];
      const float pre = s_delta[buf][r][lane] + bias;
      const float dt = softplus(pre);
      const float dt2 = dt * kLog2e;
      const float zz = s_z[buf][r][lane];
      const float gg = s_g[buf][r][lane];
      float y = 0.f;
#pragma unroll
      for (int n = 0; n < kN; ++n) y += s_h[buf][r + 1][n][lane] * s_bc[buf][r][kN + n];
      y += dd * uu;
      const float sz = sigmoid(zz);
      const float dz = gg * y * sz * (1.f + zz * (1.f - sz));
      const float dy = gg * zz * sz;
      dd_sum += dy * uu;
      float du = dy * dd;
      float ddt = 0.f;
      float terms[kLanes];  // [dB | dC] of this channel at this step
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float bn = s_bc[buf][r][n];
        const float hn = s_h[buf][r + 1][n][lane];
        dh[n] += dy * s_bc[buf][r][kN + n];
        terms[kN + n] = dy * hn;
        const float abar = exp2f(dt2 * a[n]);
        const float dabar = dh[n] * s_h[buf][r][n][lane];
        ddt += dabar * abar * a[n] + dh[n] * uu * bn;
        da_sum[n] += dabar * abar * dt;
        du += dh[n] * dt * bn;
        terms[n] = dh[n] * dt * uu;
        dh[n] *= abar;  // the adjoint carried to step l - 1
      }
      const float ddhat = ddt * sigmoid(pre);
      bias_sum += ddhat;
      const size_t row = row0 + l0 + r;
      g.du[row * in.dn + d] = du;
      g.ddelta[row * in.dn + d] = ddhat;
      g.dz[row * in.dn + d] = dz;
      const float part = reduce_scatter(terms, lane);
      g.part_bc[((static_cast<size_t>(group) * in.batch + b) * L + l0 + r) * kRow + lane] = part;
    }
    __syncwarp();
  }
  const size_t bd = static_cast<size_t>(b) * in.dn + d;
#pragma unroll
  for (int n = 0; n < kN; ++n) g.part_a[bd * kN + n] = da_sum[n];
  g.part_d[bd] = dd_sum;
  g.part_bias[bd] = bias_sum;
}

// The partials added in a fixed order: [dB | dC] of each (sample, step) over
// the channel groups, dA, dD and the bias's gradient over the samples.
__global__ void __launch_bounds__(kReduceThreads)
    selective_scan_reduce_kernel(const float* part_bc, const float* part_a,
                                 const float* part_d, const float* part_bias, float* dbc,
                                 float* dA, float* dD, float* dbias, int groups, int batch,
                                 int L, int dn) {
  const size_t n_bc = static_cast<size_t>(batch) * L * kRow;
  const size_t n_a = static_cast<size_t>(dn) * kN;
  const size_t total = n_bc + n_a + 2 * static_cast<size_t>(dn);
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    if (i < n_bc) {
      for (int k = 0; k < groups; ++k) s += part_bc[k * n_bc + i];
      dbc[i] = s;
    } else if (i < n_bc + n_a) {
      const size_t j = i - n_bc;
      for (int k = 0; k < batch; ++k) s += part_a[k * n_a + j];
      dA[j] = s;
    } else {
      const size_t j = i - n_bc - n_a;
      const bool is_d = j < static_cast<size_t>(dn);
      const float* part = is_d ? part_d : part_bias;
      const size_t c = is_d ? j : j - dn;
      for (int k = 0; k < batch; ++k) s += part[static_cast<size_t>(k) * dn + c];
      (is_d ? dD : dbias)[c] = s;
    }
  }
}

ScanInputs inputs(const void* u, const void* delta, const void* z, const void* bc,
                  const void* A, const void* D, const void* delta_bias, int batch, int L,
                  int dn, int su, int sdelta, int sz, int sbc) {
  return ScanInputs{static_cast<const float*>(u), static_cast<const float*>(delta),
                    static_cast<const float*>(z), static_cast<const float*>(bc),
                    static_cast<const float*>(A), static_cast<const float*>(D),
                    static_cast<const float*>(delta_bias), batch, L, dn, su, sdelta, sz, sbc};
}

bool valid(int batch, int L, int dn) {
  return batch > 0 && batch <= 65535 && L > 0 && dn > 0 && dn % kLanes == 0;
}

}  // namespace

extern "C" cudaError_t selective_scan_forward_f32(
    const void* u, const void* delta, const void* z, const void* bc, const void* A,
    const void* D, const void* delta_bias, void* out, void* states, int batch, int L, int dn,
    int su, int sdelta, int sz, int sbc, cudaStream_t stream) {
  if (!valid(batch, L, dn)) return cudaErrorInvalidValue;
  const ScanInputs in = inputs(u, delta, z, bc, A, D, delta_bias, batch, L, dn, su, sdelta, sz,
                               sbc);
  const ForwardOutputs o{static_cast<float*>(out), static_cast<float*>(states)};
  selective_scan_forward_kernel<<<dim3(dn / kLanes, batch), kLanes, 0, stream>>>(in, o);
  return cudaGetLastError();
}

extern "C" cudaError_t selective_scan_backward_f32(
    const void* u, const void* delta, const void* z, const void* bc, const void* A,
    const void* D, const void* delta_bias, const void* dout, const void* states, void* du,
    void* ddelta, void* dz, void* part_bc, void* part_a, void* part_d, void* part_bias,
    int batch, int L, int dn, int su, int sdelta, int sz, int sbc, int sdout,
    cudaStream_t stream) {
  if (!valid(batch, L, dn)) return cudaErrorInvalidValue;
  const ScanInputs in = inputs(u, delta, z, bc, A, D, delta_bias, batch, L, dn, su, sdelta, sz,
                               sbc);
  const BackwardArgs g{static_cast<const float*>(dout), static_cast<const float*>(states),
                       sdout,
                       static_cast<float*>(du), static_cast<float*>(ddelta),
                       static_cast<float*>(dz), static_cast<float*>(part_bc),
                       static_cast<float*>(part_a), static_cast<float*>(part_d),
                       static_cast<float*>(part_bias)};
  selective_scan_backward_kernel<<<dim3(dn / kLanes, batch), kLanes, 0, stream>>>(in, g);
  return cudaGetLastError();
}

extern "C" cudaError_t selective_scan_reduce_f32(
    const void* part_bc, const void* part_a, const void* part_d, const void* part_bias,
    void* dbc, void* dA, void* dD, void* dbias, int groups, int batch, int L, int dn,
    cudaStream_t stream) {
  if (!valid(batch, L, dn) || groups != dn / kLanes) return cudaErrorInvalidValue;
  const size_t total = static_cast<size_t>(batch) * L * kRow + static_cast<size_t>(dn) * kN +
                       2 * static_cast<size_t>(dn);
  const size_t wanted = (total + kReduceThreads - 1) / kReduceThreads;
  const int blocks = static_cast<int>(wanted < 132 * 16 ? wanted : 132 * 16);
  selective_scan_reduce_kernel<<<blocks, kReduceThreads, 0, stream>>>(
      static_cast<const float*>(part_bc), static_cast<const float*>(part_a),
      static_cast<const float*>(part_d), static_cast<const float*>(part_bias),
      static_cast<float*>(dbc), static_cast<float*>(dA), static_cast<float*>(dD),
      static_cast<float*>(dbias), groups, batch, L, dn);
  return cudaGetLastError();
}

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
// Bound: latency, then the special-function unit. A channel's L steps are a
// chain; at U-Mamba_Enc's batch 2 the first stage has only 2 x 64 channels of
// 16,384 steps. The least traffic (every input read and every output written
// once) is ~38 MB forward at that stage, ~11 us at 3.35 TB/s; the exp2f of
// each state and step (65.5M a forward at batch 2, twice with the join below)
// is tens of us on 132 SMs.
//
// Design: segments along L, joined by their decay and end state. The
// recurrence h_l = ā_l h_{l-1} + b_l is linear, so a segment of steps is
// summarised by Σδ over it (its decay on every state is exp(A Σδ)) and its end
// state from a zero start. A warp owns 32 channels (a lane each) and one
// segment of one sample; the warps of a block take neighbouring segments, and
// the blocks of a thread-block cluster neighbouring runs of them. The launch
// plan (ops/selective_scan.py: scan_plan, from batch, d_inner and L alone)
// picks the cluster's blocks (1-16), a block's warps (1-8) and a segment's
// steps, so that U-Mamba_Enc's first stage runs 4 clusters of 16 blocks, one
// a SM by their shared memory, instead of 4 warps on the card. A cluster is
// no larger than lets the card hold all of a launch's clusters at once (an
// H100 holds 7 of 16 blocks, 15 of 8): a cluster left over would run as a
// second wave, doubling the launch's time.
//
// Forward, in one launch:
//   1. each warp scans its segment from a zero state: Σδ and 16 end states a
//      lane, into shared memory;
//   2. each warp folds the summaries of the warps before it in its block,
//      left to right: (Σ, e) then (Σ', e') gives (Σ + Σ', exp(A Σ') e + e');
//      the last warp folds in its own and publishes the block's summary;
//   3. after a cluster barrier each warp folds the summaries of the blocks
//      before its own, block 0 first, from their shared memory (distributed
//      shared memory), then its block's prefix: its segment's start state;
//   4. each warp scans its segment again from that start, with the output
//      (and, for a training step, every state) written.
// Rescan rather than correct the outputs: the correction
// Σ_n C_l[n] exp(A_n cumδ_l) start[n] costs the same exp2f per state and step
// as the rescan, and the saved states would need it too.
// The backward's adjoint is linear as well: each warp first runs its segment
// in reverse from a zero adjoint (Σδ and the adjoint carried out of the
// segment), the summaries are folded right to left the same way (the
// warps after it in its block, then the blocks after its own, the last one
// first), and the warp runs its segment again from the true adjoint with every
// gradient, the states h_l and h_{l-1} read back from the forward's save
// (batch, L, 16, d_inner), one step ahead of their use. The forward of a
// training step saves every state (262 MB at U-Mamba_Enc's batch 2): on an
// H100 (80GB HBM3, 700 W, cold L2) the writes cost 0.048 ms over a step's six
// forwards (0.363 against 0.314 ms without them), ~0.1 ms a step with the
// backward's reads, against recomputing each segment's states in the
// backward.
// Each warp stages its rows into its own shared memory in chunks with 4-byte
// cp.async, double-buffered; a row of [B | C] is read by all 32 lanes as a
// broadcast. The backward reduces each step's 32 per-channel terms of dB and dC
// over the warp with a reduce-scatter (lane i ends with term i's sum) and
// writes them as the block's partial; dA, dD and the bias's gradient are
// summed over a block's warps in order (warp 0 first) into a partial per
// (sample, cluster block, channel). The reduce launch adds the partials in a
// fixed order: dB and dC over the channel groups, the rest over the samples
// and cluster blocks.
// No atomics anywhere, and no look-back: every fold and sum runs in an order
// set by the shapes alone, so two runs of a step give the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kN = 16;           // the states of a channel (d_state)
constexpr int kLanes = 32;       // channels a warp
constexpr int kRow = 2 * kN;     // a staged row of [B | C]
constexpr int kMaxWarps = 8;     // segments a block
constexpr int kMaxCluster = 16;  // blocks a cluster (Hopper's non-portable largest)
constexpr int kChunk = 16;       // steps a staged chunk
constexpr int kFwdRow = 3 * kLanes + kRow;  // u, dhat, z, [B | C]
constexpr int kBwdRow = 4 * kLanes + kRow;  // u, dhat, z, dout, [B | C]
constexpr int kSum = kN + 2;     // a summary: Σδ and 16 states (the backward's partials: 16 + 2)
constexpr int kReduceThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x * log2(e))

// A row's offsets in a staged chunk: [B | C] follows z forward, dout backward.
constexpr int kU = 0, kDelta = kLanes, kZ = 2 * kLanes, kG = 3 * kLanes;
constexpr int kFwdBC = 3 * kLanes, kBwdBC = 4 * kLanes;

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

// The cluster barrier in two halves: a block arrives once it has read the
// other blocks' summaries and waits before it exits, so its own summary stays
// readable until every block of the cluster has read it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
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
  int seg;                  // steps a segment (the plan's)
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
  float* part_bc;       // (groups, batch, L, 32): [dB | dC] summed over a warp's channels
  float* part_a;        // (batch, cluster, d_inner, 16)
  float* part_d;        // (batch, cluster, d_inner)
  float* part_bias;     // (batch, cluster, d_inner)
};

// Where a warp sits: its cluster block, sample, channel and segment [l0, l1).
struct Place {
  int warps, warp, lane, rank, blocks, group, b, d, l0, l1;
};

__device__ __forceinline__ Place place(const ScanInputs& in) {
  const cg::cluster_group cluster = cg::this_cluster();
  Place p;
  p.warps = blockDim.x / kLanes;
  p.warp = threadIdx.x / kLanes;
  p.lane = threadIdx.x % kLanes;
  p.rank = static_cast<int>(cluster.block_rank());
  p.blocks = static_cast<int>(cluster.num_blocks());
  p.group = blockIdx.x / p.blocks;
  p.b = blockIdx.y;
  p.d = p.group * kLanes + p.lane;
  const long long first = static_cast<long long>(p.rank * p.warps + p.warp) * in.seg;
  p.l0 = static_cast<int>(first < in.L ? first : in.L);
  p.l1 = min(p.l0 + in.seg, in.L);
  return p;
}

// Walk the warp's steps [l0, l1) in staged chunks, forward or in reverse:
// `stage(first, rows, buf)` starts the copy of a chunk into buffer `buf`,
// `step(first, rows, buf)` runs it once it has landed.
template <class Stage, class Step>
__device__ __forceinline__ void walk(int l0, int l1, bool reverse, Stage&& stage, Step&& step) {
  const int chunks = (l1 - l0 + kChunk - 1) / kChunk;
  auto first = [&](int k) { return l0 + (reverse ? chunks - 1 - k : k) * kChunk; };
  if (chunks > 0) stage(first(0), min(kChunk, l1 - first(0)), 0);
  for (int k = 0; k < chunks; ++k) {
    if (k + 1 < chunks) {
      stage(first(k + 1), min(kChunk, l1 - first(k + 1)), (k + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    step(first(k), min(kChunk, l1 - first(k)), k & 1);
    __syncwarp();  // every lane is done with the buffer before it is staged again
  }
}

// acc = exp(A Σ) acc + e, Σacc += Σ: a summary (Σ, e) folded onto acc.
__device__ __forceinline__ void fold(float& acc_dt, float (&acc)[kN], const float (&a)[kN],
                                     const float* summary, int lane) {
  const float sdt = summary[lane];
  const float dt2 = sdt * kLog2e;
#pragma unroll
  for (int n = 0; n < kN; ++n) acc[n] = exp2f(dt2 * a[n]) * acc[n] + summary[(1 + n) * kLanes + lane];
  acc_dt += sdt;
}

// The state a warp's segment starts from (forward: the segments before it;
// reverse: the adjoint entering from the segments after it), from the
// summaries its block's warps put in `sums` ([warps][kSum][32]) and the
// blocks' summaries in `total` ([kSum][32]) of each block of the cluster.
// `own` is the warp's own summary (Σδ, state from zero).
__device__ __forceinline__ void join(const Place& p, bool reverse, const float (&a)[kN], float own_dt,
                     const float (&own)[kN], float* sums, float* total, float (&start)[kN]) {
  float* mine = sums + p.warp * kSum * kLanes;
  mine[p.lane] = own_dt;
#pragma unroll
  for (int n = 0; n < kN; ++n) mine[(1 + n) * kLanes + p.lane] = own[n];
  __syncthreads();
  // the block's warps ahead of this one, the farthest first
  float pdt = 0.f, pre[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) pre[n] = 0.f;
  if (!reverse) {
    for (int i = 0; i < p.warp; ++i) fold(pdt, pre, a, sums + i * kSum * kLanes, p.lane);
  } else {
    for (int i = p.warps - 1; i > p.warp; --i) fold(pdt, pre, a, sums + i * kSum * kLanes, p.lane);
  }
  if (p.warp == (reverse ? 0 : p.warps - 1)) {  // the block's summary: the prefix, then its own
    float tdt = pdt, t[kN];
#pragma unroll
    for (int n = 0; n < kN; ++n) t[n] = pre[n];
    fold(tdt, t, a, mine, p.lane);
    total[p.lane] = tdt;
#pragma unroll
    for (int n = 0; n < kN; ++n) total[(1 + n) * kLanes + p.lane] = t[n];
  }
  const cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  // the cluster's blocks ahead of this one, the farthest first
  float qdt = 0.f;
#pragma unroll
  for (int n = 0; n < kN; ++n) start[n] = 0.f;
  if (!reverse) {
    for (int k = 0; k < p.rank; ++k) fold(qdt, start, a, cluster.map_shared_rank(total, k), p.lane);
  } else {
    for (int k = p.blocks - 1; k > p.rank; --k)
      fold(qdt, start, a, cluster.map_shared_rank(total, k), p.lane);
  }
  cluster_arrive();
  // then through the block's warps ahead of this one
  const float dt2 = pdt * kLog2e;
#pragma unroll
  for (int n = 0; n < kN; ++n) start[n] = exp2f(dt2 * a[n]) * start[n] + pre[n];
}

__global__ void __launch_bounds__(kMaxWarps * kLanes, 1)
    selective_scan_forward_kernel(ScanInputs in, ForwardOutputs o) {
  extern __shared__ float smem[];
  const Place p = place(in);
  float* rows = smem + p.warp * 2 * kChunk * kFwdRow;  // this warp's two chunks
  float* sums = smem + p.warps * 2 * kChunk * kFwdRow;
  float* total = sums + p.warps * kSum * kLanes;
  const int lane = p.lane, d = p.d;
  const size_t row0 = static_cast<size_t>(p.b) * in.L;  // the sample's first row
  const size_t col = static_cast<size_t>(p.group) * kLanes + lane;
  const float* u = in.u + row0 * in.su + col;
  const float* delta = in.delta + row0 * in.sdelta + col;
  const float* z = in.z + row0 * in.sz + col;
  const float* bc = in.bc + row0 * in.sbc + lane;

  float a[kN], h[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a[n] = in.A[d * kN + n];
    h[n] = 0.f;
  }
  const float dd = in.D[d];
  const float bias = in.delta_bias[d];

  auto stage = [&](int first, int count, int buf) {
    float* dst = rows + buf * kChunk * kFwdRow;
    for (int r = 0; r < count; ++r) {
      const size_t l = first + r;
      float* row = dst + r * kFwdRow;
      cp_async4(row + kU + lane, u + l * in.su);
      cp_async4(row + kDelta + lane, delta + l * in.sdelta);
      cp_async4(row + kZ + lane, z + l * in.sz);
      cp_async4(row + kFwdBC + lane, bc + l * in.sbc);
    }
    cp_async_commit();
  };

  // 1. the segment from a zero state: Σδ and the end states
  float sdt = 0.f;
  walk(p.l0, p.l1, false, stage, [&](int, int count, int buf) {
    const float* chunk = rows + buf * kChunk * kFwdRow;
#pragma unroll 4
    for (int r = 0; r < count; ++r) {
      const float* row = chunk + r * kFwdRow;
      const float dt = softplus(row[kDelta + lane] + bias);
      const float dtu = dt * row[kU + lane];
      const float dt2 = dt * kLog2e;
      sdt += dt;
#pragma unroll
      for (int n = 0; n < kN; ++n) h[n] = exp2f(dt2 * a[n]) * h[n] + dtu * row[kFwdBC + n];
    }
  });
  // 2-3. the start state from the segments before this one
  join(p, false, a, sdt, h, sums, total, h);
  // 4. the segment again from its start, with the output and the states
  walk(p.l0, p.l1, false, stage, [&](int first, int count, int buf) {
    const float* chunk = rows + buf * kChunk * kFwdRow;
#pragma unroll 4
    for (int r = 0; r < count; ++r) {  // unrolled: only the state update chains the steps
      const float* row = chunk + r * kFwdRow;
      const float uu = row[kU + lane];
      const float dt = softplus(row[kDelta + lane] + bias);
      const float zz = row[kZ + lane];
      const float dtu = dt * uu;
      const float dt2 = dt * kLog2e;
      float y = 0.f;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        h[n] = exp2f(dt2 * a[n]) * h[n] + dtu * row[kFwdBC + n];
        y += h[n] * row[kFwdBC + kN + n];
      }
      y += dd * uu;
      const size_t step = row0 + first + r;
      o.out[step * in.dn + d] = y * (zz / (1.f + expf(-zz)));
      if (o.states != nullptr) {
#pragma unroll
        for (int n = 0; n < kN; ++n) o.states[(step * kN + n) * in.dn + d] = h[n];
      }
    }
  });
  cluster_wait();
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

__global__ void __launch_bounds__(kMaxWarps * kLanes, 1)
    selective_scan_backward_kernel(ScanInputs in, BackwardArgs g) {
  extern __shared__ float smem[];
  const Place p = place(in);
  float* rows = smem + p.warp * 2 * kChunk * kBwdRow;
  float* sums = smem + p.warps * 2 * kChunk * kBwdRow;
  float* total = sums + p.warps * kSum * kLanes;
  const int lane = p.lane, d = p.d;
  const size_t row0 = static_cast<size_t>(p.b) * in.L;
  const size_t col = static_cast<size_t>(p.group) * kLanes + lane;
  const float* u = in.u + row0 * in.su + col;
  const float* delta = in.delta + row0 * in.sdelta + col;
  const float* z = in.z + row0 * in.sz + col;
  const float* bc = in.bc + row0 * in.sbc + lane;
  const float* dout = g.dout + row0 * g.sdout + col;
  const float* states = g.states + row0 * kN * in.dn + d;  // + (l * 16 + n) * dn

  float a[kN], dh[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a[n] = in.A[d * kN + n];
    dh[n] = 0.f;
  }
  const float dd = in.D[d];
  const float bias = in.delta_bias[d];

  auto stage = [&](int first, int count, int buf) {
    float* dst = rows + buf * kChunk * kBwdRow;
    for (int r = 0; r < count; ++r) {
      const size_t l = first + r;
      float* row = dst + r * kBwdRow;
      cp_async4(row + kU + lane, u + l * in.su);
      cp_async4(row + kDelta + lane, delta + l * in.sdelta);
      cp_async4(row + kZ + lane, z + l * in.sz);
      cp_async4(row + kG + lane, dout + l * g.sdout);
      cp_async4(row + kBwdBC + lane, bc + l * in.sbc);
    }
    cp_async_commit();
  };

  // 1. the segment in reverse from a zero adjoint: Σδ and the adjoint it
  // carries out to the step before it
  float sdt = 0.f;
  walk(p.l0, p.l1, true, stage, [&](int, int count, int buf) {
    const float* chunk = rows + buf * kChunk * kBwdRow;
#pragma unroll 4
    for (int r = count - 1; r >= 0; --r) {
      const float* row = chunk + r * kBwdRow;
      const float dt = softplus(row[kDelta + lane] + bias);
      const float dt2 = dt * kLog2e;
      const float zz = row[kZ + lane];
      const float dy = row[kG + lane] * zz * sigmoid(zz);
      sdt += dt;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        dh[n] += dy * row[kBwdBC + kN + n];
        dh[n] *= exp2f(dt2 * a[n]);
      }
    }
  });
  // 2-3. the adjoint entering from the segments after this one
  join(p, true, a, sdt, dh, sums, total, dh);
  // 4. the segment again in reverse from that adjoint, with every gradient;
  // h_l and h_{l-1} read from the saved states, the one before them in flight
  float da_sum[kN], hc[kN], hp[kN], hn[kN];
  auto load = [&](int l, float (&h)[kN]) {
#pragma unroll
    for (int n = 0; n < kN; ++n)
      h[n] = l >= 0 ? states[(static_cast<size_t>(l) * kN + n) * in.dn] : 0.f;
  };
#pragma unroll
  for (int n = 0; n < kN; ++n) da_sum[n] = 0.f;
  if (p.l1 > p.l0) {
    load(p.l1 - 1, hc);
    load(p.l1 - 2, hp);
  }
  float dd_sum = 0.f, bias_sum = 0.f;
  walk(p.l0, p.l1, true, stage, [&](int first, int count, int buf) {
    const float* chunk = rows + buf * kChunk * kBwdRow;
#pragma unroll 2
    for (int r = count - 1; r >= 0; --r) {
      const int l = first + r;
      load(l - 2, hn);
      const float* row = chunk + r * kBwdRow;
      const float* brow = row + kBwdBC;
      const float uu = row[kU + lane];
      const float pre = row[kDelta + lane] + bias;
      const float dt = softplus(pre);
      const float dt2 = dt * kLog2e;
      const float zz = row[kZ + lane];
      const float gg = row[kG + lane];
      float y = 0.f;
#pragma unroll
      for (int n = 0; n < kN; ++n) y += hc[n] * brow[kN + n];
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
        const float bn = brow[n];
        dh[n] += dy * brow[kN + n];
        terms[kN + n] = dy * hc[n];
        const float abar = exp2f(dt2 * a[n]);
        const float dabar = dh[n] * hp[n];
        ddt += dabar * abar * a[n] + dh[n] * uu * bn;
        da_sum[n] += dabar * abar * dt;
        du += dh[n] * dt * bn;
        terms[n] = dh[n] * dt * uu;
        dh[n] *= abar;  // the adjoint carried to step l - 1
      }
      const float ddhat = ddt * sigmoid(pre);
      bias_sum += ddhat;
      const size_t step = row0 + l;
      g.du[step * in.dn + d] = du;
      g.ddelta[step * in.dn + d] = ddhat;
      g.dz[step * in.dn + d] = dz;
      const float part = reduce_scatter(terms, lane);
      g.part_bc[((static_cast<size_t>(p.group) * in.batch + p.b) * in.L + l) * kRow + lane] = part;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        hc[n] = hp[n];
        hp[n] = hn[n];
      }
    }
  });
  // the block's partials of dA, dD and the bias's gradient, its warps in order
  // (every warp is past its reads of `sums`: the join's cluster barrier)
  float* mine = sums + p.warp * kSum * kLanes;
#pragma unroll
  for (int n = 0; n < kN; ++n) mine[n * kLanes + lane] = da_sum[n];
  mine[kN * kLanes + lane] = dd_sum;
  mine[(kN + 1) * kLanes + lane] = bias_sum;
  __syncthreads();
  if (p.warp == 0) {
    const size_t part = (static_cast<size_t>(p.b) * p.blocks + p.rank) * in.dn + d;
    for (int k = 0; k < kSum; ++k) {
      float s = 0.f;
      for (int w = 0; w < p.warps; ++w) s += sums[(w * kSum + k) * kLanes + lane];
      if (k < kN) {
        g.part_a[part * kN + k] = s;
      } else {
        (k == kN ? g.part_d : g.part_bias)[part] = s;
      }
    }
  }
  cluster_wait();
}

// The partials added in a fixed order: [dB | dC] of each (sample, step) over
// the channel groups, dA, dD and the bias's gradient over the samples' cluster
// blocks (`parts` of them).
__global__ void __launch_bounds__(kReduceThreads)
    selective_scan_reduce_kernel(const float* part_bc, const float* part_a,
                                 const float* part_d, const float* part_bias, float* dbc,
                                 float* dA, float* dD, float* dbias, int groups, int parts,
                                 int batch, int L, int dn) {
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
      for (int k = 0; k < parts; ++k) s += part_a[k * n_a + j];
      dA[j] = s;
    } else {
      const size_t j = i - n_bc - n_a;
      const bool is_d = j < static_cast<size_t>(dn);
      const float* part = is_d ? part_d : part_bias;
      const size_t c = is_d ? j : j - dn;
      for (int k = 0; k < parts; ++k) s += part[static_cast<size_t>(k) * dn + c];
      (is_d ? dD : dbias)[c] = s;
    }
  }
}

ScanInputs inputs(const void* u, const void* delta, const void* z, const void* bc,
                  const void* A, const void* D, const void* delta_bias, int batch, int L,
                  int dn, int su, int sdelta, int sz, int sbc, int seg) {
  return ScanInputs{static_cast<const float*>(u), static_cast<const float*>(delta),
                    static_cast<const float*>(z), static_cast<const float*>(bc),
                    static_cast<const float*>(A), static_cast<const float*>(D),
                    static_cast<const float*>(delta_bias), batch, L, dn, su, sdelta, sz, sbc,
                    seg};
}

// The plan (cluster blocks, warps a block, steps a segment) covers the steps.
bool valid(int batch, int L, int dn, int cluster, int warps, int seg) {
  return batch > 0 && batch <= 65535 && L > 0 && dn > 0 && dn % kLanes == 0 && cluster >= 1 &&
         cluster <= kMaxCluster && warps >= 1 && warps <= kMaxWarps && seg >= 1 &&
         static_cast<long long>(cluster) * warps * seg >= L;
}

size_t forward_smem(int warps) {
  return sizeof(float) * (static_cast<size_t>(warps) * 2 * kChunk * kFwdRow +
                          static_cast<size_t>(warps + 1) * kSum * kLanes);
}

size_t backward_smem(int warps) {
  return sizeof(float) * (static_cast<size_t>(warps) * 2 * kChunk * kBwdRow +
                          static_cast<size_t>(warps + 1) * kSum * kLanes);
}

// Both scan kernels may take the most shared memory and clusters of 16,
// set once a device.
cudaError_t configure() {
  constexpr int kDevices = 64;
  static bool done[kDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kDevices && done[device]) return cudaSuccess;
  const void* kernels[2] = {reinterpret_cast<const void*>(selective_scan_forward_kernel),
                            reinterpret_cast<const void*>(selective_scan_backward_kernel)};
  const size_t smem[2] = {forward_smem(kMaxWarps), backward_smem(kMaxWarps)};
  for (int i = 0; i < 2; ++i) {
    err = cudaFuncSetAttribute(kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem[i]));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernels[i], cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  if (device < kDevices) done[device] = true;
  return cudaSuccess;
}

struct Launch {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute cluster;
};

// A scan launch: blocks (d_inner / 32 x cluster, batch) of `warps` warps, in
// clusters of `cluster` blocks along x.
void plan_launch(Launch& l, int batch, int dn, int cluster, int warps, size_t smem,
                 cudaStream_t stream) {
  l.config = cudaLaunchConfig_t{};
  l.config.gridDim = dim3(static_cast<unsigned>(dn / kLanes * cluster),
                          static_cast<unsigned>(batch), 1);
  l.config.blockDim = dim3(static_cast<unsigned>(warps * kLanes), 1, 1);
  l.config.dynamicSmemBytes = smem;
  l.config.stream = stream;
  l.cluster.id = cudaLaunchAttributeClusterDimension;
  l.cluster.val.clusterDim.x = static_cast<unsigned>(cluster);
  l.cluster.val.clusterDim.y = 1;
  l.cluster.val.clusterDim.z = 1;
  l.config.attrs = &l.cluster;
  l.config.numAttrs = 1;
}

}  // namespace

extern "C" cudaError_t selective_scan_forward_f32(
    const void* u, const void* delta, const void* z, const void* bc, const void* A,
    const void* D, const void* delta_bias, void* out, void* states, int batch, int L, int dn,
    int su, int sdelta, int sz, int sbc, int cluster, int warps, int seg, cudaStream_t stream) {
  if (!valid(batch, L, dn, cluster, warps, seg)) return cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return err;
  const ScanInputs in = inputs(u, delta, z, bc, A, D, delta_bias, batch, L, dn, su, sdelta, sz,
                               sbc, seg);
  const ForwardOutputs o{static_cast<float*>(out), static_cast<float*>(states)};
  Launch l;
  plan_launch(l, batch, dn, cluster, warps, forward_smem(warps), stream);
  err = cudaLaunchKernelEx(&l.config, selective_scan_forward_kernel, in, o);
  return err != cudaSuccess ? err : cudaGetLastError();
}

extern "C" cudaError_t selective_scan_backward_f32(
    const void* u, const void* delta, const void* z, const void* bc, const void* A,
    const void* D, const void* delta_bias, const void* dout, const void* states, void* du,
    void* ddelta, void* dz, void* part_bc, void* part_a, void* part_d, void* part_bias,
    int batch, int L, int dn, int su, int sdelta, int sz, int sbc, int sdout, int cluster,
    int warps, int seg, cudaStream_t stream) {
  if (!valid(batch, L, dn, cluster, warps, seg)) return cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return err;
  const ScanInputs in = inputs(u, delta, z, bc, A, D, delta_bias, batch, L, dn, su, sdelta, sz,
                               sbc, seg);
  const BackwardArgs g{static_cast<const float*>(dout), static_cast<const float*>(states),
                       sdout,
                       static_cast<float*>(du), static_cast<float*>(ddelta),
                       static_cast<float*>(dz), static_cast<float*>(part_bc),
                       static_cast<float*>(part_a), static_cast<float*>(part_d),
                       static_cast<float*>(part_bias)};
  Launch l;
  plan_launch(l, batch, dn, cluster, warps, backward_smem(warps), stream);
  err = cudaLaunchKernelEx(&l.config, selective_scan_backward_kernel, in, g);
  return err != cudaSuccess ? err : cudaGetLastError();
}

extern "C" cudaError_t selective_scan_reduce_f32(
    const void* part_bc, const void* part_a, const void* part_d, const void* part_bias,
    void* dbc, void* dA, void* dD, void* dbias, int groups, int parts, int batch, int L,
    int dn, cudaStream_t stream) {
  if (batch <= 0 || L <= 0 || dn <= 0 || dn % kLanes || groups != dn / kLanes ||
      parts < batch || parts % batch)
    return cudaErrorInvalidValue;
  const size_t total = static_cast<size_t>(batch) * L * kRow + static_cast<size_t>(dn) * kN +
                       2 * static_cast<size_t>(dn);
  const size_t wanted = (total + kReduceThreads - 1) / kReduceThreads;
  const int blocks = static_cast<int>(wanted < 132 * 16 ? wanted : 132 * 16);
  selective_scan_reduce_kernel<<<blocks, kReduceThreads, 0, stream>>>(
      static_cast<const float*>(part_bc), static_cast<const float*>(part_a),
      static_cast<const float*>(part_d), static_cast<const float*>(part_bias),
      static_cast<float*>(dbc), static_cast<float*>(dA), static_cast<float*>(dD),
      static_cast<float*>(dbias), groups, parts, batch, L, dn);
  return cudaGetLastError();
}

// For a plan's `cluster` and `warps`: the blocks of each scan kernel one SM
// holds at once, the clusters the card holds at once and each kernel's
// dynamic shared memory, into host memory `out` (forward blocks, backward
// blocks, forward clusters, backward clusters, forward bytes, backward bytes).
extern "C" cudaError_t selective_scan_occupancy(int cluster, int warps, int* out,
                                                cudaStream_t stream) {
  if (cluster < 1 || cluster > kMaxCluster || warps < 1 || warps > kMaxWarps)
    return cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return err;
  const void* kernels[2] = {reinterpret_cast<const void*>(selective_scan_forward_kernel),
                            reinterpret_cast<const void*>(selective_scan_backward_kernel)};
  const size_t smem[2] = {forward_smem(warps), backward_smem(warps)};
  for (int i = 0; i < 2; ++i) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[i], kernels[i], warps * kLanes,
                                                        smem[i]);
    if (err != cudaSuccess) return err;
    Launch l;
    plan_launch(l, 1, kLanes, cluster, warps, smem[i], stream);
    err = cudaOccupancyMaxActiveClusters(&out[2 + i], kernels[i], &l.config);
    if (err != cudaSuccess) return err;
    out[4 + i] = static_cast<int>(smem[i]);
  }
  return cudaSuccess;
}

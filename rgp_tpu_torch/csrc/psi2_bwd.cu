// K2: fused RBF Psi2 time sum, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rgp_tpu/ops/pallas/psi2.py::_psi2_bwd_kernel
// (launched by _psi2_bwd_raw) and the glue around it (_bwd). With P[t,m,n]
// recomputed from the forward's decomposition (see psi2_fwd.cu), the
// cotangent g of out = sum_t P[t], Gs = g + g^T and PGs = P * Gs:
//
//   dE[t,m]   = sum_n PGs[t,m,n]
//   dbase[t]  = 1/2 sum_m dE[t,m]
//   S[t,m,q]  = sum_n PGs[t,m,n] z[n,q]
//   dw[t,q]   = -1/4 sum_m z[m,q] S[t,m,q]
//   dzC[m,q]  = -1/2 sum_t w[t,q] S[t,m,q]     (the C term's direct dZ)
//   dD1[m,n]  = -out[m,n] Gs[m,n] for m < n, -out[m,m] g[m,m] on the
//               diagonal and 0 for m > n: K1 computes out from the upper
//               triangle of D1 and mirrors it, so that is its exact VJP
//               (for a symmetric D1 the chain rule gives the same as
//               -out * g)
//
// Neither the (T, M, M) tensor nor the (T, M, Q) tensor S reaches device
// memory, and one launch computes all six outputs.
//
// What bounds it on this card: per element (t, m, n) this kernel does about
// 4Q+8 FP32 operations plus one exp (Q FFMAs to rebuild C, Q to accumulate S,
// and the exp's argument, the product with Gs and the dE sum), over T*M^2
// elements. PGs is symmetric in (m, n), so the least the function needs is
// T*M(M+1)/2 pairs, each one C, one exp and the S and dE updates of both
// rows: about 6Q+10 operations plus the exp, three quarters of this kernel's
// work at Q = 32. Walking every n instead keeps each S and dE row inside one
// thread, with no cross-block sum of rows. Its bytes are O(TM + M^2 + TQ +
// MQ), negligible. So it is bound by FP32 issue. At config 1 (T=512, M=100,
// Q<=20) the work is a few microseconds and the launch is a large share of it.
//
// What the design does about it:
//  * Layout. A block owns 32 m rows (one per lane) and a T range; its 8 warps
//    take 8 timesteps at a time (a stage). Each thread (t, m) keeps w[t,:]
//    z[m,:] and S[t,m,:] in registers and walks every n, so P and PGs live
//    only in registers and dE[t,m] is complete inside the block. The thread
//    holds each z row it reads (Q <= 32) between the C and the S loop, so a z
//    row is read from shared memory once per (t, m, n).
//  * t-invariant operands resident. Z and the block's transposed D1 and Gs
//    rows (padded to 33 words, so lanes read consecutive banks) are staged
//    into dynamic shared memory once per block (cp.async for the copies; Gs
//    is formed as g[m,n] + g[n,m] from g's own strides, so a dense, expanded
//    or transposed cotangent is read as it is). Per stage only the w rows,
//    base and the E rows are staged, by cp.async into a ring of two buffers,
//    so stage k+1 is in flight while stage k computes; the n loop has no
//    barrier. The host picks the ring depth and the block's n width from the
//    card's shared memory: two buffers if two blocks per SM still fit, one if
//    only that keeps two blocks per SM, and if the rows of one block do not
//    fit at all (large M or Q), the kernel streams its n columns in chunks
//    and re-stages them per stage, as the first version did. No shape with
//    Q <= 128 is refused.
//  * Occupancy. __launch_bounds__(256, 2) for Q <= 32: at most 128
//    registers, two 256-thread blocks per SM. The dzC partial lives in shared
//    memory (the warps add their timestep's w S in warp order), not in
//    registers. The Q = 128 instance keeps one block per SM.
//  * No Q test in the n loop. Q runs at the compile-time width qmax_of(Q)
//    (4, 8, 20, 32 or 128, as in psi2_fwd.cu), the rows are zero-padded to
//    it, and the q loops cover it whole: a run-time Q test cost a predicate
//    per float4 and the registers that pushed Q = 32 into spills. The loop
//    takes two n a pass, so two exp chains are in flight.
//  * One launch, deterministic. dbase and dw are partial over m tiles and dzC
//    over T ranges. Each block writes its partials, then takes two tickets (an
//    integer atomicAdd on a counter per T range and per m tile, after
//    __threadfence); the block that finds itself last for its T range sums
//    that range's dbase and dw partials over m tiles in ascending order, and
//    the last for its m tile sums the dzC partials over T ranges in ascending
//    order, then resets its counter to 0, so the counters need no memset
//    launch. Clusters were the other way: they cap a reduction at 8 (16)
//    blocks, and dzC sums over up to 64 T ranges at config 1. The sums run in
//    a fixed order whichever block is last, so the same inputs give the same
//    bits; the plain version sums the same ranges in the same order.
//  * dD1 is written by the blocks of the first T range while they stage g,
//    so the Function's Psi2 backward is this one launch.
//  * Precision as K1: FP32 FFMA, expf rather than __expf, no --use_fast_math.
//    TF32 alone keeps ~3 digits, which the bound cannot take
//    (rgp_tpu/ops/pallas/psi2.py:40-42). Split-precision 3xTF32 mma for the
//    two per-t contractions (C_t = (Z_m * w_t) Z_n^T and S_t = PGs_t Z) is not
//    used yet: it needs the accumulator fragments of C_t re-laid out as the A
//    operand of S_t around the exp, and three products per contraction; it is
//    the open lever once this FFMA version is measured against its bound.
//  * The ragged T and M edges are masked in the kernel; nothing is padded on
//    the host.
//  * A batch of instances in one launch, as in psi2_fwd.cu: blockIdx.z is
//    the instance; each input (g and out too) is read through its own batch
//    stride (0 = shared), and each instance has its own outputs, partials and
//    ticket counters. The block layout, T split and shared-memory plan are a
//    single instance's, so every instance's bits equal those of a launch of
//    its own.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 32;     // m rows per block: one per lane
constexpr int kWarps = 8;   // timesteps per stage: one per warp
constexpr int kThreads = kBM * kWarps;
constexpr int kMaxQ = 128;  // largest input width the kernel takes
constexpr int kDS = kBM + 1;  // padded row of the transposed D1 and Gs tiles
constexpr int kChunk = 32;  // n columns: the streamed chunk is a multiple of this
constexpr int kMaxBatch = 65535;  // instances a launch takes: gridDim.z's limit

struct BwdArgs {
  const float* base;
  const float* E;
  const float* D1;
  const float* w;
  const float* Z;
  const float* g;
  const float* out;
  long long g_s0, g_s1;  // g's strides, in elements
  float* dbase;
  float* dE;
  float* dD1;
  float* dw;
  float* dzc;
  float* part_dbase;  // (m_tiles, T)
  float* part_dw;     // (m_tiles, T, Q)
  float* part_dzc;    // (n_split, M, Q)
  unsigned* tickets;  // n_split counters, then m_tiles counters; 0 between calls
  int T, M, Q, qp, n_split, t_per, nc, nbuf;
  // the batch: each input's batch stride in elements (0 = shared); every
  // output, partial and ticket array above is the first instance's of
  // `batch` dense ones
  long long sb_base, sb_E, sb_D1, sb_w, sb_Z, sb_g, sb_out;
};

// a0 with every pointer moved to instance `inst` of the batch
__device__ __forceinline__ BwdArgs instance(const BwdArgs& a0, size_t inst, int m_tiles) {
  BwdArgs a = a0;
  const size_t T = a0.T, M = a0.M, Q = a0.Q;
  a.base += inst * a0.sb_base;
  a.E += inst * a0.sb_E;
  a.D1 += inst * a0.sb_D1;
  a.w += inst * a0.sb_w;
  a.Z += inst * a0.sb_Z;
  a.g += inst * a0.sb_g;
  a.out += inst * a0.sb_out;
  a.dbase += inst * T;
  a.dE += inst * T * M;
  a.dD1 += inst * M * M;
  a.dw += inst * T * Q;
  a.dzc += inst * M * Q;
  a.part_dbase += inst * m_tiles * T;
  a.part_dw += inst * m_tiles * T * Q;
  a.part_dzc += inst * a0.n_split * M * Q;
  a.tickets += inst * (a0.n_split + m_tiles);
  return a;
}

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }
// the compile-time width a Q runs at: the rows are padded to it with zeros,
// and the q loops run over all of it without a test
__host__ __device__ constexpr int qmax_of(int q) {
  return q <= 4 ? 4 : q <= 8 ? 8 : q <= 20 ? 20 : q <= 32 ? 32 : 128;
}

// shared memory, in floats: Z (nc x qp) | D1^T (nc x kDS) | Gs^T (nc x kDS) |
// dzC (kBM x (qp+1)) | ring of nbuf stage buffers
__host__ __device__ inline int fixed_floats(int nc, int qp) {
  return round4(nc * qp + 2 * nc * kDS + kBM * (qp + 1));
}
// one stage buffer: w (kWarps x qp) | base (kWarps) | E (kWarps x nc)
__host__ __device__ inline int ring_floats(int nc, int qp) {
  return round4(kWarps * qp + kWarps + kWarps * nc);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// w rows and base of timesteps t0..t0+7 into the stage buffer `buf`, and
// their E rows too when E is resident (the whole row, nc = M).
__device__ void load_stage(const BwdArgs& a, float* buf, int t0, int t_end, bool with_e, int tid) {
  float* w_s = buf;
  float* b_s = buf + kWarps * a.qp;
  float* e_s = b_s + kWarps;
  const int nt = min(kWarps, t_end - t0);
  for (int i = tid; i < nt * a.Q; i += kThreads) {
    const int tt = i / a.Q;
    const int q = i - tt * a.Q;
    cp_async4(w_s + tt * a.qp + q, a.w + (size_t)(t0 + tt) * a.Q + q);
  }
  if (tid < nt) cp_async4(b_s + tid, a.base + t0 + tid);
  if (with_e) {
    for (int i = tid; i < nt * a.M; i += kThreads) {
      const int tt = i / a.M;
      const int n = i - tt * a.M;
      cp_async4(e_s + tt * a.nc + n, a.E + (size_t)(t0 + tt) * a.M + n);
    }
  }
  cp_async_commit();
}

// Columns c0..c0+nn of Z, D1 and Gs (and, when streaming, the stage's E
// columns into e_s); dD1 for the block's rows of those columns if write_dd1.
// Ends with its copies committed but not waited for, and no barrier. Each
// thread takes kBatch elements at once, so their loads are in flight
// together; at Q = 32 one, because the n loop already sits at the 128
// registers that two blocks per SM allow.
template <int kBatch>
__device__ void stage_columns(const BwdArgs& a, float* z_s, float* d1_s, float* gs_s, float* e_s,
                              int m0, int c0, int nn, int t0, int t_end, bool write_dd1, int tid) {
  const int Q = a.Q, qp = a.qp, M = a.M;
  for (int i = tid; i < nn * qp; i += kThreads) {
    const int j = i / qp;
    const int q = i - j * qp;
    if (q < Q) {
      cp_async4(z_s + i, a.Z + (size_t)(c0 + j) * Q + q);
    } else {
      z_s[i] = 0.f;
    }
  }
  if (e_s != nullptr) {
    const int nt = min(kWarps, t_end - t0);
    for (int i = tid; i < nt * nn; i += kThreads) {
      const int tt = i / nn;
      const int j = i - tt * nn;
      cp_async4(e_s + tt * a.nc + j, a.E + (size_t)(t0 + tt) * M + c0 + j);
    }
  }
  // D1, Gs = g[m, n] + g[n, m] and dD1 (K1's forward reads D1 only where
  // m <= n), consecutive threads on consecutive n
  const int total = kBM * nn;
  for (int i0 = tid; i0 < total; i0 += kThreads * kBatch) {
    int r[kBatch], j[kBatch];
    float gmn[kBatch], gnm[kBatch], o[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kThreads;
      r[b] = i / nn;
      j[b] = i - r[b] * nn;
      const int m = m0 + r[b], n = c0 + j[b];
      const bool ok = i < total && m < M;
      gmn[b] = ok ? a.g[(long long)m * a.g_s0 + (long long)n * a.g_s1] : 0.f;
      gnm[b] = ok ? a.g[(long long)n * a.g_s0 + (long long)m * a.g_s1] : 0.f;
      o[b] = ok && write_dd1 ? a.out[(size_t)m * M + n] : 0.f;
      if (ok) {
        cp_async4(d1_s + j[b] * kDS + r[b], a.D1 + (size_t)m * M + n);
      } else if (i < total) {
        d1_s[j[b] * kDS + r[b]] = 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (i0 + b * kThreads >= total) continue;
      const int m = m0 + r[b], n = c0 + j[b];
      const float gs = gmn[b] + gnm[b];
      gs_s[j[b] * kDS + r[b]] = gs;
      if (write_dd1 && m < M) {
        const float v = -(o[b] * gs);
        a.dD1[(size_t)m * M + n] = m < n ? v : (m == n ? v * 0.5f : 0.f);
      }
    }
  }
  cp_async_commit();
}

// out[i] = sum_k part[k * stride + i] over k = 0, 1, ... in this order, for
// i < n; each thread takes kBatch elements at once, so their loads are in
// flight together (the partials were written by other blocks: read past L1)
__device__ void ordered_sum(const float* part, size_t stride, int n_part, float* out, int n, int tid) {
  constexpr int kBatch = 4;
  for (int i0 = tid; i0 < n; i0 += kThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) v[b] = 0.f;
#pragma unroll 8
    for (int k = 0; k < n_part; ++k) {
      float x[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * kThreads;
        x[b] = i < n ? __ldcg(part + k * stride + i) : 0.f;
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) v[b] += x[b];
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (i0 + b * kThreads < n) out[i0 + b * kThreads] = v[b];
    }
  }
}

template <int QMAX>
__global__ void __launch_bounds__(kThreads, QMAX <= 32 ? 2 : 1)
psi2_bwd_kernel(const BwdArgs a0) {
  const BwdArgs a = instance(a0, blockIdx.z, gridDim.x);
  constexpr int kQP = round4(QMAX);
  constexpr bool kHoldZ = QMAX <= 32;
  constexpr int kUnrollN = 2;  // two n a pass
  constexpr int kStageBatch = QMAX <= 20 ? 4 : 1;
  extern __shared__ __align__(16) float smem[];
  const int Q = a.Q, M = a.M, T = a.T, nc = a.nc;
  constexpr int qp = kQP;  // = a.qp: the host lays shared memory out for this instance
  const bool resident = nc >= M;
  float* z_s = smem;
  float* d1_s = z_s + nc * qp;
  float* gs_s = d1_s + nc * kDS;
  float* dzc_s = gs_s + nc * kDS;
  float* ring = smem + fixed_floats(nc, qp);
  const int ring_n = ring_floats(nc, qp);

  const int tid = threadIdx.x;
  const int lane = tid & 31;  // m within the tile
  const int warp = tid >> 5;  // timestep within the stage
  const int m0 = blockIdx.x * kBM;
  const int m = m0 + lane;
  const bool m_live = m < M;
  const int split = blockIdx.y;
  const int t_begin = split * a.t_per;
  const int t_end = min(T, t_begin + a.t_per);

  for (int i = tid; i < kBM * (qp + 1); i += kThreads) dzc_s[i] = 0.f;
  if (resident) stage_columns<kStageBatch>(a, z_s, d1_s, gs_s, nullptr, m0, 0, M, 0, 0, split == 0, tid);
  load_stage(a, ring, t_begin, t_end, resident, tid);

  for (int s = 0, t0 = t_begin; t0 < t_end; ++s, t0 += kWarps) {
    float* cur = ring + (a.nbuf == 2 ? (s & 1) : 0) * ring_n;
    bool pending = false;
    if (a.nbuf == 2) {
      if (t0 + kWarps < t_end) {
        load_stage(a, ring + ((s + 1) & 1) * ring_n, t0 + kWarps, t_end, resident, tid);
        pending = true;
      }
    } else if (s > 0) {
      load_stage(a, cur, t0, t_end, resident, tid);
    }
    if (pending) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage's rows (and, first time, the resident columns) are in

    const int t = t0 + warp;
    const bool t_live = t < t_end;
    const bool live = t_live && m_live;
    const float* wrow = cur + warp * qp;
    float* e_s = cur + kWarps * qp + kWarps;
    float wz[kQP], S[kQP];
#pragma unroll
    for (int q = 0; q < kQP; ++q) {
      wz[q] = (live && q < Q) ? wrow[q] * __ldg(a.Z + (size_t)m * Q + q) : 0.f;
      S[q] = 0.f;
    }
    const float at = live ? cur[kWarps * qp + warp] + __ldg(a.E + (size_t)t * M + m) : 0.f;
    float de = 0.f;

    for (int c0 = 0; c0 < M; c0 += nc) {
      const int nn = min(nc, M - c0);
      if (!resident) {
        __syncthreads();  // the previous chunk is consumed
        stage_columns<kStageBatch>(a, z_s, d1_s, gs_s, e_s, m0, c0, nn, t0, t_end, split == 0 && s == 0, tid);
        cp_async_wait<0>();
        __syncthreads();
      }
      if (live) {
        const float* erow = e_s + warp * nc;
#pragma unroll kUnrollN
        for (int j = 0; j < nn; ++j) {
          // the whole padded row: its pad columns are 0, and a Q test here
          // would cost a predicate or a branch per float4
          const float4* zr = reinterpret_cast<const float4*>(z_s + j * kQP);
          float4 zn[kQP / 4];
          float c0_ = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
#pragma unroll
          for (int q4 = 0; q4 < kQP / 4; ++q4) {
            const float4 v = zr[q4];
            if (kHoldZ) zn[q4] = v;
            c0_ = fmaf(wz[4 * q4 + 0], v.x, c0_);
            c1 = fmaf(wz[4 * q4 + 1], v.y, c1);
            c2 = fmaf(wz[4 * q4 + 2], v.z, c2);
            c3 = fmaf(wz[4 * q4 + 3], v.w, c3);
          }
          const float c = (c0_ + c1) + (c2 + c3);
          const float logp = fmaf(-0.5f, c, (at + erow[j]) - d1_s[j * kDS + lane]);
          const float pg = expf(logp) * gs_s[j * kDS + lane];
          de += pg;
#pragma unroll
          for (int q4 = 0; q4 < kQP / 4; ++q4) {
            const float4 v = kHoldZ ? zn[q4] : zr[q4];
            S[4 * q4 + 0] = fmaf(pg, v.x, S[4 * q4 + 0]);
            S[4 * q4 + 1] = fmaf(pg, v.y, S[4 * q4 + 1]);
            S[4 * q4 + 2] = fmaf(pg, v.z, S[4 * q4 + 2]);
            S[4 * q4 + 3] = fmaf(pg, v.w, S[4 * q4 + 3]);
          }
        }
      }
    }

    // the stage's timesteps are done: dE is complete, dbase and dw are
    // partial over this m tile (dead lanes hold de = 0 and S = 0)
    if (live) a.dE[(size_t)t * M + m] = de;
    const float db = warp_sum(de);
    if (t_live && lane == 0) a.part_dbase[(size_t)blockIdx.x * T + t] = 0.5f * db;
#pragma unroll
    for (int q = 0; q < kQP; ++q) {
      if (q < Q) {
        const float zq = m_live ? __ldg(a.Z + (size_t)m * Q + q) : 0.f;
        const float v = warp_sum(zq * S[q]);
        if (t_live && lane == (q & 31)) a.part_dw[((size_t)blockIdx.x * T + t) * Q + q] = -0.25f * v;
      }
    }
    // dzC: the warps add w[t,q] S[t,m,q] in warp order; the last barrier
    // also frees this stage's buffer
    for (int k = 0; k < kWarps; ++k) {
      if (warp == k && live) {
#pragma unroll
        for (int q = 0; q < kQP; ++q) {
          if (q < Q) dzc_s[lane * (qp + 1) + q] = fmaf(wrow[q], S[q], dzc_s[lane * (qp + 1) + q]);
        }
      }
      __syncthreads();
    }
  }

  // dzC partial over this block's T range
  for (int i = tid; i < kBM * Q; i += kThreads) {
    const int r = i / Q;
    const int q = i - r * Q;
    if (m0 + r < M) a.part_dzc[((size_t)split * M + m0 + r) * Q + q] = -0.5f * dzc_s[r * (qp + 1) + q];
  }

  // tickets: the last block of a T range and the last block of an m tile sum
  // their partials in ascending order
  __shared__ int last[2];
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last[0] = atomicAdd(a.tickets + split, 1u) == gridDim.x - 1;
    last[1] = atomicAdd(a.tickets + a.n_split + blockIdx.x, 1u) == (unsigned)(a.n_split - 1);
  }
  __syncthreads();
  if (last[0]) {
    __threadfence();
    const int nt = t_end - t_begin;
    ordered_sum(a.part_dbase + t_begin, T, gridDim.x, a.dbase + t_begin, nt, tid);
    ordered_sum(a.part_dw + (size_t)t_begin * Q, (size_t)T * Q, gridDim.x, a.dw + (size_t)t_begin * Q, nt * Q, tid);
    if (tid == 0) a.tickets[split] = 0u;
  }
  if (last[1]) {
    __threadfence();
    const size_t at = (size_t)m0 * Q;
    ordered_sum(a.part_dzc + at, (size_t)M * Q, a.n_split, a.dzc + at, min(kBM, M - m0) * Q, tid);
    if (tid == 0) a.tickets[a.n_split + blockIdx.x] = 0u;
  }
}

// The block's n width (nc = M: resident) and ring depth for (M, Q) on the
// current device, and the dynamic shared memory that takes.
int plan(int M, int Q, int* nc, int* nbuf, size_t* bytes) {
  int dev = 0, sm_bytes = 0, block_bytes = 0, reserved = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&block_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e != cudaSuccess) return (int)e;
  const int qp = qmax_of(Q);
  const size_t per_sm = Q <= 32 ? 2 : 1;  // blocks per SM the launch bounds aim at
  auto size = [&](int n, int b) { return 4 * ((size_t)fixed_floats(n, qp) + (size_t)b * ring_floats(n, qp)); };
  auto fits = [&](int n, int b) {
    return size(n, b) <= (size_t)block_bytes && per_sm * (size(n, b) + reserved) <= (size_t)sm_bytes;
  };
  if (fits(M, 2)) {
    *nc = M, *nbuf = 2;
  } else if (fits(M, 1)) {
    *nc = M, *nbuf = 1;
  } else {
    int n = M / kChunk * kChunk;
    while (n > kChunk && (n >= M || !fits(n, 2))) n -= kChunk;
    *nc = n, *nbuf = 2;
  }
  *bytes = size(*nc, *nbuf);
  return 0;
}

template <int QMAX>
int launch(const BwdArgs& a, dim3 grid, size_t bytes, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(psi2_bwd_kernel<QMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  psi2_bwd_kernel<QMAX><<<grid, kThreads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rgp_psi2_bwd_max_q() { return kMaxQ; }
extern "C" int rgp_psi2_bwd_tile_m() { return kBM; }
extern "C" int rgp_psi2_bwd_max_batch() { return kMaxBatch; }

// (nc, nbuf, shared bytes) of the launch for (M, Q): nc == M means the
// block's columns are resident, nc < M that they are streamed in chunks.
extern "C" int rgp_psi2_bwd_plan(int M, int Q, int* out3) {
  size_t bytes = 0;
  const int err = plan(M, Q, out3, out3 + 1, &bytes);
  out3[2] = (int)bytes;
  return err;
}

// One launch on `stream` over `batch` instances; returns cudaGetLastError()
// or the first error met (0 = launched). Instance b reads base + b sb_base
// (T,), E + b sb_E (T, M), D1 + b sb_D1 (M, M), w + b sb_w (T, Q), Z + b
// sb_Z (M, Q) and out + b sb_out (M, M), each dense, and g + b sb_g (M, M)
// through its strides (g_s0, g_s1); a batch stride of 0 shares the input.
// Outputs, one dense (batch, ...) array each: dbase (T,), dE (T, M), dD1
// (M, M), dw (T, Q), dzc (M, Q). Scratch, one per instance: part_dbase
// (m_tiles, T), part_dw (m_tiles, T, Q), part_dzc (n_split, M, Q), with
// m_tiles = ceil(M / 32); tickets: n_tickets >= batch (n_split + m_tiles)
// unsigned counters, all 0, left 0. All float32, row-major.
extern "C" int rgp_psi2_bwd(const float* base, const float* E, const float* D1, const float* w,
                            const float* Z, const float* g, long long g_s0, long long g_s1,
                            const float* out, float* dbase, float* dE, float* dD1, float* dw,
                            float* dzc, float* part_dbase, float* part_dw, float* part_dzc,
                            unsigned* tickets, int n_tickets, int T, int M, int Q, int n_split,
                            int t_per_split, int batch, long long sb_base, long long sb_E,
                            long long sb_D1, long long sb_w, long long sb_Z, long long sb_g,
                            long long sb_out, void* stream) {
  const int m_tiles = (M + kBM - 1) / kBM;
  if (T < 1 || M < 1 || Q < 1 || Q > kMaxQ || n_split < 1 || t_per_split < 1 ||
      (long long)n_split * t_per_split < T || (long long)(n_split - 1) * t_per_split >= T ||
      batch < 1 || batch > kMaxBatch || n_tickets < (long long)batch * (n_split + m_tiles) ||
      sb_base < 0 || sb_E < 0 || sb_D1 < 0 || sb_w < 0 || sb_Z < 0 || sb_g < 0 || sb_out < 0) {
    return (int)cudaErrorInvalidValue;
  }
  BwdArgs a{base, E, D1, w, Z, g, out, g_s0, g_s1, dbase, dE, dD1, dw, dzc,
            part_dbase, part_dw, part_dzc, tickets, T, M, Q, qmax_of(Q), n_split, t_per_split, 0, 0,
            sb_base, sb_E, sb_D1, sb_w, sb_Z, sb_g, sb_out};
  size_t bytes = 0;
  const int err = plan(M, Q, &a.nc, &a.nbuf, &bytes);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(m_tiles, n_split, batch);
  switch (qmax_of(Q)) {
    case 4: return launch<4>(a, grid, bytes, s);
    case 8: return launch<8>(a, grid, bytes, s);
    case 20: return launch<20>(a, grid, bytes, s);
    case 32: return launch<32>(a, grid, bytes, s);
  }
  return launch<kMaxQ>(a, grid, bytes, s);
}

// K2: fused RBF Psi2 time sum, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rgp_tpu/ops/pallas/psi2.py::_psi2_bwd_kernel
// (launched by _psi2_bwd_raw). With P[t,m,n] recomputed from the forward's
// decomposition (see psi2_fwd.cu) and PGs = P * Gs, Gs = G + G^T symmetric:
//
//   dE[t,m]   = sum_n PGs[t,m,n]
//   dbase[t]  = 1/2 sum_m dE[t,m]
//   S[t,m,q]  = sum_n PGs[t,m,n] z[n,q]
//   dw[t,q]   = -1/4 sum_m z[m,q] S[t,m,q]
//   dzC[m,q]  = -1/2 sum_t w[t,q] S[t,m,q]     (the C term's direct dZ)
//
// Neither the (T, M, M) tensor nor the (T, M, Q) tensor S reaches device
// memory.
//
// What bounds it on this card: per element (t, m, n) the function needs about
// 4Q+8 FP32 operations plus one exp (Q FFMAs to rebuild C, Q to accumulate S,
// and the exp's argument, the product with Gs and the dE sum), over T*M^2
// elements; its bytes are O(TM + M^2 + TQ + MQ), negligible. So it is bound by
// FP32 operations, like K1, at about twice K1's work. At config 1 (T=512,
// M=100, Q<=20) that is a few microseconds of work and launch overhead
// dominates.
//
// What the design does about it:
//  * Layout. A block owns 32 m rows (one per lane) and a T range; its 8 warps
//    take 8 timesteps at a time. Each thread (t, m) keeps w[t,:] z[m,:] and
//    its S[t,m,:] in registers and walks every n, so P and PGs live only in
//    registers and dE[t,m] is complete inside the block. The n loop stages
//    32 n at a time in shared memory: z rows (read as float4 broadcasts),
//    the (m, n) tiles of D1 and Gs (transposed, padded, so lanes read
//    consecutive words) and the E[t, n] rows.
//  * Cross-block sums without float atomics. dbase and dw are partial over
//    m tiles and dzC over T ranges: each block writes its partials and a
//    second small kernel sums them in ascending order, so results are the
//    same from run to run. The plain version sums the same ranges in the same
//    order.
//  * Precision as K1: FP32 FFMA, no TF32 and no reduced-precision tensor
//    cores (a 1e-3 relative error in Psi2 breaks the collapsed bound), and
//    expf rather than __expf; the build uses no --use_fast_math.
//  * The ragged T and M edges are masked in the kernel; nothing is padded on
//    the host. Q is a run-time value up to 128, unrolled against the compile-
//    time caps QMAX = 8, 32, 128 as in K1; the 128 instance keeps three
//    128-float arrays per thread and spills to local memory.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 32;     // m rows per block: one per lane
constexpr int kWarps = 8;   // timesteps in flight per block: one per warp
constexpr int kBN = 32;     // n columns staged in shared memory at a time
constexpr int kMaxQ = 128;  // largest input width the kernel takes
constexpr int kThreads = kBM * kWarps;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int QMAX>
__global__ void __launch_bounds__(kThreads)
psi2_bwd_partial_kernel(const float* __restrict__ base, const float* __restrict__ E,
                        const float* __restrict__ D1, const float* __restrict__ w,
                        const float* __restrict__ Z, const float* __restrict__ Gs,
                        float* __restrict__ dE, float* __restrict__ part_dbase,
                        float* __restrict__ part_dw, float* __restrict__ part_dzc,
                        int T, int M, int Q, int t_per_split) {
  constexpr int kQP = (QMAX + 3) / 4 * 4;
  __shared__ __align__(16) float zn_s[kBN * kQP];
  __shared__ float d1_s[kBN][kBM + 1];
  __shared__ float gs_s[kBN][kBM + 1];
  __shared__ float en_s[kWarps][kBN];
  __shared__ float red_s[kBM * (kQP + 1)];

  const int lane = threadIdx.x;  // m within the tile
  const int warp = threadIdx.y;  // timestep within the stage
  const int tid = warp * kBM + lane;
  const int m0 = blockIdx.x * kBM;
  const int m = m0 + lane;
  const bool m_live = m < M;
  const int split = blockIdx.y;
  const int t_begin = split * t_per_split;
  const int t_end = min(T, t_begin + t_per_split);
  const int qp = (Q + 3) / 4 * 4;  // padded z row stride in shared memory

  float dzc[kQP];
#pragma unroll
  for (int q = 0; q < kQP; ++q) dzc[q] = 0.f;

  for (int t0 = t_begin; t0 < t_end; t0 += kWarps) {
    const int t = t0 + warp;
    const bool t_live = t < t_end;
    const bool live = t_live && m_live;
    float wz[kQP], S[kQP];
#pragma unroll
    for (int q = 0; q < kQP; ++q) {
      wz[q] = (live && q < Q) ? w[(size_t)t * Q + q] * Z[(size_t)m * Q + q] : 0.f;
      S[q] = 0.f;
    }
    const float base_t = live ? base[t] : 0.f;
    const float em = live ? E[(size_t)t * M + m] : 0.f;
    float de = 0.f;

    for (int n0 = 0; n0 < M; n0 += kBN) {
      const int nn = min(kBN, M - n0);
      __syncthreads();  // the previous tile is consumed
      for (int i = tid; i < nn * qp; i += kThreads) {
        const int j = i / qp;
        const int q = i - j * qp;
        zn_s[j * qp + q] = (q < Q) ? Z[(size_t)(n0 + j) * Q + q] : 0.f;
      }
      for (int i = tid; i < kBM * kBN; i += kThreads) {
        const int r = i / kBN;  // m row of the tile
        const int c = i - r * kBN;  // n column: consecutive threads, consecutive words
        const bool ok = (m0 + r < M) && (c < nn);
        const size_t at = (size_t)(m0 + r) * M + n0 + c;
        d1_s[c][r] = ok ? D1[at] : 0.f;
        gs_s[c][r] = ok ? Gs[at] : 0.f;
      }
      for (int i = tid; i < kWarps * kBN; i += kThreads) {
        const int r = i / kBN;
        const int c = i - r * kBN;
        en_s[r][c] = (t0 + r < t_end && c < nn) ? E[(size_t)(t0 + r) * M + n0 + c] : 0.f;
      }
      __syncthreads();

      if (live) {
        for (int j = 0; j < nn; ++j) {
          const float4* zr = reinterpret_cast<const float4*>(zn_s + j * qp);
          float c = 0.f;
#pragma unroll
          for (int q4 = 0; q4 < kQP / 4; ++q4) {
            if (4 * q4 < Q) {
              const float4 v = zr[q4];
              c = fmaf(wz[4 * q4 + 0], v.x, c);
              c = fmaf(wz[4 * q4 + 1], v.y, c);
              c = fmaf(wz[4 * q4 + 2], v.z, c);
              c = fmaf(wz[4 * q4 + 3], v.w, c);
            }
          }
          const float logp = base_t - d1_s[j][lane] + em + en_s[warp][j] - 0.5f * c;
          const float pg = expf(logp) * gs_s[j][lane];
          de += pg;
#pragma unroll
          for (int q4 = 0; q4 < kQP / 4; ++q4) {
            if (4 * q4 < Q) {
              const float4 v = zr[q4];
              S[4 * q4 + 0] = fmaf(pg, v.x, S[4 * q4 + 0]);
              S[4 * q4 + 1] = fmaf(pg, v.y, S[4 * q4 + 1]);
              S[4 * q4 + 2] = fmaf(pg, v.z, S[4 * q4 + 2]);
              S[4 * q4 + 3] = fmaf(pg, v.w, S[4 * q4 + 3]);
            }
          }
        }
      }
    }

    // the stage's timesteps are done: dE is complete, dbase and dw are
    // partial over this m tile (dead lanes hold de = 0 and S = 0)
    if (live) dE[(size_t)t * M + m] = de;
    const float db = warp_sum(de);
    if (t_live && lane == 0) part_dbase[(size_t)blockIdx.x * T + t] = 0.5f * db;
#pragma unroll
    for (int q = 0; q < kQP; ++q) {
      if (q < Q) {
        const float zq = m_live ? Z[(size_t)m * Q + q] : 0.f;
        const float v = warp_sum(zq * S[q]);
        if (t_live && lane == (q & 31)) {
          part_dw[((size_t)blockIdx.x * T + t) * Q + q] = -0.25f * v;
        }
        if (live) dzc[q] = fmaf(w[(size_t)t * Q + q], S[q], dzc[q]);
      }
    }
  }

  // dzC partial over this block's T range: the warps' sums in warp order
  for (int k = 0; k < kWarps; ++k) {
    __syncthreads();
    if (warp == k) {
#pragma unroll
      for (int q = 0; q < kQP; ++q) {
        if (q < Q) {
          float* r = red_s + lane * (kQP + 1) + q;
          *r = (k == 0 ? 0.f : *r) + dzc[q];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kBM * Q; i += kThreads) {
    const int r = i / Q;
    const int q = i - r * Q;
    if (m0 + r < M) {
      part_dzc[((size_t)split * M + m0 + r) * Q + q] = -0.5f * red_s[r * (kQP + 1) + q];
    }
  }
}

// out[i] = sum_k part[k, i], k in ascending order: a fixed order, so the
// result does not change from run to run.
__global__ void sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 int n_part, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < n_part; ++k) s += part[(size_t)k * n + i];
  out[i] = s;
}

int sum_parts(const float* part, float* out, int n_part, int n, cudaStream_t s) {
  sum_parts_kernel<<<(n + 255) / 256, 256, 0, s>>>(part, out, n_part, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rgp_psi2_bwd_max_q() { return kMaxQ; }
extern "C" int rgp_psi2_bwd_tile_m() { return kBM; }

// Launches the partial kernel and the three ordered reductions on `stream`;
// returns cudaGetLastError() of the first launch that failed (0 = launched).
// Outputs: dbase (T,), dE (T, M), dw (T, Q), dzc (M, Q). Scratch: part_dbase
// (m_tiles, T), part_dw (m_tiles, T, Q), part_dzc (n_split, M, Q), with
// m_tiles = ceil(M / 32). All float32, row-major.
extern "C" int rgp_psi2_bwd(const float* base, const float* E, const float* D1,
                            const float* w, const float* Z, const float* Gs,
                            float* dbase, float* dE, float* dw, float* dzc,
                            float* part_dbase, float* part_dw, float* part_dzc,
                            int T, int M, int Q, int n_split, int t_per_split,
                            void* stream) {
  if (T < 1 || M < 1 || Q < 1 || Q > kMaxQ || n_split < 1 || t_per_split < 1 ||
      (long long)n_split * t_per_split < T) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m_tiles = (M + kBM - 1) / kBM;
  const dim3 block(kBM, kWarps);
  const dim3 grid(m_tiles, n_split);
  if (Q <= 8) {
    psi2_bwd_partial_kernel<8><<<grid, block, 0, s>>>(base, E, D1, w, Z, Gs, dE, part_dbase,
                                                      part_dw, part_dzc, T, M, Q, t_per_split);
  } else if (Q <= 32) {
    psi2_bwd_partial_kernel<32><<<grid, block, 0, s>>>(base, E, D1, w, Z, Gs, dE, part_dbase,
                                                       part_dw, part_dzc, T, M, Q, t_per_split);
  } else {
    psi2_bwd_partial_kernel<kMaxQ><<<grid, block, 0, s>>>(base, E, D1, w, Z, Gs, dE, part_dbase,
                                                          part_dw, part_dzc, T, M, Q, t_per_split);
  }
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if ((err = sum_parts(part_dbase, dbase, m_tiles, T, s)) != 0) return err;
  if ((err = sum_parts(part_dw, dw, m_tiles, T * Q, s)) != 0) return err;
  return sum_parts(part_dzc, dzc, n_split, M * Q, s);
}

// K1: fused RBF Psi2 time sum, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rgp_tpu/ops/pallas/psi2.py::_psi2_kernel
// (launched by _psi2_pallas_raw). It computes
//
//   out[m,n] = sum_t exp(base[t] - D1[m,n] + E[t,m] + E[t,n] - 1/2 C[t,m,n]),
//   C[t,m,n] = sum_q w[t,q] z[m,q] z[n,q],
//
// summed over T without materialising the (T, M, M) intermediate.
//
// What bounds it on this card: per element (t, m, n) the function needs about
// 2Q+6 FP32 operations plus one exp, over T*M^2 elements; its bytes are
// O(TM + M^2 + TQ), negligible. At config 1 (T=512, M=100, Q<=20) that is
// 5.1M elements, a few microseconds of FP32/SFU work, so launch overhead
// dominates there. At T=2048, M=256, Q=32 it is 134M elements, about 9 GFLOP.
//
// What the design does about it:
//  * The TPU grid carried the t-sum in VMEM scratch over one sequential grid
//    axis; at M=100 that was a single output tile, which here would occupy one
//    SM of 132. So T is split across blocks as well as the M x M tiles: block
//    (bx, by, bz) owns a 16x16 output tile (one element per thread) and a
//    contiguous T range. Each split writes its own partial (n_split, M, M);
//    a second small kernel sums the partials in a fixed order. No float
//    atomics, so results are identical from run to run.
//  * C is separable: z[m,q] z[n,q] does not depend on t, so each thread forms
//    zz[q] = z[m,q] z[n,q] once, in registers (the Q loop is unrolled up to a
//    compile-time cap QMAX), and each timestep costs Q FFMAs. FFMA in full
//    FP32: no TF32 and no reduced-precision tensor-core path, because a 1e-3
//    relative error in Psi2 breaks the stability of the collapsed bound.
//  * w, base and the tile's E rows are staged through shared memory in stages
//    of kStage timesteps; w rows are padded to a multiple of 4 floats and read
//    as float4 broadcasts, so shared-memory loads do not bound the Q loop.
//  * expf, not __expf: expf is accurate to about 2 ulp over the whole range,
//    __expf loses accuracy as |x| grows, and the sum of exps is what the bound
//    differentiates. The build uses no --use_fast_math.
//  * The ragged T and M edges are masked in the kernel; nothing is padded on
//    the host.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;    // output tile edge; one thread per element
constexpr int kStage = 32;   // timesteps staged in shared memory at a time
constexpr int kMaxQ = 128;   // largest input width the kernel takes

template <int QMAX>
__global__ void __launch_bounds__(kTile * kTile)
psi2_partial_kernel(const float* __restrict__ base, const float* __restrict__ E,
                    const float* __restrict__ D1, const float* __restrict__ w,
                    const float* __restrict__ Z, float* __restrict__ partial,
                    int T, int M, int Q, int t_per_split) {
  constexpr int kQP = (QMAX + 3) / 4 * 4;
  __shared__ __align__(16) float w_s[kStage * kQP];
  __shared__ float base_s[kStage];
  __shared__ float em_s[kStage][kTile];
  __shared__ float en_s[kStage][kTile];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const int m = m0 + ty;
  const int n = n0 + tx;
  const bool live = (m < M) && (n < M);
  const int qp = (Q + 3) / 4 * 4;  // padded w row stride in shared memory
  const int t_begin = blockIdx.z * t_per_split;
  const int t_end = min(T, t_begin + t_per_split);

  float zz[kQP];
#pragma unroll
  for (int q = 0; q < kQP; ++q) {
    zz[q] = (live && q < Q) ? Z[m * Q + q] * Z[n * Q + q] : 0.f;
  }
  const float d1 = live ? D1[m * M + n] : 0.f;

  float acc = 0.f;
  for (int t0 = t_begin; t0 < t_end; t0 += kStage) {
    const int nt = min(kStage, t_end - t0);
    __syncthreads();  // the previous stage is consumed
    for (int i = tid; i < nt * qp; i += kTile * kTile) {
      const int tt = i / qp;
      const int q = i - tt * qp;
      w_s[tt * qp + q] = (q < Q) ? w[(t0 + tt) * Q + q] : 0.f;
    }
    for (int i = tid; i < nt * kTile; i += kTile * kTile) {
      const int tt = i / kTile;
      const int j = i - tt * kTile;
      const float* row = E + (size_t)(t0 + tt) * M;
      em_s[tt][j] = (m0 + j < M) ? row[m0 + j] : 0.f;
      en_s[tt][j] = (n0 + j < M) ? row[n0 + j] : 0.f;
    }
    if (tid < nt) base_s[tid] = base[t0 + tid];
    __syncthreads();

    if (live) {
      for (int tt = 0; tt < nt; ++tt) {
        const float4* wr = reinterpret_cast<const float4*>(w_s + tt * qp);
        float c = 0.f;
#pragma unroll
        for (int q4 = 0; q4 < kQP / 4; ++q4) {
          if (4 * q4 < Q) {
            const float4 v = wr[q4];
            c = fmaf(v.x, zz[4 * q4 + 0], c);
            c = fmaf(v.y, zz[4 * q4 + 1], c);
            c = fmaf(v.z, zz[4 * q4 + 2], c);
            c = fmaf(v.w, zz[4 * q4 + 3], c);
          }
        }
        const float logp = base_s[tt] - d1 + em_s[tt][ty] + en_s[tt][tx] - 0.5f * c;
        acc += expf(logp);
      }
    }
  }
  if (live) partial[((size_t)blockIdx.z * M + m) * M + n] = acc;
}

// out[i] = sum_k partial[k, i], k in ascending order: a fixed order, so the
// result does not change from run to run.
__global__ void psi2_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int n_split, int mm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mm) return;
  float s = 0.f;
  for (int k = 0; k < n_split; ++k) s += partial[(size_t)k * mm + i];
  out[i] = s;
}

}  // namespace

extern "C" int rgp_psi2_fwd_max_q() { return kMaxQ; }

// Launches both kernels on `stream`; returns cudaGetLastError() (0 = launched).
// partial: (n_split, M, M) scratch; out: (M, M). All float32, row-major.
extern "C" int rgp_psi2_fwd(const float* base, const float* E, const float* D1,
                            const float* w, const float* Z, float* partial, float* out,
                            int T, int M, int Q, int n_split, int t_per_split,
                            void* stream) {
  if (T < 1 || M < 1 || Q < 1 || Q > kMaxQ || n_split < 1 ||
      (long long)n_split * t_per_split < T) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (M + kTile - 1) / kTile;
  const dim3 block(kTile, kTile);
  const dim3 grid(tiles, tiles, n_split);
  if (Q <= 8) {
    psi2_partial_kernel<8><<<grid, block, 0, s>>>(base, E, D1, w, Z, partial, T, M, Q, t_per_split);
  } else if (Q <= 32) {
    psi2_partial_kernel<32><<<grid, block, 0, s>>>(base, E, D1, w, Z, partial, T, M, Q, t_per_split);
  } else {
    psi2_partial_kernel<kMaxQ><<<grid, block, 0, s>>>(base, E, D1, w, Z, partial, T, M, Q, t_per_split);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int mm = M * M;
  psi2_reduce_kernel<<<(mm + 255) / 256, 256, 0, s>>>(partial, out, n_split, mm);
  return (int)cudaGetLastError();
}

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
// 2Q+6 FP32 operations plus one exp; out is symmetric (D1, E[t,m] + E[t,n]
// and C all are), so the least work is T * M(M+1)/2 elements. Its bytes are
// O(TM + M^2 + TQ), negligible: it is bound by FP32 issue. At config 1
// (T=512, M=100, Q<=20) that is a few microseconds, so the launch is a large
// share there; at T=2048, M=256, Q=32 it is 67M elements, about 4.8 GFLOP.
//
// What the design does about it:
//  * Symmetry. Only output tile pairs with m tile <= n tile are computed (10
//    of 16 at M=100, 36 of 64 at M=256, with 32-wide tiles); each value is
//    written to (m, n) and (n, m), and in a diagonal tile only the m <= n
//    half is kept, so out is exactly symmetric. (At M=100 the 32-wide tiles
//    cover 128, so the pairs hold about as many elements as the full matrix;
//    the saving shows from M of a few hundred.)
//  * Register tiling. A 32 x 32 output tile a block (Q <= 32; 16 x 16 above).
//    Each thread owns a patch with zz[q] = z[m,q] z[n,q] of its elements in
//    registers (the t-invariant half of C), so a timestep costs exactly Q
//    FFMAs an element, and one float4 read of the w row, the E values of its
//    rows and columns and base serve the whole patch. Forming w_t * z_m per
//    patch instead would cost 1.5 Q FP32 operations an element at 2 x 2 and
//    keep z in shared memory. zz takes (patch size) x Q registers, so the
//    patch follows Q: 2 x 2 on 16 x 16 threads for Q <= 20 (two blocks per
//    SM, __launch_bounds__(256, 2)), 1 x 2 on 32 x 16 threads for Q <= 32 (one
//    512-thread block per SM, <= 128 registers), one element a thread above.
//    Each element's sum over q runs in 4 / (patch size) independent chains,
//    so every thread has 4 FFMA chains in flight. Q runs at the compile-time
//    width qmax_of(Q), the w rows are zero-padded to it and the q loop covers
//    it whole: a run-time Q test there cost a branch per float4. The widths
//    are those of the measured shapes: 4 (config 1's output layer, Q = 1), 8
//    (Q = 5), 20 (config 1's hidden layer), 32 (the production shape) and 128,
//    the largest Q taken; any other Q pads to the next of them.
//  * Staging. w, base and the tile's E rows and columns go through shared
//    memory in stages of kStage timesteps, by cp.async into two buffers: the
//    copy of stage k+1 is in flight while stage k computes.
//  * T split, one launch, deterministic. The TPU grid carried the t-sum over a
//    sequential grid axis; at M=100 that is one output tile, which here would
//    occupy one SM of 132. So T is split across blocks as well: block
//    (pair, split) writes its partial tile, then takes a ticket (an integer
//    atomicAdd on the pair's counter after __threadfence); the block that is
//    last for its pair sums the pair's partials in ascending split order,
//    writes both halves and resets the counter to 0, so no memset launch and
//    no float atomics are needed and the same inputs give the same bits. The
//    plain version sums the same T ranges in the same order.
//  * FFMA in full FP32: no TF32, whose 1e-3 relative error in Psi2 breaks
//    the stability of the collapsed bound. Split-precision 3xTF32 mma for C_t
//    is not used yet (see psi2_bwd.cu): the exp and the sums around it stay on
//    the FP32 pipe either way.
//    expf, not __expf: expf is accurate to about 2 ulp over the whole range,
//    and the sum of exps is what the bound differentiates. The build uses no
//    --use_fast_math.
//  * The ragged T and M edges are masked in the kernel; nothing is padded on
//    the host.
//  * A batch of instances in one launch (the counterpart of pallas_call's
//    batching rule, which gives a vmapped call a leading grid axis):
//    blockIdx.z is the instance. Each input is read through its own batch
//    stride (0 = shared by every instance, as Z is for a batch of sampler
//    chains); each instance has its own slice of the partials, of out and of
//    the ticket counters. The tile plan and the T split are a single
//    instance's, so every instance's bits equal those of a launch of its
//    own. A single call is the batch of one.

#include <cuda_runtime.h>

namespace {

constexpr int kStage = 32;   // timesteps staged in shared memory at a time
constexpr int kMaxQ = 128;   // largest input width the kernel takes
constexpr int kMaxBatch = 65535;  // instances a launch takes: gridDim.z's limit

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }
// the compile-time width a Q runs at: the w rows are padded to it with zeros,
// and the q loop runs over all of it without a test
__host__ __device__ constexpr int qmax_of(int q) {
  return q <= 4 ? 4 : q <= 8 ? 8 : q <= 20 ? 20 : q <= 32 ? 32 : 128;
}
__host__ __device__ constexpr int tile_of(int q) { return q <= 32 ? 32 : 16; }
__host__ __device__ constexpr int patch_m(int q) { return q <= 20 ? 2 : 1; }
__host__ __device__ constexpr int patch_n(int q) { return q <= 32 ? 2 : 1; }
__host__ __device__ constexpr int threads_of(int q) { return tile_of(q) * tile_of(q) / (patch_m(q) * patch_n(q)); }
__host__ __device__ constexpr int blocks_per_sm(int q) { return q <= 20 ? 2 : 1; }

struct FwdArgs {
  const float* base;
  const float* E;
  const float* D1;
  const float* w;
  const float* Z;
  float* partial;     // (batch, n_split, n_pairs, B, B)
  float* out;         // (batch, M, M)
  unsigned* tickets;  // batch x n_pairs counters; 0 between calls
  long long sb_base, sb_E, sb_D1, sb_w, sb_Z;  // the inputs' batch strides, in elements; 0 = shared
  int T, M, Q, n_tiles, n_pairs, n_split, t_per;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int QMAX>
__global__ void __launch_bounds__(threads_of(QMAX), blocks_per_sm(QMAX))
psi2_fwd_kernel(const FwdArgs a) {
  constexpr int PM = patch_m(QMAX), PN = patch_n(QMAX);  // the thread's patch
  constexpr int B = tile_of(QMAX);
  constexpr int TX = B / PN;  // threads along n
  constexpr int NT = threads_of(QMAX);
  constexpr int CH = 4 / (PM * PN);  // chains a element's q sum runs in
  constexpr int EP = B * B / NT;  // tile elements a thread sums at the end
  constexpr int kQP = round4(QMAX);
  __shared__ __align__(16) float w_s[2][kStage * kQP];
  __shared__ float b_s[2][kStage];
  __shared__ float em_s[2][kStage * B];
  __shared__ float en_s[2][kStage * B];
  __shared__ int last;
  // this block's instance of the batch (its rows that every stage reads sit
  // in shared memory: held in registers across the t loop they pushed the
  // Q = 20 instance past its 128 registers)
  __shared__ const float* rows_s[3];  // base, E, w

  const int Q = a.Q, M = a.M;
  const size_t inst = blockIdx.z;
  const float* D1 = a.D1 + inst * a.sb_D1;
  const float* Z = a.Z + inst * a.sb_Z;
  const int tid = threadIdx.x;
  if (tid == 0) {
    rows_s[0] = a.base + inst * a.sb_base;
    rows_s[1] = a.E + inst * a.sb_E;
    rows_s[2] = a.w + inst * a.sb_w;
  }
  const int tx = tid % TX;
  const int ty = tid / TX;
  // this block's tile pair (ti <= tj), numbered row by row
  int ti = 0, rem = blockIdx.x;
  while (rem >= a.n_tiles - ti) {
    rem -= a.n_tiles - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const int m0 = ti * B, n0 = tj * B;
  const int split = blockIdx.y;
  const int t_begin = split * a.t_per;
  const int t_end = min(a.T, t_begin + a.t_per);
  const int mr = m0 + PM * ty;  // first row and column of the thread's patch
  const int nr = n0 + PN * tx;
  const bool any_live = mr < M && nr < M;

  float zz[PM][PN][kQP], d1[PM][PN], acc[PM][PN];
#pragma unroll
  for (int i = 0; i < PM; ++i) {
#pragma unroll
    for (int j = 0; j < PN; ++j) {
      const bool live = mr + i < M && nr + j < M;
#pragma unroll
      for (int q = 0; q < kQP; ++q) {
        zz[i][j][q] = (live && q < Q) ? Z[(mr + i) * Q + q] * Z[(nr + j) * Q + q] : 0.f;
      }
      d1[i][j] = live ? D1[(size_t)(mr + i) * M + nr + j] : 0.f;
      acc[i][j] = 0.f;
    }
  }
  // the w rows' pad columns are read (times zz = 0) and must not be NaN
  for (int i = tid; i < 2 * kStage * (kQP - Q); i += NT) {
    const int row = i / (kQP - Q);
    w_s[row / kStage][(row % kStage) * kQP + Q + i - row * (kQP - Q)] = 0.f;
  }

  auto load = [&](int buf, int t0) {
    const float* base = rows_s[0];
    const float* E = rows_s[1];
    const float* w = rows_s[2];
    const int nt = min(kStage, t_end - t0);
    for (int i = tid; i < nt * Q; i += NT) {
      const int tt = i / Q;
      const int q = i - tt * Q;
      cp_async4(&w_s[buf][tt * kQP + q], w + (size_t)(t0 + tt) * Q + q);
    }
    if (tid < nt) cp_async4(&b_s[buf][tid], base + t0 + tid);
    for (int i = tid; i < nt * B; i += NT) {
      const int tt = i / B;
      const int j = i - tt * B;
      const float* row = E + (size_t)(t0 + tt) * M;
      if (m0 + j < M) {
        cp_async4(&em_s[buf][i], row + m0 + j);
      } else {
        em_s[buf][i] = 0.f;
      }
      if (n0 + j < M) {
        cp_async4(&en_s[buf][i], row + n0 + j);
      } else {
        en_s[buf][i] = 0.f;
      }
    }
    cp_async_commit();
  };

  __syncthreads();  // rows_s is set
  load(0, t_begin);
  for (int s = 0, t0 = t_begin; t0 < t_end; ++s, t0 += kStage) {
    const int buf = s & 1;
    const bool pending = t0 + kStage < t_end;
    if (pending) {
      load(buf ^ 1, t0 + kStage);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage's rows are in
    const int nt = min(kStage, t_end - t0);
    if (any_live) {
      for (int tt = 0; tt < nt; ++tt) {
        const float4* wr = reinterpret_cast<const float4*>(&w_s[buf][tt * kQP]);
        float c[PM][PN][CH];
#pragma unroll
        for (int i = 0; i < PM; ++i) {
#pragma unroll
          for (int j = 0; j < PN; ++j) {
#pragma unroll
            for (int h = 0; h < CH; ++h) c[i][j][h] = 0.f;
          }
        }
        // the whole padded row: w's pad columns and zz there are 0, and a Q
        // test here would cost a branch per float4
#pragma unroll
        for (int q4 = 0; q4 < kQP / 4; ++q4) {
          const float4 v = wr[q4];
          const float vq[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int i = 0; i < PM; ++i) {
#pragma unroll
              for (int j = 0; j < PN; ++j) c[i][j][u % CH] = fmaf(vq[u], zz[i][j][4 * q4 + u], c[i][j][u % CH]);
            }
          }
        }
        const float bt = b_s[buf][tt];
#pragma unroll
        for (int i = 0; i < PM; ++i) {
          const float at = bt + em_s[buf][tt * B + PM * ty + i];
#pragma unroll
          for (int j = 0; j < PN; ++j) {
            float cs = c[i][j][0];
#pragma unroll
            for (int h = 1; h < CH; ++h) cs += c[i][j][h];
            const float logp = fmaf(-0.5f, cs, (at + en_s[buf][tt * B + PN * tx + j]) - d1[i][j]);
            acc[i][j] += expf(logp);
          }
        }
      }
    }
    __syncthreads();  // this buffer is free for the stage after next
  }

  // the instance's own partials, output and ticket counters
  float* partial = a.partial + inst * a.n_split * a.n_pairs * B * B;
  float* out = a.out + inst * M * M;
  unsigned* tickets = a.tickets + inst * a.n_pairs;
  float* part = partial + ((size_t)split * a.n_pairs + blockIdx.x) * B * B;
#pragma unroll
  for (int i = 0; i < PM; ++i) {
#pragma unroll
    for (int j = 0; j < PN; ++j) part[(PM * ty + i) * B + PN * tx + j] = acc[i][j];
  }

  // ticket: the last block of this tile pair sums the splits in ascending
  // order, each thread EP elements at once so their loads are in flight together
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + blockIdx.x, 1u) == (unsigned)(a.n_split - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* p0 = partial + (size_t)blockIdx.x * B * B + tid;
  const size_t stride = (size_t)a.n_pairs * B * B;
  float v[EP];
#pragma unroll
  for (int e = 0; e < EP; ++e) v[e] = 0.f;
#pragma unroll 8
  for (int k = 0; k < a.n_split; ++k) {
    float x[EP];
#pragma unroll
    for (int e = 0; e < EP; ++e) x[e] = __ldcg(p0 + k * stride + e * NT);
#pragma unroll
    for (int e = 0; e < EP; ++e) v[e] += x[e];
  }
  const bool diag = ti == tj;
#pragma unroll
  for (int e = 0; e < EP; ++e) {
    const int i = tid + e * NT;
    const int m = m0 + i / B;
    const int n = n0 + i % B;
    if (m < M && n < M && (!diag || m <= n)) {
      out[(size_t)m * M + n] = v[e];
      out[(size_t)n * M + m] = v[e];
    }
  }
  if (tid == 0) tickets[blockIdx.x] = 0u;
}

template <int QMAX>
int launch(const FwdArgs& a, int batch, cudaStream_t s) {
  psi2_fwd_kernel<QMAX><<<dim3(a.n_pairs, a.n_split, batch), threads_of(QMAX), 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rgp_psi2_fwd_max_q() { return kMaxQ; }
// the output tile edge and the blocks per SM the launch bounds aim at, for Q
extern "C" int rgp_psi2_fwd_tile(int Q) { return tile_of(Q); }
extern "C" int rgp_psi2_fwd_blocks_per_sm(int Q) { return blocks_per_sm(Q); }
extern "C" int rgp_psi2_fwd_max_batch() { return kMaxBatch; }

// One launch on `stream` over `batch` instances; returns cudaGetLastError()
// (0 = launched). Instance b reads base + b sb_base (T,), E + b sb_E (T, M),
// D1 + b sb_D1 (M, M), w + b sb_w (T, Q) and Z + b sb_Z (M, Q), each dense
// (a batch stride of 0 shares the input), and writes out + b M^2 (M, M).
// partial: (batch, n_split, n_pairs, B, B) scratch with B =
// rgp_psi2_fwd_tile(Q) and n_pairs = n(n+1)/2, n = ceil(M / B); tickets:
// n_tickets >= batch n_pairs unsigned counters, all 0, left 0. All float32,
// row-major.
extern "C" int rgp_psi2_fwd(const float* base, const float* E, const float* D1, const float* w,
                            const float* Z, float* partial, float* out, unsigned* tickets,
                            int n_tickets, int T, int M, int Q, int n_split, int t_per_split,
                            int batch, long long sb_base, long long sb_E, long long sb_D1,
                            long long sb_w, long long sb_Z, void* stream) {
  if (T < 1 || M < 1 || Q < 1 || Q > kMaxQ || n_split < 1 || t_per_split < 1 ||
      (long long)n_split * t_per_split < T || (long long)(n_split - 1) * t_per_split >= T ||
      batch < 1 || batch > kMaxBatch || sb_base < 0 || sb_E < 0 || sb_D1 < 0 || sb_w < 0 || sb_Z < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int B = tile_of(Q);
  const int n_tiles = (M + B - 1) / B;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  if (n_tickets < (long long)batch * n_pairs) return (int)cudaErrorInvalidValue;
  const FwdArgs a{base, E, D1, w, Z, partial, out, tickets, sb_base, sb_E, sb_D1, sb_w, sb_Z,
                  T, M, Q, n_tiles, n_pairs, n_split, t_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (qmax_of(Q)) {
    case 4: return launch<4>(a, batch, s);
    case 8: return launch<8>(a, batch, s);
    case 20: return launch<20>(a, batch, s);
    case 32: return launch<32>(a, batch, s);
  }
  return launch<kMaxQ>(a, batch, s);
}

// K3: the RBF Psi2 of each row contracted against the predictive's matrices,
// for Hopper (sm_90a). It computes, for each row t and each column d,
//
//   out[t,d] = sum_{m,n} G_d[m,n] exp(base[t] - D1[m,n] + E[t,m] + E[t,n] - 1/2 C[t,m,n]),
//   C[t,m,n] = sum_q w[t,q] z[m,q] z[n,q],
//   G_d = alpha_d alpha_d^T - W,
//
// with (base, E, D1, w) from rbf_psi2_precompute (as K1 takes them), alpha the
// sparse posterior's (M, D) weights and W its (M, M) Woodbury inverse. So
// out[t,d] = alpha_d^T Psi2_t alpha_d - tr(W Psi2_t): the two contractions of
// the moment-matched predictive, quad minus trace, in one sum, without the
// (T, M, M) tensor of Psi2_t ever being written.
//
// It replaces no Pallas kernel: the JAX package's predictive materialises
// Psi2_t under XLA and contracts it with two einsums. It is K1's element
// walked the other way round: K1 sums over t and keeps (m, n); K3 sums over
// (m, n) and keeps t.
//
// What bounds it on this card: per element (t, m, n) 2Q+5 FP32 operations
// and one exp (Q FFMAs for C, two adds, a subtraction and an FMA for the
// exponent), then one FFMA a column; its bytes are O(T(Q+M+D) + M^2), a few
// MB at 16,384 rows, so it is bound by FP32 instruction and exp throughput.
// Only the upper triangle is computed, M(M+1)/2 elements a row, each
// off-diagonal one weighted by G_d[m,n] + G_d[n,m] (W is symmetric only to
// rounding).
//
// What the design does about it:
//  * Elements stationary, rows streamed. A block's 256 threads each own up
//    to EPT elements (m, n) of the triangle, numbered row by row and dealt
//    out so that neighbouring threads hold neighbouring n. Each thread keeps
//    zz[q] = z[m,q] z[n,q] (the t-invariant half of C), D1[m,n] and the
//    weights G_d in registers, so a row costs exactly Q FFMAs an element;
//    the w row is a broadcast read from shared memory, E[t,m] and E[t,n] two
//    reads. EPT follows the compile-time width: 10 elements at Q <= 4, 6 at
//    Q <= 8, 4 at Q <= 20, 2 at Q <= 32 and 1 above (8, 5, 3, 2, 1 where a
//    launch takes 2 to 4 columns), so a thread's elements fit in about 100
//    registers. The caller cuts the triangle into groups of whole threads'
//    slots (element_groups in ops/cuda/psi2_contract.py, whose plain
//    version sums the same groups): 5 groups of 1,024 slots at M = 100 and
//    Q = 20 (5,050 elements), 2 of 2,560 at Q = 1. A launch refuses groups
//    that need more than EPT elements a thread.
//  * Rows are the parallel axis. A block takes a range of rows, stages all of
//    them (base, the w rows padded to the compile-time width, the E rows) in
//    shared memory once, then walks the groups: it loads a group's elements
//    into registers and runs every row of its range through them. The ranges
//    are planned here (plan_rows) to fill whole waves of 132 SMs x 2 blocks:
//    63 rows a block (261 blocks) at 16,384 rows, 4 rows a block (256
//    blocks) at 1,024, so both widths fill the card; at 1,024 rows a block
//    reloads each group's registers for few rows, which costs little beside
//    the rows themselves at Q <= 20.
//  * Reduction in a fixed order, no atomics. A thread sums its elements of a
//    row in float32. A warp reduces 8 values (8 rows at D = 1, 2 rows of 4
//    columns at D <= 4) at a time by recursive halving across its 32 lanes:
//    9 shuffles for 8 values, where one full reduction a value costs 5. The
//    8 warps' sums of a group are added in ascending warp order into a
//    float64 accumulator a row in shared memory, and the groups in ascending
//    order; the row is written once, rounded to float32. So no block writes
//    another's rows, the same inputs give the same bits in every launch, in
//    a replayed CUDA graph too, and the long sum (5,050 terms of both signs)
//    is combined in float64: at least as exact as the float32 einsums it
//    replaces.
//  * FFMA in full FP32: no TF32, which the configurations turn off. expf, not
//    __expf, as in K1. The build uses no --use_fast_math.
//  * One launch a call, any number of rows: under torch.func.vmap the
//    wrapper folds the vmapped axis into the rows. Nothing is allocated but
//    the (T, D) output: no scratch, no ticket counters. The ragged row range
//    and the group's tail are masked in the kernel (a dead slot has weight 0).

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 128;  // largest input width the kernel takes
constexpr int kMaxD = 4;    // columns of alpha one launch takes
constexpr int kSmemBytes = 48 * 1024;  // a block's shared memory, without an opt-in

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }
__host__ __device__ constexpr int qmax_of(int q) {
  return q <= 4 ? 4 : q <= 8 ? 8 : q <= 20 ? 20 : q <= 32 ? 32 : 128;
}
// elements a thread owns, so that zz, D1, the weights and the (m, n) pair fit
// in about 100 registers
__host__ __device__ constexpr int ept_of(int q, int dmax) {
  return dmax == 1 ? (q <= 4 ? 10 : q <= 8 ? 6 : q <= 20 ? 4 : q <= 32 ? 2 : 1)
                   : (q <= 4 ? 8 : q <= 8 ? 5 : q <= 20 ? 3 : q <= 32 ? 2 : 1);
}
__host__ __device__ constexpr int blocks_per_sm(int q) { return q <= 32 ? 2 : 1; }
__host__ __device__ constexpr int dmax_of(int d) { return d == 1 ? 1 : kMaxD; }

constexpr int kMaxWaves = 4;  // more, shorter row ranges only reload the groups' registers more often

// bytes of shared memory a block's row takes in float32: its w row at the
// compile-time width, its E row, base, and the warps' sums
inline long long row_bytes(int M, int q, int d) {
  return 4LL * (round4(qmax_of(q)) + M + 1 + (long long)kWarps * dmax_of(d));
}

// bytes of dynamic shared memory for a block of `rows` rows: the rows' float64
// sums, 16-byte aligned, then row_bytes a row (the kernel's layout)
inline long long smem_bytes(int M, int q, int d, int rows) {
  return ((long long)rows * dmax_of(d) * 8 + 15) / 16 * 16 + rows * row_bytes(M, q, d);
}

// Rows a block takes: the range that fills whole waves of sms x blocks_per_sm
// resident blocks best, in at most kMaxWaves waves (among equals, the fewest
// ranges), and no more than a block's shared memory holds (the sums'
// alignment takes at most 15 bytes more). 0 where not one row fits.
inline int plan_rows(int T, int M, int q, int d, int sms) {
  const long long cap = (kSmemBytes - 16) / (row_bytes(M, q, d) + 8LL * dmax_of(d));
  if (cap < 1) return 0;
  const long long slots = (long long)sms * blocks_per_sm(q);
  double best = -1.0;
  long long rows = T;
  for (long long n = 1; n <= std::max(1LL, std::min((long long)T, kMaxWaves * slots)); ++n) {
    const long long per = (T + n - 1) / n;
    const long long blocks = (T + per - 1) / per;
    const double fill = (double)blocks / (double)(((blocks + slots - 1) / slots) * slots);
    if (fill > best) {
      best = fill;
      rows = per;
    }
  }
  return (int)std::min(rows, cap);
}

struct Args {
  const float* base;   // (T,)
  const float* E;      // (T, M)
  const float* D1;     // (M, M)
  const float* w;      // (T, Q)
  const float* Z;      // (M, Q)
  const float* alpha;  // (M, lda), columns [0, D) read
  const float* W;      // (M, M)
  float* out;          // (T, ldo), columns [0, D) written
  long long lda, ldo;
  int T, M, Q, D, rows, groups, k_n;
};

// row m of the upper triangle, numbered row by row, that holds element e
__device__ __forceinline__ void decode(int e, int M, int* m, int* n) {
  const double b = 2.0 * M + 1.0;
  int r = (int)((b - sqrt(b * b - 8.0 * e)) * 0.5);
  r = max(0, min(r, M - 1));
  // offset(r) = r M - r (r - 1) / 2 elements lie before row r
  while (r > 0 && (long long)r * M - (long long)r * (r - 1) / 2 > e) --r;
  while (r + 1 < M && (long long)(r + 1) * M - (long long)(r + 1) * r / 2 <= e) ++r;
  *m = r;
  *n = r + (int)(e - ((long long)r * M - (long long)r * (r - 1) / 2));
}

template <int QMAX, int DMAX>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(QMAX)) psi2_contract_kernel(const Args a) {
  constexpr int EPT = ept_of(QMAX, DMAX);
  constexpr int QP = round4(QMAX);
  constexpr int CH = EPT >= 4 ? 1 : 4 / EPT;  // chains a element's q sum runs in
  constexpr int RB = 8 / DMAX;                 // rows a warp reduces at a time
  extern __shared__ __align__(16) unsigned char smem[];

  const int M = a.M, Q = a.Q, D = a.D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * a.rows;
  const int nr = min(a.rows, a.T - row0);
  double* acc_s = reinterpret_cast<double*>(smem);
  float* w_s = reinterpret_cast<float*>(smem + ((long long)a.rows * DMAX * 8 + 15) / 16 * 16);
  float* e_s = w_s + a.rows * QP;
  float* b_s = e_s + a.rows * M;
  float* red_s = b_s + a.rows;  // (kWarps, rows * DMAX): a group's warp sums

  // stage the block's rows; the w rows' pad columns are read (times zz = 0)
  // and must not be NaN
  for (int i = tid; i < nr * QP; i += kThreads) {
    const int r = i / QP, q = i - r * QP;
    w_s[i] = q < Q ? a.w[(long long)(row0 + r) * Q + q] : 0.f;
  }
  for (long long i = tid; i < (long long)nr * M; i += kThreads) e_s[i] = a.E[(long long)row0 * M + i];
  for (int i = tid; i < nr; i += kThreads) b_s[i] = a.base[row0 + i];
  for (int i = tid; i < nr * DMAX; i += kThreads) acc_s[i] = 0.0;

  const long long n_elem = (long long)M * (M + 1) / 2;
  for (int g = 0; g < a.groups; ++g) {
    // this thread's elements of group g, their zz, D1 and weights
    float zz[EPT][QP], d1[EPT], G[EPT][DMAX];
    int em[EPT], en[EPT];
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      const long long e = ((long long)g * a.k_n + k) * kThreads + tid;
      const bool live = k < a.k_n && e < n_elem;
      int m = 0, n = 0;
      if (live) decode((int)e, M, &m, &n);
      em[k] = m;
      en[k] = n;
#pragma unroll
      for (int q = 0; q < QP; ++q) {
        zz[k][q] = (live && q < Q) ? __ldg(a.Z + (long long)m * Q + q) * __ldg(a.Z + (long long)n * Q + q) : 0.f;
      }
      d1[k] = live ? __ldg(a.D1 + (long long)m * M + n) : 0.f;
#pragma unroll
      for (int d = 0; d < DMAX; ++d) {
        float gv = 0.f;
        if (live && d < D) {
          const float am = __ldg(a.alpha + (long long)m * a.lda + d);
          if (m == n) {
            gv = am * am - __ldg(a.W + (long long)m * M + m);
          } else {
            const float an = __ldg(a.alpha + (long long)n * a.lda + d);
            gv = 2.f * (am * an) - (__ldg(a.W + (long long)m * M + n) + __ldg(a.W + (long long)n * M + m));
          }
        }
        G[k][d] = gv;
      }
    }
    __syncthreads();  // the rows are staged (first group) and red_s is free

    for (int rb = 0; rb < nr; rb += RB) {
      float v[8];
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) {
        float s[DMAX];
#pragma unroll
        for (int d = 0; d < DMAX; ++d) s[d] = 0.f;
        const int r = rb + rr;
        if (r < nr) {
          const float4* wr = reinterpret_cast<const float4*>(w_s + r * QP);
          const float* er = e_s + (long long)r * M;
          const float bt = b_s[r];
          float c[EPT][CH];
#pragma unroll
          for (int k = 0; k < EPT; ++k) {
#pragma unroll
            for (int h = 0; h < CH; ++h) c[k][h] = 0.f;
          }
#pragma unroll
          for (int q4 = 0; q4 < QP / 4; ++q4) {
            const float4 wv = wr[q4];
            const float wq[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
#pragma unroll
              for (int k = 0; k < EPT; ++k) c[k][u % CH] = fmaf(wq[u], zz[k][4 * q4 + u], c[k][u % CH]);
            }
          }
#pragma unroll
          for (int k = 0; k < EPT; ++k) {
            if (k < a.k_n) {
              float cs = c[k][0];
#pragma unroll
              for (int h = 1; h < CH; ++h) cs += c[k][h];
              const float p = expf(fmaf(-0.5f, cs, ((bt + er[em[k]]) + er[en[k]]) - d1[k]));
#pragma unroll
              for (int d = 0; d < DMAX; ++d) s[d] = fmaf(G[k][d], p, s[d]);
            }
          }
        }
#pragma unroll
        for (int d = 0; d < DMAX; ++d) v[rr * DMAX + d] = s[d];
      }
      // recursive halving: lane l ends with the warp's sum of value (l >> 2) & 7
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool up = lane & 16;
        const float send = up ? v[i] : v[4 + i];
        v[i] = (up ? v[4 + i] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bool up = lane & 8;
        const float send = up ? v[i] : v[2 + i];
        v[i] = (up ? v[2 + i] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 8);
      }
      {
        const bool up = lane & 4;
        const float send = up ? v[0] : v[1];
        v[0] = (up ? v[1] : v[0]) + __shfl_xor_sync(0xffffffffu, send, 4);
      }
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
      const int idx = rb * DMAX + ((lane >> 2) & 7);
      if ((lane & 3) == 0 && idx < nr * DMAX) red_s[warp * a.rows * DMAX + idx] = v[0];
    }
    __syncthreads();  // the group's warp sums are in
    for (int i = tid; i < nr * DMAX; i += kThreads) {
      double t = 0.0;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) t += (double)red_s[wi * a.rows * DMAX + i];
      acc_s[i] += t;
    }
    // the next group's first write to red_s follows its own __syncthreads
  }
  __syncthreads();
  for (int i = tid; i < nr * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    a.out[(long long)(row0 + r) * a.ldo + d] = (float)acc_s[r * DMAX + d];
  }
}

template <int QMAX, int DMAX>
int launch(const Args& a, int blocks, int smem, cudaStream_t s) {
  if (a.k_n > ept_of(QMAX, DMAX)) return (int)cudaErrorInvalidValue;  // more elements than a thread holds
  psi2_contract_kernel<QMAX, DMAX><<<blocks, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int DMAX>
int launch_q(const Args& a, int blocks, int smem, cudaStream_t s) {
  switch (qmax_of(a.Q)) {
    case 4: return launch<4, DMAX>(a, blocks, smem, s);
    case 8: return launch<8, DMAX>(a, blocks, smem, s);
    case 20: return launch<20, DMAX>(a, blocks, smem, s);
    case 32: return launch<32, DMAX>(a, blocks, smem, s);
  }
  return launch<kMaxQ, DMAX>(a, blocks, smem, s);
}

}  // namespace

// One launch on `stream` over T rows: out[t, d] for d < D of out (T, ldo),
// from base (T,), E (T, M), D1 (M, M), w (T, Q), Z (M, Q), alpha (M, lda) and
// W (M, M), all float32, row-major and dense. The triangle's elements,
// numbered row by row, are cut into `groups` groups of `per_group` (a
// multiple of the block's threads; the last group shorter). The rows a block
// takes are planned for `sms` SMs. Returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for arguments it does not take: a Q or
// D above kMaxQ or kMaxD, groups that miss an element or need more than a
// thread holds, or a row that does not fit in a block's shared memory.
extern "C" int rgp_psi2_contract(const float* base, const float* E, const float* D1, const float* w,
                                 const float* Z, const float* alpha, long long lda, const float* W, float* out,
                                 long long ldo, int T, int M, int Q, int D, int groups, int per_group, int sms,
                                 void* stream) {
  const long long n_elem = (long long)M * (M + 1) / 2;
  if (T < 1 || M < 1 || Q < 1 || Q > kMaxQ || D < 1 || D > kMaxD || lda < D || ldo < D || sms < 1 ||
      n_elem >= (1LL << 31) || groups < 1 || per_group < 1 || per_group % kThreads != 0 ||
      (long long)groups * per_group < n_elem || (long long)(groups - 1) * per_group >= n_elem) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = plan_rows(T, M, Q, D, sms);
  if (rows < 1) return (int)cudaErrorInvalidValue;
  Args a{base, E, D1, w, Z, alpha, W, out, lda, ldo, T, M, Q, D, rows, groups, per_group / kThreads};
  const int blocks = (T + rows - 1) / rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = (int)smem_bytes(M, Q, D, rows);
  return dmax_of(D) == 1 ? launch_q<1>(a, blocks, smem, s) : launch_q<kMaxD>(a, blocks, smem, s);
}

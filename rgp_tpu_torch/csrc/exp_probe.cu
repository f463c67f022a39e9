// Exp-rate probe: a measuring instrument for the roofline
// (rgp_tpu_torch/bench/roofline.py::calibrate), not a port of a TPU kernel.
//
// Each thread loads one float, applies x = expf(x * 1e-6f) k times in
// registers and stores the result, so device memory is touched twice per
// element while the exp runs k times: at k = 64 the time is that of the
// exp's instruction sequence, not of the memory (one eager torch.exp a link
// of the chain would be 64 memory-bound kernels). It calls expf, as K1 does
// (psi2_fwd.cu), not __expf, so the ceiling it measures is that of the
// instructions K1 really issues. The 1e-6 factor keeps every value near 1.
//
// One launch a call, on the caller's stream; a grid-stride loop covers any
// n. Returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256) exp_probe_kernel(const float* __restrict__ x, float* __restrict__ y,
                                                         long long n, int k) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    float v = x[i];
#pragma unroll 8
    for (int j = 0; j < k; ++j) v = expf(v * 1e-6f);
    y[i] = v;
  }
}

}  // namespace

extern "C" int rgp_exp_probe(const float* x, float* y, long long n, int k, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  // 132 SMs x 8 resident blocks of 256 threads: every SM full, then the
  // grid-stride loop walks the rest
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  exp_probe_kernel<<<static_cast<int>(blocks), threads, 0, stream>>>(x, y, n, k);
  return static_cast<int>(cudaGetLastError());
}

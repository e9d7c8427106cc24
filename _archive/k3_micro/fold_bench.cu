// Micro-benchmark of K3's ring fold (measurement only): one CTA of 256
// threads, a stage of `chunk` entries of `tail` values in shared memory;
// threads t < tail fold the stage `steps` times in list order (fold_run of
// segment_sum.cu), with or without a CTA barrier between steps, or from
// registers only (mode 2). Built alone by _archive/k3_ab.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
__device__ __forceinline__ double add(double x, double y) { return __dadd_rn(x, y); }

__device__ __forceinline__ double fold_run(double acc, const double* v, int n,
                                           int tail) {
  int j = 0;
  if (n >= 8) {
    double w[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) w[u] = v[u * tail];
    for (j = 8; j + 8 <= n; j += 8) {
      double x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = v[(j + u) * tail];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc = add(acc, w[u]);
#pragma unroll
      for (int u = 0; u < 8; ++u) w[u] = x[u];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = add(acc, w[u]);
  }
  for (; j < n; ++j) acc = add(acc, v[j * tail]);
  return acc;
}

__global__ void bench(double* out, int steps, int chunk, int tail, int mode) {
  extern __shared__ double st[];
  for (int x = threadIdx.x; x < chunk * tail; x += blockDim.x)
    st[x] = 1e-3 * (x % 7);
  __syncthreads();
  double acc = 0;
  const int t = threadIdx.x;
  for (int s = 0; s < steps; ++s) {
    if (t < tail) {
      if (mode == 2) {
        const double y = st[t];
        for (int j = 0; j < chunk; ++j) acc = add(acc, y);
      } else {
        acc = fold_run(acc, st + t, chunk, tail);
      }
    }
    if (mode != 1) __syncthreads();
  }
  if (t < tail) out[t] = acc;
}
}  // namespace

extern "C" int fold_bench(void* out, int steps, int chunk, int tail, int mode,
                          void* stream) {
  const int bytes = chunk * tail * 8;
  cudaFuncSetAttribute(bench, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  bench<<<1, 256, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(out), steps, chunk, tail, mode);
  return static_cast<int>(cudaGetLastError());
}

// Batched closed-form inverse of symmetric 3x3 blocks for Hopper (sm_90a).
//
// Replaces the TPU kernel linearsfm_tpu/ops/pallas_kernels.py:inv3x3_sym
// (body _inv3x3_kernel). It inverts the feature blocks V of every join
// (ops/schur.py): float32 for the Schur preconditioner of the PCG levels,
// float64 for the plain-Cholesky ("direct") levels, which the TPU kernel
// could not take. Only the upper triangle (a b c / d e / f) is read;
// det == 0 (the zero padding blocks) gives a zero block, a NaN determinant
// stays NaN.
//
// What bounds it: bytes. Per float32 block it reads 24 of the 36 bytes and
// writes 36, against 19 multiplies/adds and one division, so it runs at
// memory bandwidth whatever the arithmetic does.
//
// Design: one thread per block over the flattened [P*N] blocks. The TPU
// version viewed the batch as six structure-of-arrays planes padded to
// (8, 128) tiles for the VPU; here neighbouring threads read neighbouring
// 36-byte blocks, which the L1/L2 coalesce, so no relayout or padding pass is
// needed. Every product and sum is a round-to-nearest intrinsic in the plain
// version's order (PyTorch evaluates d*f - e*e as two multiplies and a
// subtract, never as an FMA), and the reciprocal is an IEEE division, so the
// kernel equals the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ float rcp(float x) { return __fdiv_rn(1.0f, x); }
__device__ __forceinline__ double mul(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ double sub(double x, double y) { return __dsub_rn(x, y); }
__device__ __forceinline__ double add(double x, double y) { return __dadd_rn(x, y); }
__device__ __forceinline__ double rcp(double x) { return __ddiv_rn(1.0, x); }

template <typename T>
__global__ void inv3x3_sym_kernel(const T* __restrict__ V, T* __restrict__ out,
                                  int64_t n) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= n) return;
  const T* v = V + k * 9;
  const T a = v[0], b = v[1], c = v[2];
  const T d = v[4], e = v[5], f = v[8];
  const T A = sub(mul(d, f), mul(e, e));
  const T B = sub(mul(c, e), mul(b, f));
  const T C = sub(mul(b, e), mul(c, d));
  const T D = sub(mul(a, f), mul(c, c));
  const T E = sub(mul(b, c), mul(a, e));
  const T F = sub(mul(a, d), mul(b, b));
  const T det = add(add(mul(a, A), mul(b, B)), mul(c, C));
  // det == 0 -> 0 (a NaN det compares unequal and stays NaN)
  const T inv = det == T(0) ? T(0) : rcp(det);
  T* o = out + k * 9;
  o[0] = mul(A, inv); o[1] = mul(B, inv); o[2] = mul(C, inv);
  o[3] = mul(B, inv); o[4] = mul(D, inv); o[5] = mul(E, inv);
  o[6] = mul(C, inv); o[7] = mul(E, inv); o[8] = mul(F, inv);
}

template <typename T>
int launch(const void* V, void* out, int64_t n, void* stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (n < 0 || blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    inv3x3_sym_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(V), static_cast<T*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// V[n, 3, 3] and out[n, 3, 3] contiguous; launches on `stream`; returns
// cudaGetLastError().
extern "C" int inv3x3_sym_f32(const void* V, void* out, int64_t n,
                              void* stream) {
  return launch<float>(V, out, n, stream);
}

extern "C" int inv3x3_sym_f64(const void* V, void* out, int64_t n,
                              void* stream) {
  return launch<double>(V, out, n, stream);
}

// Kernel K3 for Hopper (sm_90a): the fixed-order segment sum.
//
// Not the port of a TPU kernel: it replaces the atomics that PyTorch's
// index_add_ uses on the card for what the JAX package writes as
// jax.ops.segment_sum / .at[].add, which XLA sums in a fixed order (for
// example linearsfm_tpu/ops/congruence.py:39, linearsfm_tpu/ops/schur.py:70-76,
// :324-325, :356, :361). Atomics add a segment's values in whatever order
// the threads arrive, so float sums change in their last bits from run to
// run; this kernel adds them in list order, so two runs give the same bits.
//
//   out[r, t] = base[r, t] (or 0) (+|-) v[k0, t] (+|-) v[k1, t] (+|-) ...
//
// added left to right over the entries k0 < k1 < ... of output row r's
// segment. The entries come from a plan (ops/kernels.seg_plan): `perm` lists
// the entries by one stable sort of their flat keys (lane * (num + 1) +
// index, a dropped index routed to index num), `off` holds the first sorted
// position of every one of the P * (num + 1) segments plus the end. Output
// row r = p * num + s is segment g = r + p: each lane's drop segment is
// skipped, never read and never written. Every add is a round-to-nearest
// intrinsic in the value's own type (no FMA, no wider accumulator), so the
// result is bit-equal to the CPU's index_add_, which adds in list order too
// (alpha = -1: one subtraction per entry, as index_add_ rounds x + (-1) v).
//
// What bounds it: bytes. Each kept entry is read once (its T values and its
// 4-byte position in perm), each segment's two offsets once, each output
// element written once (and read once in the accumulate-into form): one add
// per value read, far below the card's operations per byte. Least time:
//   (kept * (T * esz + 4) + (P * (num + 1) + 1) * 4 + rows * T * esz
//    [+ rows * T * esz]) bytes over 3.35 TB/s.
//
// Design: one thread per (output row, tail element), 256 to a CTA. The
// threads of one row read the consecutive elements of each entry's value
// row, so a warp's loads of one entry coalesce; each thread loops over its
// segment's entries in ascending sorted position and writes its element
// once, loading up to 32 entries ahead of their adds. So no zero fill, no
// atomics and no second pass; an empty segment writes its base (or zero).
// Base and out may be the same tensor (the accumulate-into form updates in
// place: each element is read and written by its one thread). A simple
// kernel, right first: staging entries in shared memory, vector loads and
// a warp for each long segment are later work. A segment's adds are one
// dependent chain however it is split, so a long one (the lists' zero
// padding all sums into segment 0: about 1,000 entries at 256 maps)
// bounds a launch from below.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ double add(double x, double y) { return __dadd_rn(x, y); }
__device__ __forceinline__ double sub(double x, double y) { return __dsub_rn(x, y); }

// acc (+|-)= the values of positions [j, j + U) of the segment, in order:
// the U loads are issued before the first add, so a long segment keeps U
// loads in flight instead of one
template <int U, typename T, bool kNegate>
__device__ __forceinline__ T chunk(T acc, const int32_t* __restrict__ perm,
                                   const T* __restrict__ vals, int32_t j,
                                   int64_t tail, int64_t t) {
  T v[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    v[u] = __ldg(vals + static_cast<int64_t>(__ldg(perm + j + u)) * tail + t);
#pragma unroll
  for (int u = 0; u < U; ++u) acc = kNegate ? sub(acc, v[u]) : add(acc, v[u]);
  return acc;
}

template <typename T, bool kNegate>
__global__ void __launch_bounds__(kThreads)
seg_sum_thread_kernel(const int32_t* __restrict__ off,
               const int32_t* __restrict__ perm, const T* __restrict__ vals,
               const T* base, T* out, int64_t n, int64_t num, int64_t tail) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t r = i / tail;
  const int64_t t = i - r * tail;
  const int64_t g = r + r / num;   // lane r / num: skip its drop segments
  const int32_t lo = __ldg(off + g);
  const int32_t hi = __ldg(off + g + 1);
  T acc = base != nullptr ? base[i] : T(0);
  int32_t j = lo;
  for (; j + 32 <= hi; j += 32)
    acc = chunk<32, T, kNegate>(acc, perm, vals, j, tail, t);
  for (; j + 4 <= hi; j += 4)
    acc = chunk<4, T, kNegate>(acc, perm, vals, j, tail, t);
  for (; j < hi; ++j) acc = chunk<1, T, kNegate>(acc, perm, vals, j, tail, t);
  out[i] = acc;
}

template <typename T>
int launch(const void* off, const void* perm, const void* vals,
           const void* base, void* out, int64_t rows, int64_t num,
           int64_t tail, int negate, void* stream) {
  if (rows < 0 || num < 0 || tail < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = rows * tail;
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (num == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t grid = (n + kThreads - 1) / kThreads;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* o = static_cast<const int32_t*>(off);
  const auto* p = static_cast<const int32_t*>(perm);
  const auto* v = static_cast<const T*>(vals);
  const auto* b = static_cast<const T*>(base);
  auto* y = static_cast<T*>(out);
  if (negate)
    seg_sum_thread_kernel<T, true><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        o, p, v, b, y, n, num, tail);
  else
    seg_sum_thread_kernel<T, false><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        o, p, v, b, y, n, num, tail);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// off int32 [P * (num + 1) + 1] and perm int32 [P * K] from the plan,
// vals [P * K, tail], out [rows = P * num, tail] and base (null, or the
// accumulate-into form's input, which may be out itself), all contiguous.
// negate != 0 subtracts every entry (index_add_'s alpha = -1). Writes every
// element of out; launches on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int seg_sum_thread_f32(const void* off, const void* perm,
                           const void* vals, const void* base, void* out,
                           int64_t rows, int64_t num, int64_t tail,
                           int negate, void* stream) {
  return launch<float>(off, perm, vals, base, out, rows, num, tail, negate,
                       stream);
}

extern "C" int seg_sum_thread_f64(const void* off, const void* perm,
                           const void* vals, const void* base, void* out,
                           int64_t rows, int64_t num, int64_t tail,
                           int negate, void* stream) {
  return launch<double>(off, perm, vals, base, out, rows, num, tail, negate,
                        stream);
}

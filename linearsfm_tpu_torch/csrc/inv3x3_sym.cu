// Kernel K2 for Hopper (sm_90a), fused: the inverses of the symmetric 3x3
// feature blocks and the products Y = W Vinv[wf], in one launch.
//
// Replaces the TPU kernel linearsfm_tpu/ops/pallas_kernels.py:inv3x3_sym
// (body _inv3x3_kernel) and, at every site that consumed its output, the
// gather Vinv[wf] and the batched 6x3 by 3x3 product that followed it
// (ops/schur.solve_full_mixed for the float32 PCG levels, core/join's
// float64 "direct" levels):
//   Vinv[p, n] = inv3x3_sym(V[p, n])           for every feature block,
//   Y[p, k]    = W[p, k] @ Vinv[p, wf[p, k]]   for every W-list entry,
// with wf = Wpf[..., 1] read in place from the int64 (wp, wf) pairs. Only the
// upper triangle of a V block (a b c / d e / f) is read; det == 0 (the zero
// padding blocks) gives a zero inverse, a NaN determinant stays NaN, and an
// entry whose wf lies outside [0, N) gets Y = 0. K = 0 is the inverse alone
// (ops/kernels.inv3x3_sym).
//
// Exactness: every product and sum is a round-to-nearest intrinsic in the
// plain version's order (ops/kernels.inv3x3_wy_ref, whose elementwise
// PyTorch ops are never contracted into FMAs), the reciprocal an IEEE
// division, and Y[i, j] = (W[i,0] G[0,j] + W[i,1] G[1,j]) + W[i,2] G[2,j].
// G is the inverse of V[p, wf] recomputed in registers by the same sequence,
// so it equals the stored Vinv bit for bit, and the kernel equals the plain
// version bit for bit (NaN where it is NaN).
//
// What bounds it: bytes. Per float32 W entry it reads 72 bytes of W and the
// 16-byte pair and writes 72 bytes of Y, against 90 multiplies and adds (123
// with the recomputed inverse); per V block 24 of 36 bytes read, 36 written,
// 33 operations and one division. That is below one operation per byte,
// against the card's 20 float32 (10 float64) operations per byte of HBM, so
// the least time is the bytes over the memory rate:
//   P*N*(6 + 9)*esz + P*K*((18 + 18)*esz + 16) bytes over 3.35 TB/s.
// Tensor cores buy nothing at 6x3x3.
//
// Design:
// * Recompute, do not gather: each W entry recomputes the inverse of its own
//   V block (33 operations against 160 bytes moved), so the Vinv writers and
//   the Y writers do not depend on each other: one launch, no second pass,
//   no grid-wide barrier. V is small enough to stay in the 50 MB L2 (0.42
//   MB at the 2,048-map root) and is read through the read-only path.
// * Tiles of 256 items (W entries, then V blocks), one CTA of 256 threads
//   each, one thread an item. One thread arms an mbarrier and brings the
//   tile's values (W: 18 KB in float32) and its pairs into shared memory
//   with 1-D bulk copies (cp.async.bulk); each thread reads its item from
//   shared memory, writes its outputs over it, and one bulk copy writes the
//   tile out, with the L2 evict-first hint that K1 uses (the outputs stream
//   past the L2; W and V are read again by the next kernels). So global
//   memory sees whole 18 KB transfers both ways, where one thread per item
//   storing 72-byte rows straight to global memory would not coalesce.
// * Overlap comes from residency instead of a ring inside the CTA: 22.5 KB
//   of shared memory and 256 threads per CTA leave several CTAs on each SM
//   (fewer in float64: 40 KB a tile), so while one CTA computes or stores,
//   the others' bulk loads are in flight.
// * A tile whose byte count is not a multiple of 16 (a float32 list's last
//   tile when its count is odd) or whose operands are not 16-byte aligned
//   goes through the same shared buffer with plain coalesced loads and
//   stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 256;   // items per tile = threads per CTA

__device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ float rcp(float x) { return __fdiv_rn(1.0f, x); }
__device__ __forceinline__ double mul(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ double sub(double x, double y) { return __dsub_rn(x, y); }
__device__ __forceinline__ double add(double x, double y) { return __dadd_rn(x, y); }
__device__ __forceinline__ double rcp(double x) { return __ddiv_rn(1.0, x); }

// The six distinct values of the inverse of the symmetric block with upper
// triangle (a b c / d e / f): g = (A B C D E F) / det, the full inverse being
// [[g0 g1 g2] [g1 g3 g4] [g2 g4 g5]]; det == 0 gives zeros.
template <typename T>
__device__ __forceinline__ void inverse(T a, T b, T c, T d, T e, T f,
                                        T g[6]) {
  const T A = sub(mul(d, f), mul(e, e));
  const T B = sub(mul(c, e), mul(b, f));
  const T C = sub(mul(b, e), mul(c, d));
  const T D = sub(mul(a, f), mul(c, c));
  const T E = sub(mul(b, c), mul(a, e));
  const T F = sub(mul(a, d), mul(b, b));
  const T det = add(add(mul(a, A), mul(b, B)), mul(c, C));
  // det == 0 -> 0 (a NaN det compares unequal and stays NaN)
  const T inv = det == T(0) ? T(0) : rcp(det);
  g[0] = mul(A, inv); g[1] = mul(B, inv); g[2] = mul(C, inv);
  g[3] = mul(D, inv); g[4] = mul(E, inv); g[5] = mul(F, inv);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(1)
               : "memory");
  // the initialisation, visible to the bulk copies' completion
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// global -> shared, completing `bytes` transactions on the mbarrier
__device__ __forceinline__ void bulk_load(void* sdst, const void* gsrc,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(sdst)),
      "l"(gsrc), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared -> global with an L2 evict-first hint; returns once the shared
// memory has been read (the CTA may then exit)
__device__ __forceinline__ void bulk_store(void* gdst, const void* ssrc,
                                           uint32_t bytes) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint "
      "[%0], [%1], %2, %3;\n" ::"l"(gdst),
      "r"(smem_addr(ssrc)), "r"(bytes), "l"(policy)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

template <typename T>
struct Args {
  const T* V;              // [P, N, 3, 3]
  const T* W;              // [P, K, 6, 3]
  const int64_t* Wpf;      // [P, K, 2]: (wp, wf)
  T* Vinv;                 // [P, N, 3, 3]
  T* Y;                    // [P, K, 6, 3]
  int64_t N, K;
  int64_t n_entries;       // P * K
  int64_t n_blocks;        // P * N
  int64_t n_wtiles;        // the W tiles come first, then the V tiles
  int bulk;                // every operand 16-byte aligned
};

// one tile's values (W then Y, or V then Vinv) and a W tile's pairs
template <typename T>
struct Smem {
  alignas(128) T vals[kT * 18];
  alignas(16) int64_t pairs[kT * 2];
  uint64_t bar;
};

template <typename T>
__global__ void __launch_bounds__(kT) inv3x3_wy_kernel(const Args<T> a) {
  __shared__ Smem<T> s;
  const int tid = threadIdx.x;
  const bool wtile = blockIdx.x < a.n_wtiles;
  const int64_t i0 =
      (wtile ? static_cast<int64_t>(blockIdx.x)
             : static_cast<int64_t>(blockIdx.x) - a.n_wtiles) * kT;
  const int64_t total = wtile ? a.n_entries : a.n_blocks;
  const int n = static_cast<int>(total - i0 < kT ? total - i0 : kT);
  const int width = wtile ? 18 : 9;   // values per item
  const T* src = (wtile ? a.W : a.V) + i0 * width;
  T* dst = (wtile ? a.Y : a.Vinv) + i0 * width;
  const uint32_t vbytes = static_cast<uint32_t>(n * width * sizeof(T));
  const bool bulk = a.bulk && vbytes % 16 == 0;

  if (bulk) {
    if (tid == 0) {
      mbar_init(&s.bar);
      const uint32_t pbytes = wtile ? static_cast<uint32_t>(n * 16) : 0u;
      mbar_expect_tx(&s.bar, vbytes + pbytes);
      bulk_load(s.vals, src, vbytes, &s.bar);
      if (wtile) bulk_load(s.pairs, a.Wpf + i0 * 2, pbytes, &s.bar);
    }
    __syncthreads();   // the barrier is initialised before anyone waits
    while (!mbar_try_wait(&s.bar, 0)) {
    }
  } else {
    for (int q = tid; q < n * width; q += kT) s.vals[q] = src[q];
    if (wtile)
      for (int q = tid; q < n * 2; q += kT) s.pairs[q] = a.Wpf[i0 * 2 + q];
    __syncthreads();
  }

  if (tid < n) {
    T* v = s.vals + tid * width;
    if (wtile) {
      const int64_t p = (i0 + tid) / a.K;
      const int64_t f = s.pairs[tid * 2 + 1];
      if (f >= 0 && f < a.N) {
        const T* vb = a.V + (p * a.N + f) * 9;
        T g[6];
        inverse(__ldg(vb), __ldg(vb + 1), __ldg(vb + 2), __ldg(vb + 4),
                __ldg(vb + 5), __ldg(vb + 8), g);
        const T G[3][3] = {{g[0], g[1], g[2]}, {g[1], g[3], g[4]},
                           {g[2], g[4], g[5]}};
        // row by row, over the thread's own W values in shared memory
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const T w0 = v[i * 3], w1 = v[i * 3 + 1], w2 = v[i * 3 + 2];
#pragma unroll
          for (int j = 0; j < 3; ++j)
            v[i * 3 + j] =
                add(add(mul(w0, G[0][j]), mul(w1, G[1][j])), mul(w2, G[2][j]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 18; ++j) v[j] = T(0);
      }
    } else {
      T g[6];
      inverse(v[0], v[1], v[2], v[4], v[5], v[8], g);
      v[0] = g[0]; v[1] = g[1]; v[2] = g[2];
      v[3] = g[1]; v[4] = g[3]; v[5] = g[4];
      v[6] = g[2]; v[7] = g[4]; v[8] = g[5];
    }
  }

  if (bulk) {
    // every thread's shared-memory writes, visible to the bulk copy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) bulk_store(dst, s.vals, vbytes);
  } else {
    __syncthreads();
    for (int q = tid; q < n * width; q += kT) dst[q] = s.vals[q];
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const void* V, const void* W, const void* Wpf, void* Vinv, void* Y,
           int64_t P, int64_t N, int64_t K, void* stream) {
  if (P < 0 || N < 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args<T> a;
  a.V = static_cast<const T*>(V);
  a.W = static_cast<const T*>(W);
  a.Wpf = static_cast<const int64_t*>(Wpf);
  a.Vinv = static_cast<T*>(Vinv);
  a.Y = static_cast<T*>(Y);
  a.N = N;
  a.K = K;
  a.n_entries = P * K;
  a.n_blocks = P * N;
  a.n_wtiles = (a.n_entries + kT - 1) / kT;
  const int64_t grid = a.n_wtiles + (a.n_blocks + kT - 1) / kT;
  if (grid == 0) return static_cast<int>(cudaSuccess);
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  a.bulk = aligned16(V) && aligned16(Vinv) &&
           (K == 0 || (aligned16(W) && aligned16(Wpf) && aligned16(Y)));
  inv3x3_wy_kernel<T><<<static_cast<unsigned>(grid), kT, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// V[P, N, 3, 3], W[P, K, 6, 3], Wpf[P, K, 2] (int64), Vinv[P, N, 3, 3] and
// Y[P, K, 6, 3], all contiguous (W, Wpf and Y may be null when K == 0).
// Writes every element of Vinv and Y; launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int inv3x3_wy_f32(const void* V, const void* W, const void* Wpf,
                             void* Vinv, void* Y, int64_t P, int64_t N,
                             int64_t K, void* stream) {
  return launch<float>(V, W, Wpf, Vinv, Y, P, N, K, stream);
}

extern "C" int inv3x3_wy_f64(const void* V, const void* W, const void* Wpf,
                             void* Vinv, void* Y, int64_t P, int64_t N,
                             int64_t K, void* stream) {
  return launch<double>(V, W, Wpf, Vinv, Y, P, N, K, stream);
}

// Block-COO -> dense scatter-add for Hopper (sm_90a).
//
// Replaces the TPU kernel linearsfm_tpu/ops/pallas_kernels.py:
// blockcoo_to_dense (body _coo_dense_kernel). It builds the dense
// [R*M, C*N] matrices of the Schur assembly (A, Wd, Yd in ops/schur.py) from
// block-COO lists: entry k adds the R x C block vals[k] at block
// (rows[k], cols[k]); duplicate coordinates add up. float32 is the main path
// (the Schur preconditioner); float64 serves the plain-Cholesky levels, which
// the TPU kernel could not (Mosaic has no 64-bit vectors).
//
// What bounds it: the bytes of the output. The dense matrix (up to
// 12288 x 12288 f32 at the 2,048-map root) is far larger than the entry list
// (K*R*C floats), so the work is one memset of the output at full bandwidth
// (torch.zeros in the wrapper) plus a write of the nonzero blocks only.
//
// Design: the wrapper stable-sorts the entries by (lane-folded) block row and
// passes CSR row offsets and the sort permutation. One warp owns one block row
// and walks that row's entries in list order; lane t owns element t of the
// R x C block (t < R*C <= 64). Every output element is therefore summed by
// one thread in list order: deterministic, no atomics, and the same order as
// a sequential scatter-add. The TPU design (8-sublane padding, 128-lane
// windows, stripe/chunk grid) answered Mosaic layout rules and is not
// carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;

template <typename T>
__global__ void blockcoo_dense_kernel(const int64_t* __restrict__ row_ptr,
                                      const int64_t* __restrict__ perm,
                                      const int64_t* __restrict__ cols,
                                      const T* __restrict__ vals,
                                      T* __restrict__ out, int64_t n_brows,
                                      int R, int C, int64_t ldo) {
  const int lane = threadIdx.x & 31;
  const int64_t brow =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (brow >= n_brows) return;
  const int rc = R * C;
  const int64_t beg = row_ptr[brow];
  const int64_t end = row_ptr[brow + 1];
  T* orow = out + brow * R * ldo;
  for (int64_t e = beg; e < end; ++e) {
    const int64_t k = perm[e];
    const int64_t c0 = cols[k] * C;
    const T* v = vals + k * rc;
    for (int t = lane; t < rc; t += 32) {
      const int i = t / C;
      const int j = t - i * C;
      orow[i * ldo + c0 + j] += v[t];
    }
  }
}

template <typename T>
int launch(const void* row_ptr, const void* perm, const void* cols,
           const void* vals, void* out, int64_t n_brows, int R, int C,
           int64_t ldo, void* stream) {
  if (R <= 0 || C <= 0 || R * C > 64) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n_brows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    blockcoo_dense_kernel<T><<<static_cast<unsigned>(blocks),
                               32 * kWarpsPerBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(row_ptr), static_cast<const int64_t*>(perm),
        static_cast<const int64_t*>(cols), static_cast<const T*>(vals),
        static_cast<T*>(out), n_brows, R, C, ldo);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// row_ptr[n_brows + 1]: CSR offsets into perm; perm[nnz]: entry index of
// each sorted position; cols[K], vals[K, R, C]; out[n_brows * R, ldo],
// zeroed by the caller. Launches on `stream`; returns cudaGetLastError().
extern "C" int blockcoo_dense_f32(const void* row_ptr, const void* perm,
                                  const void* cols, const void* vals,
                                  void* out, int64_t n_brows, int R, int C,
                                  int64_t ldo, void* stream) {
  return launch<float>(row_ptr, perm, cols, vals, out, n_brows, R, C, ldo,
                       stream);
}

extern "C" int blockcoo_dense_f64(const void* row_ptr, const void* perm,
                                  const void* cols, const void* vals,
                                  void* out, int64_t n_brows, int R, int C,
                                  int64_t ldo, void* stream) {
  return launch<double>(row_ptr, perm, cols, vals, out, n_brows, R, C, ldo,
                        stream);
}

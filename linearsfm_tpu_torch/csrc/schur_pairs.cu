// Kernel K4 for Hopper (sm_90a): the float32 Schur complement of a refine
// join's preconditioner, formed from the W block list.
//
// Replaces no TPU kernel. The JAX package densifies W and Y = W Vinv[wf]
// into [6M, 3N] layouts (its Pallas blockcoo_to_dense) and multiplies them
// (linearsfm_tpu/ops/schur.py:_assemble_schur_dense); the port did the same
// with K1 and a cuBLAS GEMM. At the 3,499-map roots those layouts are
// 99.9% zeros: the dense product costs 3.7e13 flops where the nonzero 6x3
// block products cost 2.4e9 (stereo) to 7.9e9 (mono). K4 does only the
// nonzero products:
//   S[p, q] -= sum_f Y[p, f] W[q, f]^T    (6x6 blocks of S [P, 6M, 6M]),
//   E[p]    -= sum_f Y[p, f] eF[f]        (E [P, 6M]),
// over the pairs of W entries (p, f), (q, f) that share a feature, in
// place on S = A and E = eP (ops/schur._assemble_schur_dense).
//
// Order: the sum is taken in one fixed order, so that two launches give the
// same bits and the plain version (ops/kernels.schur_pairs_ref) gives the
// kernel's. Block (p, q) takes, for each entry (p, f) of block row p in
// feature order (then list order), each entry (q, f) in list order, into a
// sum that starts from zero, three fused multiply-adds (one rounding each):
//   acc[i][j] = fma(Y[i][2], W[j][2], fma(Y[i][1], W[j][1],
//                   fma(Y[i][0], W[j][0], acc[i][j]))),
// and at the end S[i][j] = A[i][j] - acc[i][j]; E[p][i] = eP[i] - the same
// sum with eF[f] for W[j]. That is how the dense product S = A - Yd Wd^T
// rounds (its dot products summed from zero, then one subtraction): on
// the mono 3,498-map cell's sets the PCG then takes the dense product's
// sweeps, where subtracting each term from S as it comes took one to six
// more a solve. The plain version computes each fused step exactly in
// float64 and rounds it once (`kernels._fma32`).
// Entries whose W block is exactly zero (padding, dropped couplings) are
// not in the plan; they would add exact zeros.
//
// The list comes as K1's plan (kernels.coo_plan): its live entries by
// (lane, pose, feature), CSR offsets per folded block row, each sorted
// position's flat entry index (perm) and feature (col).
//
// What bounds it: at the stereo root, 1.1e7 block products of 108
// multiply-adds each (2.4e9 flops, 36 us at the card's 67 TFLOP/s) against
// 0.6 GB of S blocks read and written once (0.18 ms at 3.35 TB/s): bytes.
// Next to that, latency: a pose that anchors a join (every feature of the
// other side couples to it) owns a block row of about 10,000 entries where
// the mean is 86, and its diagonal block takes that many terms in order.
//
// Design:
// * One thread owns one 6x6 block (p, q) and one warp a block row's 32
//   neighbouring blocks (p, q0..q0+31), for every lane of the level in one
//   launch: no two threads write one S element, no atomics. The block's sum
//   stays in 36 registers from its first term to its last, so a touched
//   block is read once and written once, and an untouched one not at
//   all.
// * The warp walks row p's entries in order, 32 at a time. First each
//   thread merges row q's entries (sorted by feature, like p's) against the
//   chunk's features and marks the entries it matches, with where its run
//   of (q, f) entries starts: the warp passes over entries below every
//   thread's next feature, and a thread's pointer gallops (`seek`), so that
//   the anchors' long rows cost little in either role. A chunk that no
//   thread of the warp matches is done, and so is the walk once every
//   thread's row q is used up. Else each thread stages one entry's Y (and,
//   in the warp of the diagonal block, its W; in the warp of E, eF[f]) in
//   shared memory, all at once, so the walk pays one memory latency per 32
//   entries however long the row; then each thread adds Y[p, f] W[q, f]^T
//   for its matches in order, the threads of the warp side by side, with W
//   of its next run's first entry loaded one match ahead.
// * The warp of the first 32 blocks also updates E[p] (threads 0-5, one
//   coordinate each) from the staged Y and eF.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;               // warps per CTA
constexpr unsigned kAll = 0xffffffffu;
constexpr int kNone = 0x7fffffff;       // a feature past every real one

// s + a0 b0 + a1 b1 + a2 b2: three fused multiply-adds in this order
__device__ __forceinline__ float fma3(float s, float a0, float a1, float a2,
                                      float b0, float b1, float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmaf_rn(a0, b0, s)));
}

struct Args {
  float* S;               // [P, 6M, 6M], A on entry
  float* E;               // [P, 6M], eP on entry
  const float* W;         // [P*K, 6, 3]
  const float* Y;         // [P*K, 6, 3]
  const float* eF;        // [P*N, 3]
  const int32_t* ptr;     // [P*M + 1]: each folded block row's first position
  const int32_t* perm;    // [P*K]: flat entry of each position
  const int32_t* col;     // [P*K]: its feature
  int64_t warps;          // P*M*T
  int64_t M, N, T;        // T = ceil(M / 32): warps per block row
};

// one warp's chunk of 32 entries of row p
struct Stage {
  float y[32][18];     // Y of each entry
  float w[32][18];     // W of each entry (the diagonal block's warp)
  float ef[32][3];     // eF of its feature (the warp of E)
  int f[32];           // its feature
  int at[32][32];      // [entry][thread]: where row q's run of f starts
};

// 18 floats of a [6, 3] block (72 bytes, 8-byte aligned) through the
// read-only path
__device__ __forceinline__ void load18(const float* src, float* v) {
  const float2* s2 = reinterpret_cast<const float2*>(src);
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const float2 x = __ldg(s2 + t);
    v[2 * t] = x.x;
    v[2 * t + 1] = x.y;
  }
}

// Moves row q's pointer jq (feature fq < f) to its first entry with a
// feature >= f, in steps of 1, 2, 4, ... and then by halves: a long row q
// against a short row p costs a few loads per entry of p, not its length.
__device__ __forceinline__ void seek(const int32_t* col, int jend, int f,
                                     int& jq, int& fq) {
  int lo = jq, hi = jq + 1, step = 1;
  while (hi < jend && col[hi] < f) {
    lo = hi;
    step <<= 1;
    hi = lo + step;
  }
  if (hi > jend) hi = jend;
  while (hi - lo > 1) {   // col[lo] < f; col[hi] >= f, or hi == jend
    const int mid = (lo + hi) >> 1;
    if (col[mid] < f) lo = mid; else hi = mid;
  }
  jq = hi;
  fq = hi < jend ? col[hi] : kNone;
}

// W of the first entry of this thread's run at its next match
__device__ __forceinline__ const float* run_w(const Args& a, const Stage& st,
                                              unsigned mask, int lane) {
  return a.W + static_cast<int64_t>(a.perm[st.at[__ffs(mask) - 1][lane]]) * 18;
}

// s += y w^T, elementwise in the fixed order
__device__ __forceinline__ void accumulate(float s[36], const float* y,
                                           const float v[18]) {
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int k = 0; k < 6; ++k)
      s[i * 6 + k] = fma3(s[i * 6 + k], y[i * 3], y[i * 3 + 1], y[i * 3 + 2],
                          v[k * 3], v[k * 3 + 1], v[k * 3 + 2]);
}

__global__ void __launch_bounds__(32 * kWarps)
    schur_pairs_kernel(const Args a) {
  __shared__ Stage stage[kWarps];
  const int lane = threadIdx.x & 31;
  const int64_t g =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (g >= a.warps) return;   // the whole warp
  Stage& st = stage[threadIdx.x >> 5];
  const int64_t r = g / a.T;              // folded block row l M + p
  const int64_t tile = g - r * a.T;
  const int64_t row0 = (r / a.M) * a.M;   // the lane's first folded row
  const int64_t fbase = (r / a.M) * a.N;  // and first folded feature
  const int64_t p = r - row0;
  const int64_t q = tile * 32 + lane;
  const bool diag = q == p;
  const bool diag_warp = p / 32 == tile;  // stages W for the diagonal
  const bool e_warp = tile == 0;          // updates E[p]
  const int64_t d = 6 * a.M;
  const int pend = a.ptr[r + 1];

  // this thread's block (p, q), and its walk over row q's entries
  int jq = 0, jend = 0;
  if (q < a.M) {
    jq = a.ptr[row0 + q];
    jend = a.ptr[row0 + q + 1];
  }
  int fq = jq < jend ? a.col[jq] : kNone;
  float s[36];
  bool touched = false;
  float* blk = a.S + 6 * r * d + 6 * q;   // block (p, q) of the stack
  float e = 0.f;   // the sum of E[p]'s terms (the warp of E)

  for (int base = a.ptr[r]; base < pend; base += 32) {
    const int n = pend - base < 32 ? pend - base : 32;
    const int fc = lane < n ? a.col[base + lane] : kNone;
    // merge row q's entries against the chunk: which entries match. No
    // thread's pointer goes back, so an entry whose feature is below every
    // thread's next feature matches nowhere and is passed over
    unsigned mask = 0;
    int fmin = __reduce_min_sync(kAll, fq);
    for (int j = 0;;) {
      const unsigned ge = __ballot_sync(kAll, lane >= j && lane < n &&
                                                  fc >= fmin);
      if (!ge) break;
      j = __ffs(ge) - 1;
      const int f = __shfl_sync(kAll, fc, j);
      if (fq < f) seek(a.col, jend, f, jq, fq);
      if (fq == f) {
        mask |= 1u << j;
        st.at[j][lane] = jq;
      }
      if (++j >= n) break;
      fmin = __reduce_min_sync(kAll, fq);
    }
    if (!e_warp) {
      if (!__any_sync(kAll, mask != 0)) {
        if (__reduce_min_sync(kAll, fq) == kNone) break;   // no more matches
        continue;
      }
    }
    if (lane < n) {
      const int64_t e1 = a.perm[base + lane];
      st.f[lane] = fc;
      load18(a.Y + e1 * 18, st.y[lane]);
      if (diag_warp) load18(a.W + e1 * 18, st.w[lane]);
      if (e_warp) {
        const float* ef = a.eF + (fbase + fc) * 3;
        st.ef[lane][0] = __ldg(ef);
        st.ef[lane][1] = __ldg(ef + 1);
        st.ef[lane][2] = __ldg(ef + 2);
      }
    }
    __syncwarp();
    if (e_warp && lane < 6)
      for (int j = 0; j < n; ++j)
        e = fma3(e, st.y[j][lane * 3], st.y[j][lane * 3 + 1],
                 st.y[j][lane * 3 + 2], st.ef[j][0], st.ef[j][1],
                 st.ef[j][2]);
    // this thread's matches, in order; W of the next run's first entry is
    // loaded one match ahead
    float w[18];
    if (mask && !diag) load18(run_w(a, st, mask, lane), w);
    if (mask && !touched) {
#pragma unroll
      for (int t = 0; t < 36; ++t) s[t] = 0.f;
      touched = true;
    }
    while (mask) {
      const int j = __ffs(mask) - 1;
      mask &= mask - 1;
      const int f = st.f[j];
      const float* y = st.y[j];
      int jj = st.at[j][lane];
      float v[18];
      if (diag && jj >= base && jj < base + n) {
#pragma unroll
        for (int t = 0; t < 18; ++t) v[t] = st.w[jj - base][t];
      } else if (!diag) {
#pragma unroll
        for (int t = 0; t < 18; ++t) v[t] = w[t];
      } else {
        load18(a.W + static_cast<int64_t>(a.perm[jj]) * 18, v);
      }
      if (mask && !diag) load18(run_w(a, st, mask, lane), w);
      accumulate(s, y, v);
      // the rest of the run of (q, f) entries, in list order
      while (++jj < jend && a.col[jj] == f) {
        load18(a.W + static_cast<int64_t>(a.perm[jj]) * 18, v);
        accumulate(s, y, v);
      }
    }
    __syncwarp();   // every thread is done with this stage
  }
  if (touched) {   // S = A - the block's sum
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float2* b2 = reinterpret_cast<float2*>(blk + i * d);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float2 x = b2[k];
        b2[k] = make_float2(__fsub_rn(x.x, s[i * 6 + 2 * k]),
                            __fsub_rn(x.y, s[i * 6 + 2 * k + 1]));
      }
    }
  }
  if (e_warp && lane < 6)
    a.E[6 * r + lane] = __fsub_rn(a.E[6 * r + lane], e);   // eP - its sum
}

}  // namespace

// S[P, 6M, 6M] and E[P, 6M] (float32, contiguous, S 8-byte aligned),
// updated in place; W, Y [P*K, 6, 3] (8-byte aligned) and eF [P*N, 3]
// float32, contiguous; the int32 plan as above. Launches on `stream`;
// returns cudaGetLastError() (0 on success).
extern "C" int schur_pairs_f32(void* S, void* E, const void* W, const void* Y,
                               const void* eF, const void* ptr,
                               const void* perm, const void* col, int64_t P,
                               int64_t M, int64_t N, void* stream) {
  if (P < 0 || M < 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.S = static_cast<float*>(S);
  a.E = static_cast<float*>(E);
  a.W = static_cast<const float*>(W);
  a.Y = static_cast<const float*>(Y);
  a.eF = static_cast<const float*>(eF);
  a.ptr = static_cast<const int32_t*>(ptr);
  a.perm = static_cast<const int32_t*>(perm);
  a.col = static_cast<const int32_t*>(col);
  a.M = M;
  a.N = N;
  a.T = (M + 31) / 32;
  a.warps = P * M * a.T;
  const int64_t grid = (a.warps + kWarps - 1) / kWarps;
  if (grid == 0) return static_cast<int>(cudaSuccess);
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  schur_pairs_kernel<<<static_cast<unsigned>(grid), 32 * kWarps, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

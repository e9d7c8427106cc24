// Kernel K5 for Hopper (sm_90a): the gauge transform of a stack of local
// maps and the congruence of their information, I' = J^T I J.
//
// Replaces no TPU kernel. The JAX package (linearsfm_tpu/ops/congruence.py)
// and the port's plain version (ops/congruence.transform_map_stereo_ref /
// transform_map_mono_ref) map the state, take the Jacobian blocks with one
// forward-mode jacfwd of the batched map and form the congruence as batched
// block products, segment sums and concatenations: about 1,000 (stereo) to
// 1,500 (mono) PyTorch operations a call, each a launch or a view issued by
// the host, twice a tree level. On the card those issues, not the device,
// set the pace of the small levels. K5 does the same work in six launches
// and one sort.
//
// What bounds it: bytes. A call reads the state and the block lists once
// and writes the new ones (U' and W' a little longer) once; at the 3,499-
// map roots that is about 0.1-0.2 GB, 30-60 us at 3.35 TB/s. Its flops
// (about 0.5 kflop a block) are a few microseconds at the card's float64
// rate. Next to the bytes, latency: the emission sum of a pose that anchors
// a join takes thousands of terms in a fixed order, and the small levels
// are a few microseconds of work each, so what K5 removes is the host's
// issue of a thousand operations, not device time.
//
// The launches, in order (the wrapper, ops/kernels.gauge_congruence_*):
// 1. lane: one warp per lane finds the slots of the old and new gauge poses
//    (first match, 0 if none, as types.first_true) and writes the lane's
//    gauge values: the new reference pose g, the new state q at the old
//    reference's slot r (and, mono, the scale's sign and the new state at
//    the old scale pose's slot s).
// 2. point: one thread per pose and feature slot maps the state (float64)
//    and takes its Jacobian blocks Dp/Cp/C2p and Df/Cf/C2f from one device
//    function of the state map (stereo_map_pose/_feat, mono_map_pose/_feat
//    below, the same mathematics as ops/gauge.stereo_batched and
//    mono_batched) evaluated on forward-mode dual numbers: the tangents that
//    jacfwd seeds (stereo 15, mono 18), three at a time. Mono's folds at
//    the old gauge rows and the projection of the new gauge columns follow
//    (congruence.mono_jacobians), stereo's Dinv at r (stereo_jacobians);
//    the blocks are rounded once to the information dtype T, and V' =
//    Df^T V Df is formed.
// 3. entry: one thread per U and W entry forms U_t = (Dp_i^T U) Dp_j and
//    W_t = (Dp_p^T W) Df_f in T, writes them and the index lists straight
//    into the output lists at their final offsets
//        U' = [U_t | newU_r | (newU_s) | rr | (ss, rs)],
//        W' = [W_t | newW_r | (newW_s)],
//    and writes each entry's emission keys (below).
// 4. (the wrapper) one stable torch.sort of the keys.
// 5. emit: one warp per pose or feature segment sums its emission terms
//        m[i] = sum_{ui=i} U C[uj] + sum_{uj=i, ui!=uj} U^T C[ui]
//               + sum_{wp=i} W Cf[wf]
//        q[f] = sum_{wf=f} C[wp]^T W  (+ Cf[f]^T V[f])
//    in list order, each of the three lists' sums from zero and then added
//    in that order (congruence_emit's order), and writes newU = Dp^T m,
//    symmetrised at its own gauge slot, and newW = q Df. The keys are each
//    term's (lane, segment) and the sort is stable, so every segment's
//    terms lie together in list order; a warp finds its range by binary
//    search within its lane's part of the sorted keys. The warp takes its
//    terms 32 at a time: each thread resolves one term's blocks and
//    prefetches them into L1, then the warp adds the 32 in order. A pose
//    that anchors a join has thousands of terms, one after another: the
//    NC3500 root's call takes 6.6 ms (8.3 ms without the prefetch, each
//    term waiting for its own loads).
// 6. cross: rr = C_r^T I C_r (mono also ss and rs) is sum_i C_i^T m[i] +
//    sum_f Cf_f^T q[f]^T, the same sums as congruence_emit's but over the
//    segments' emissions: each segment writes its 6x6 term, and two fixed
//    passes add them (chunks of kChunk segments in order, then the chunks
//    in order).
// No float atomics anywhere: two launches give the same bits. The order of
// the Jacobians' and the products' roundings is not the plain version's
// (jacfwd's tangent rules, matmul's sums), so the results agree with it to
// rounding, not bit for bit.
//
// Index semantics are the plain version's: a block index below 0 reads the
// slot counted from the end (PyTorch's x[-1]), a segment index outside
// [0, M) or [0, N) is dropped from the sums. A pinned coordinate outside
// 0-2 (the plain version raises) gives NaN states in its lane; so does an
// index outside [-M, M) in the blocks it touches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;        // segments per chunk of the cross sums
constexpr unsigned kAll = 0xffffffffu;

// ---------------------------------------------------------------------------
// forward-mode dual numbers over K tangents, and the scalar functions the
// state map uses, for double and Dual<K> alike
// ---------------------------------------------------------------------------

template <int K>
struct Dual {
  double v;
  double d[K];
  __device__ Dual() {}
  __device__ Dual(double x) : v(x) {
#pragma unroll
    for (int k = 0; k < K; ++k) d[k] = 0.0;
  }
};

template <int K>
__device__ __forceinline__ Dual<K> operator+(const Dual<K>& a,
                                             const Dual<K>& b) {
  Dual<K> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> operator-(const Dual<K>& a,
                                             const Dual<K>& b) {
  Dual<K> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> operator-(const Dual<K>& a) {
  Dual<K> r;
  r.v = -a.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = -a.d[k];
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> operator*(const Dual<K>& a,
                                             const Dual<K>& b) {
  Dual<K> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> operator/(const Dual<K>& a,
                                             const Dual<K>& b) {
  Dual<K> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) / b.v;
  return r;
}

__device__ __forceinline__ double val(double x) { return x; }
template <int K>
__device__ __forceinline__ double val(const Dual<K>& x) { return x.v; }

__device__ __forceinline__ double dsin(double x) { return sin(x); }
__device__ __forceinline__ double dcos(double x) { return cos(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ double datan2(double y, double x) {
  return atan2(y, x);
}

template <int K>
__device__ __forceinline__ Dual<K> dsin(const Dual<K>& a) {
  Dual<K> r;
  r.v = sin(a.v);
  const double c = cos(a.v);
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] * c;
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> dcos(const Dual<K>& a) {
  Dual<K> r;
  r.v = cos(a.v);
  const double s = -sin(a.v);
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] * s;
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> dsqrt(const Dual<K>& a) {
  Dual<K> r;
  r.v = sqrt(a.v);
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] / (2.0 * r.v);
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> datan2(const Dual<K>& y, const Dual<K>& x) {
  Dual<K> r;
  r.v = atan2(y.v, x.v);
  const double den = x.v * x.v + y.v * y.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = (x.v * y.d[k] - y.v * x.d[k]) / den;
  return r;
}

// ---------------------------------------------------------------------------
// the state maps (ops/rotations, ops/gauge), for S = double or Dual<K>
// ---------------------------------------------------------------------------

// R = Rx(gamma) Ry(beta) Rz(alpha) (rotations.euler_to_r)
template <class S>
__device__ __forceinline__ void euler_to_r(const S& al, const S& be,
                                           const S& ga, S R[3][3]) {
  const S sa = dsin(al), sb = dsin(be), sg = dsin(ga);
  const S ca = dcos(al), cb = dcos(be), cg = dcos(ga);
  R[0][0] = cb * ca;
  R[0][1] = cb * sa;
  R[0][2] = -sb;
  R[1][0] = sg * sb * ca - cg * sa;
  R[1][1] = sg * sb * sa + cg * ca;
  R[1][2] = sg * cb;
  R[2][0] = cg * sb * ca + sg * sa;
  R[2][1] = cg * sb * sa - sg * ca;
  R[2][2] = cg * cb;
}

// rotations._euler_from_entries, its singular branch included
template <class S>
__device__ __forceinline__ void euler_of(const S& r01, const S& r00,
                                         const S& r02, const S& r12,
                                         const S& r22, const S& r11,
                                         S out[3]) {
  const S cb2 = r00 * r00 + r01 * r01;
  const bool sing = val(cb2) < 1e-60;
  const S one(1.0);
  const S cb = dsqrt(sing ? one : cb2);
  const S beta = datan2(-r02, cb);
  const S alpha = datan2(r01, sing ? one : r00);
  const S gamma = datan2(r12, sing ? one : r22);
  const S gamma_s = datan2(r01, sing ? r11 : one);
  out[0] = sing ? S(0.0) : alpha;
  out[1] = sing ? S(1.5707963267948966) : beta;   // math.pi / 2
  out[2] = sing ? gamma_s : gamma;
}

// Rg (x - t) for x[3], g = (t, angles)
template <class S>
__device__ __forceinline__ void moved(const S Rg[3][3], const S* x,
                                      const S* g, S out[3]) {
  const S d0 = x[0] - g[0], d1 = x[1] - g[1], d2 = x[2] - g[2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = Rg[i][0] * d0 + Rg[i][1] * d1 + Rg[i][2] * d2;
}

// the Euler angles of Rx Rg^T
template <class S>
__device__ __forceinline__ void relative_angles(const S Rx[3][3],
                                                const S Rg[3][3], S out[3]) {
  auto P = [&](int i, int j) {
    return Rx[i][0] * Rg[j][0] + Rx[i][1] * Rg[j][1] + Rx[i][2] * Rg[j][2];
  };
  euler_of(P(0, 1), P(0, 0), P(0, 2), P(1, 2), P(2, 2), P(1, 1), out);
}

// gauge.stereo_batched at one pose: (Rg (x_t - t), euler(Rx Rg^T))
template <class S>
__device__ void stereo_map_pose(const S x[6], const S g[6], S out[6]) {
  S Rg[3][3], Rx[3][3];
  euler_to_r(g[3], g[4], g[5], Rg);
  euler_to_r(x[3], x[4], x[5], Rx);
  moved(Rg, x, g, out);
  relative_angles(Rx, Rg, out + 3);
}

// gauge.invpose: (-Rg t, euler(Rg^T))
template <class S>
__device__ void stereo_map_inv(const S g[6], S out[6]) {
  S Rg[3][3];
  euler_to_r(g[3], g[4], g[5], Rg);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = -(Rg[i][0] * g[0] + Rg[i][1] * g[1] + Rg[i][2] * g[2]);
  euler_of(Rg[1][0], Rg[0][0], Rg[2][0], Rg[2][1], Rg[2][2], Rg[1][1],
           out + 3);
}

template <class S>
__device__ void stereo_map_feat(const S y[3], const S g[6], S out[3]) {
  S Rg[3][3];
  euler_to_r(g[3], g[4], g[5], Rg);
  moved(Rg, y, g, out);
}

// gauge._scale_sign on [Rg (s - t)]_fix: (|.|, its sign, +1 at 0); the sign
// is a select and carries no tangent. A fix outside 0-2 gives NaN.
template <class S>
__device__ __forceinline__ S mono_scale(const S Rg[3][3], const S g[6],
                                        const S s[3], int fix, double* sign) {
  if (fix < 0 || fix > 2) {
    *sign = -1.0;
    return S(nan(""));
  }
  const S tsf = Rg[fix][0] * (s[0] - g[0]) + Rg[fix][1] * (s[1] - g[1])
                + Rg[fix][2] * (s[2] - g[2]);
  *sign = val(tsf) >= 0.0 ? 1.0 : -1.0;
  return tsf * S(*sign);
}

// gauge.mono_batched at one pose: (Rg (x_t - t) / scale, euler(Rx Rg^T))
template <class S>
__device__ void mono_map_pose(const S x[6], const S g[6], const S s[3],
                              int fix, S out[6]) {
  S Rg[3][3], Rx[3][3];
  euler_to_r(g[3], g[4], g[5], Rg);
  double sign;
  const S sc = mono_scale(Rg, g, s, fix, &sign);
  euler_to_r(x[3], x[4], x[5], Rx);
  moved(Rg, x, g, out);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = out[i] / sc;
  relative_angles(Rx, Rg, out + 3);
}

template <class S>
__device__ void mono_map_feat(const S y[3], const S g[6], const S s[3],
                              int fix, S out[3]) {
  S Rg[3][3];
  euler_to_r(g[3], g[4], g[5], Rg);
  double sign;
  const S sc = mono_scale(Rg, g, s, fix, &sign);
  moved(Rg, y, g, out);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = out[i] / sc;
}

// ---------------------------------------------------------------------------
// Jacobian columns by forward passes of three tangents
// ---------------------------------------------------------------------------

// The seeds of jacfwd's tangents, three at a time: group 0 the first three
// coordinates of the block itself (a pose's translation, a feature), 1 a
// pose's angles, 2 q's translation, 3 q's angles, 4 s (mono).
typedef Dual<3> D3;

template <int L>
__device__ __forceinline__ void seed(D3* x, const double* v, int group,
                                     int first) {
#pragma unroll
  for (int i = 0; i < L; ++i) {
    x[i] = D3(v[i]);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      x[i].d[k] = (group == first + i / 3 && k == i % 3) ? 1.0 : 0.0;
  }
}

// J[:, 3 group-columns] of a pose block's map at (x, q, s)
template <bool MONO>
__device__ void pose_pass(const double x[6], const double q[6],
                          const double s[3], int fix, int group,
                          double J[6][3]) {
  D3 X[6], Q[6], Sv[3], out[6];
  seed<6>(X, x, group, 0);
  seed<6>(Q, q, group, 2);
  seed<3>(Sv, s, group, 4);
  if (MONO)
    mono_map_pose(X, Q, Sv, fix, out);
  else
    stereo_map_pose(X, Q, out);
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) J[i][k] = out[i].d[k];
}

// J[:, 3 group-columns] of a feature block's map at (y, q, s)
template <bool MONO>
__device__ void feat_pass(const double y[3], const double q[6],
                          const double s[3], int fix, int group,
                          double J[3][3]) {
  D3 Y[3], Q[6], Sv[3], out[3];
  seed<3>(Y, y, group, 0);
  seed<6>(Q, q, group, 2);
  seed<3>(Sv, s, group, 4);
  if (MONO)
    mono_map_feat(Y, Q, Sv, fix, out);
  else
    stereo_map_feat(Y, Q, out);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) J[i][k] = out[i].d[k];
}

// d invpose(q) / dq, three columns (group 2 or 3)
__device__ void inv_pass(const double q[6], int group, double J[6][3]) {
  D3 Q[6], out[6];
  seed<6>(Q, q, group, 2);
  stereo_map_inv(Q, out);
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) J[i][k] = out[i].d[k];
}

// ---------------------------------------------------------------------------
// arguments
// ---------------------------------------------------------------------------

// layout mirrored by ops/kernels._GcArgs (ctypes): every field 8 bytes
struct GcArgs {
  const int64_t* pose_ids;   // [P, M]
  const double* poses;       // [P, M, 6]
  const double* feats;       // [P, N, 3]
  const void* U;             // [P, KU, 6, 6] T
  const int64_t* Uij;        // [P, KU, 2]
  const void* W;             // [P, KW, 6, 3] T
  const int64_t* Wpf;        // [P, KW, 2]
  const void* V;             // [P, N, 3, 3] T
  const int64_t* ref;        // [P] the old gauge
  const int64_t* scap;       // [P] (mono)
  const int64_t* fix;        // [P] (mono)
  const int64_t* new_ref;    // [P] the new gauge
  const int64_t* new_scap;   // [P] (mono)
  const int64_t* new_fix;    // [P] (mono)
  int64_t* ids_out;          // [P, M] (stereo)
  double* poses_out;         // [P, M, 6]
  double* feats_out;         // [P, N, 3]
  void* U_out;               // [P, KU2, 6, 6] T
  int64_t* Uij_out;          // [P, KU2, 2]
  void* W_out;               // [P, KW2, 6, 3] T
  int64_t* Wpf_out;          // [P, KW2, 2]
  void* V_out;               // [P, N, 3, 3] T
  int64_t* sign_out;         // [P] (mono)
  void* scratch;             // gc_scratch_bytes: lanes, Jacobians, cross
  int32_t* keys;             // [P, C], C = 2 KU + 2 KW
  const int32_t* skeys;      // the keys sorted (stable)
  const int64_t* perm;       // their positions
  int64_t P, M, N, KU, KW;
  int64_t mono, f32;
};

// one lane's gauge values (launch 1)
struct Lane {
  double g[6];     // the new reference pose in the old state
  double q[6];     // the new state at r
  double s6[6];    // mono: the new state at s
  double sign;     // mono: the sign of the scale's pinned coordinate
  int32_t slot;    // stereo: the new reference's slot; mono: p1
  int32_t p2;      // mono: the new scale pose's slot
  int32_t r;       // the old reference's slot in the new state
  int32_t s;       // mono: the old scale pose's slot
  int32_t fix_old, fix_new;
};

__host__ __device__ inline int64_t align256(int64_t b) {
  return (b + 255) / 256 * 256;
}

// the scratch's parts, in bytes from its start
struct Layout {
  int64_t lanes, dp, cp, c2p, df, cf, c2f, part, chunk, total;
  int64_t nC, nchunk;
};

__host__ __device__ inline Layout layout(int64_t P, int64_t M, int64_t N,
                                         bool mono, int64_t esz) {
  Layout L;
  L.nC = mono ? 3 : 1;
  L.nchunk = (M + N + kChunk - 1) / kChunk;
  int64_t at = 0;
  L.lanes = at;
  at += align256(P * static_cast<int64_t>(sizeof(Lane)));
  L.dp = at;
  at += align256(P * M * 36 * esz);
  L.cp = at;
  at += align256(P * M * 36 * esz);
  L.c2p = at;
  at += mono ? align256(P * M * 36 * esz) : 0;
  L.df = at;
  at += align256(P * N * 9 * esz);
  L.cf = at;
  at += align256(P * N * 18 * esz);
  L.c2f = at;
  at += mono ? align256(P * N * 18 * esz) : 0;
  L.part = at;
  at += align256(P * (M + N) * L.nC * 36 * esz);
  L.chunk = at;
  at += align256(P * L.nchunk * L.nC * 36 * esz);
  L.total = at;
  return L;
}

template <typename T>
struct Ptr {
  const Lane* lanes;
  T *dp, *cp, *c2p, *df, *cf, *c2f, *part, *chunk;
  __device__ Ptr(const GcArgs& a, bool mono) {
    const Layout L = layout(a.P, a.M, a.N, mono, sizeof(T));
    char* b = static_cast<char*>(a.scratch);
    lanes = reinterpret_cast<const Lane*>(b + L.lanes);
    dp = reinterpret_cast<T*>(b + L.dp);
    cp = reinterpret_cast<T*>(b + L.cp);
    c2p = reinterpret_cast<T*>(b + L.c2p);
    df = reinterpret_cast<T*>(b + L.df);
    cf = reinterpret_cast<T*>(b + L.cf);
    c2f = reinterpret_cast<T*>(b + L.c2f);
    part = reinterpret_cast<T*>(b + L.part);
    chunk = reinterpret_cast<T*>(b + L.chunk);
  }
};

// a block index as `take` reads it: negative counts from the end; -1 if
// still outside [0, n)
__device__ __forceinline__ int64_t wrap(int64_t i, int64_t n) {
  if (i < 0) i += n;
  return (i >= 0 && i < n) ? i : -1;
}

// ---------------------------------------------------------------------------
// launch 1: one warp per lane
// ---------------------------------------------------------------------------

// first slot whose id equals `id` (slot `at` read as `as`), 0 if none
__device__ int first_slot(const int64_t* ids, int64_t M, int64_t id,
                          int64_t at, int64_t as) {
  const int l = threadIdx.x & 31;
  for (int64_t i0 = 0; i0 < M; i0 += 32) {
    const int64_t i = i0 + l;
    const bool hit = i < M && (i == at ? as : ids[i]) == id;
    const unsigned m = __ballot_sync(kAll, hit);
    if (m) return static_cast<int>(i0 + __ffs(m) - 1);
  }
  return 0;
}

template <bool MONO>
__global__ void __launch_bounds__(kThreads) gc_lane_kernel(const GcArgs a) {
  const int64_t p = (static_cast<int64_t>(blockIdx.x) * kThreads
                     + threadIdx.x) / 32;
  if (p >= a.P) return;
  const int64_t M = a.M;
  const int64_t* ids = a.pose_ids + p * M;
  const double* poses = a.poses + p * M * 6;
  Lane L;
  if (!MONO) {
    L.slot = first_slot(ids, M, a.new_ref[p], -1, 0);
    // the slot of the new reference now holds the old reference's id
    L.r = first_slot(ids, M, a.ref[p], L.slot, a.ref[p]);
    L.p2 = L.s = -1;
    L.fix_old = L.fix_new = -1;
  } else {
    L.slot = first_slot(ids, M, a.new_ref[p], -1, 0);
    L.p2 = first_slot(ids, M, a.new_scap[p], -1, 0);
    L.r = first_slot(ids, M, a.ref[p], -1, 0);
    L.s = first_slot(ids, M, a.scap[p], -1, 0);
    L.fix_old = static_cast<int32_t>(a.fix[p]);
    L.fix_new = static_cast<int32_t>(a.new_fix[p]);
  }
  if ((threadIdx.x & 31) != 0) return;
  Lane* out = reinterpret_cast<Lane*>(static_cast<char*>(a.scratch)
                                      + layout(a.P, M, a.N, MONO, 8).lanes);
#pragma unroll
  for (int k = 0; k < 6; ++k) L.g[k] = poses[L.slot * 6 + k];
  if (!MONO) {
    if (L.r == L.slot)
      stereo_map_inv(L.g, L.q);
    else
      stereo_map_pose(poses + L.r * 6, L.g, L.q);
#pragma unroll
    for (int k = 0; k < 6; ++k) L.s6[k] = 0.0;
    L.sign = 1.0;
  } else {
    double Rg[3][3];
    euler_to_r(L.g[3], L.g[4], L.g[5], Rg);
    mono_scale(Rg, L.g, poses + L.p2 * 6, L.fix_new, &L.sign);
    a.sign_out[p] = L.sign > 0.0 ? 1 : -1;
    // the new state at slot i: the map, then the pins of the new gauge
    auto state = [&](int i, double x[6]) {
      mono_map_pose(poses + i * 6, L.g, poses + L.p2 * 6, L.fix_new, x);
      if (i == L.slot)
        for (int k = 0; k < 6; ++k) x[k] = 0.0;
      if (i == L.p2 && L.fix_new >= 0 && L.fix_new < 6) x[L.fix_new] = L.sign;
    };
    state(L.r, L.q);
    state(L.s, L.s6);
  }
  // the Lane layout does not depend on T: its offset is the same for both
  out[p] = L;
}

// ---------------------------------------------------------------------------
// launch 2: one thread per pose and feature slot
// ---------------------------------------------------------------------------

template <typename T, int R, int C>
__device__ __forceinline__ void store(T* dst, const double (&J)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < C; ++k) dst[i * C + k] = static_cast<T>(J[i][k]);
}

template <typename T, bool MONO>
__global__ void __launch_bounds__(kThreads) gc_point_kernel(const GcArgs a) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t M = a.M, N = a.N;
  if (t >= a.P * (M + N)) return;
  const int64_t p = t / (M + N), i = t % (M + N);
  const Ptr<T> w(a, MONO);
  const Lane& L = w.lanes[p];
  const int nf = L.fix_new;
  const double s[3] = {L.s6[0], L.s6[1], L.s6[2]};
  if (i < M) {
    const double* x0 = a.poses + (p * M + i) * 6;
    double x[6];
    if (i == L.r) {
#pragma unroll
      for (int k = 0; k < 6; ++k) x[k] = L.q[k];
    } else if (MONO && i == L.s) {
#pragma unroll
      for (int k = 0; k < 6; ++k) x[k] = L.s6[k];
    } else if (!MONO) {
      if (i == L.slot)
        stereo_map_inv(L.g, x);
      else
        stereo_map_pose(x0, L.g, x);
    } else {
      const double s_old[3] = {a.poses[(p * M + L.p2) * 6],
                               a.poses[(p * M + L.p2) * 6 + 1],
                               a.poses[(p * M + L.p2) * 6 + 2]};
      mono_map_pose(x0, L.g, s_old, nf, x);
      if (i == L.slot)
        for (int k = 0; k < 6; ++k) x[k] = 0.0;
      if (i == L.p2 && nf >= 0 && nf < 6) x[nf] = L.sign;
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) a.poses_out[(p * M + i) * 6 + k] = x[k];
    if (!MONO)
      a.ids_out[p * M + i] = i == L.slot ? a.ref[p] : a.pose_ids[p * M + i];

    T* dp = w.dp + (p * M + i) * 36;
    T* cp = w.cp + (p * M + i) * 36;
    double Dp[6][6], J[6][3];
    if (!MONO && i == L.r) {   // stereo_jacobians: Dinv at r, Cp[r] = 0
      for (int h = 0; h < 2; ++h) {
        inv_pass(L.q, 2 + h, J);
        for (int c = 0; c < 6; ++c)
          for (int k = 0; k < 3; ++k) Dp[c][3 * h + k] = J[c][k];
      }
      for (int e = 0; e < 36; ++e) cp[e] = T(0);
      store(dp, Dp);
      return;
    }
    for (int h = 0; h < 2; ++h) {
      pose_pass<MONO>(x, L.q, s, L.fix_old, h, J);
      for (int c = 0; c < 6; ++c)
        for (int k = 0; k < 3; ++k) Dp[c][3 * h + k] = J[c][k];
    }
    // Cp, folded at r and its new gauge columns projected (mono)
    for (int h = 0; h < 2; ++h) {
      pose_pass<MONO>(x, L.q, s, L.fix_old, 2 + h, J);
      for (int c = 0; c < 6; ++c)
        for (int k = 0; k < 3; ++k) {
          const int col = 3 * h + k;
          double v = J[c][k];
          if (MONO && i == L.r) {
            Dp[c][col] = Dp[c][col] + v;
            v = 0.0;
          }
          if (MONO && (L.r == L.slot || (L.r == L.p2 && col == nf))) v = 0.0;
          cp[c * 6 + col] = static_cast<T>(v);
        }
    }
    if (MONO) {
      T* c2p = w.c2p + (p * M + i) * 36;
      pose_pass<MONO>(x, L.q, s, L.fix_old, 4, J);
      for (int c = 0; c < 6; ++c) {
        for (int k = 0; k < 3; ++k) {
          double v = J[c][k];
          if (i == L.s) {
            Dp[c][k] = Dp[c][k] + v;
            v = 0.0;
          }
          if (L.s == L.slot || (L.s == L.p2 && k == nf)) v = 0.0;
          c2p[c * 6 + k] = static_cast<T>(v);
          c2p[c * 6 + 3 + k] = T(0);
        }
      }
      // the projection of the new gauge's columns
      for (int c = 0; c < 6; ++c)
        for (int k = 0; k < 6; ++k)
          if (i == L.slot || (i == L.p2 && k == nf)) Dp[c][k] = 0.0;
    }
    store(dp, Dp);
    return;
  }

  // a feature slot
  const int64_t f = i - M;
  const double* y0 = a.feats + (p * N + f) * 3;
  double y[3];
  if (MONO) {
    const double s_old[3] = {a.poses[(p * M + L.p2) * 6],
                             a.poses[(p * M + L.p2) * 6 + 1],
                             a.poses[(p * M + L.p2) * 6 + 2]};
    mono_map_feat(y0, L.g, s_old, nf, y);
  } else {
    stereo_map_feat(y0, L.g, y);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) a.feats_out[(p * N + f) * 3 + k] = y[k];
  double Df[3][3], J[3][3];
  feat_pass<MONO>(y, L.q, s, L.fix_old, 0, Df);
  T* cf = w.cf + (p * N + f) * 18;
  for (int h = 0; h < 2; ++h) {
    feat_pass<MONO>(y, L.q, s, L.fix_old, 2 + h, J);
    for (int c = 0; c < 3; ++c)
      for (int k = 0; k < 3; ++k) {
        const int col = 3 * h + k;
        const bool kill = MONO && (L.r == L.slot || (L.r == L.p2 && col == nf));
        cf[c * 6 + col] = kill ? T(0) : static_cast<T>(J[c][k]);
      }
  }
  if (MONO) {
    T* c2f = w.c2f + (p * N + f) * 18;
    feat_pass<MONO>(y, L.q, s, L.fix_old, 4, J);
    for (int c = 0; c < 3; ++c)
      for (int k = 0; k < 3; ++k) {
        const bool kill = L.s == L.slot || (L.s == L.p2 && k == nf);
        c2f[c * 6 + k] = kill ? T(0) : static_cast<T>(J[c][k]);
        c2f[c * 6 + 3 + k] = T(0);
      }
  }
  T* df = w.df + (p * N + f) * 9;
  T Dt[3][3];
  for (int c = 0; c < 3; ++c)
    for (int k = 0; k < 3; ++k) {
      Dt[c][k] = static_cast<T>(Df[c][k]);
      df[c * 3 + k] = Dt[c][k];
    }
  // V' = (Df^T V) Df
  const T* V = static_cast<const T*>(a.V) + (p * N + f) * 9;
  T* Vo = static_cast<T*>(a.V_out) + (p * N + f) * 9;
  for (int r = 0; r < 3; ++r) {
    T row[3];
    for (int d = 0; d < 3; ++d)
      row[d] = Dt[0][r] * V[d] + Dt[1][r] * V[3 + d] + Dt[2][r] * V[6 + d];
    for (int b = 0; b < 3; ++b)
      Vo[r * 3 + b] = row[0] * Dt[0][b] + row[1] * Dt[1][b] + row[2] * Dt[2][b];
  }
}

// ---------------------------------------------------------------------------
// launch 3: one thread per list entry
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void fill_nan(T* dst, int n) {
  for (int e = 0; e < n; ++e) dst[e] = static_cast<T>(nan(""));
}

template <typename T, bool MONO>
__global__ void __launch_bounds__(kThreads) gc_entry_kernel(const GcArgs a) {
  const int64_t M = a.M, N = a.N, KU = a.KU, KW = a.KW;
  const int64_t XU = MONO ? 2 * M + 3 : M + 1, XW = MONO ? 2 * N : N;
  const int64_t E = KU + KW + XU + XW;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= a.P * E) return;
  const int64_t p = t / E;
  int64_t k = t % E;
  const Ptr<T> w(a, MONO);
  const int64_t KU2 = KU + XU, KW2 = KW + XW, C = 2 * KU + 2 * KW;
  const int32_t S1 = static_cast<int32_t>(M + N + 1);
  const int32_t drop = static_cast<int32_t>(p) * S1 + S1 - 1;
  int32_t* keys = a.keys + p * C;
  if (k < KU) {
    const int64_t ui = a.Uij[(p * KU + k) * 2], uj = a.Uij[(p * KU + k) * 2 + 1];
    a.Uij_out[(p * KU2 + k) * 2] = ui;
    a.Uij_out[(p * KU2 + k) * 2 + 1] = uj;
    keys[k] = (ui >= 0 && ui < M) ? static_cast<int32_t>(p) * S1 + ui : drop;
    keys[KU + k] = (ui != uj && uj >= 0 && uj < M)
                       ? static_cast<int32_t>(p) * S1 + uj : drop;
    T* out = static_cast<T*>(a.U_out) + (p * KU2 + k) * 36;
    const int64_t wi = wrap(ui, M), wj = wrap(uj, M);
    if (wi < 0 || wj < 0) {
      fill_nan(out, 36);
      return;
    }
    const T* U = static_cast<const T*>(a.U) + (p * KU + k) * 36;
    const T* Di = w.dp + (p * M + wi) * 36;
    const T* Dj = w.dp + (p * M + wj) * 36;
    T u[36], dj[36];
#pragma unroll
    for (int e = 0; e < 36; ++e) {
      u[e] = U[e];
      dj[e] = Dj[e];
    }
    // (Di^T U) Dj, one row at a time
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      T di[6], row[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) di[c] = Di[c * 6 + r];
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        T v = di[0] * u[d];
#pragma unroll
        for (int c = 1; c < 6; ++c) v += di[c] * u[c * 6 + d];
        row[d] = v;
      }
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        T v = row[0] * dj[b];
#pragma unroll
        for (int d = 1; d < 6; ++d) v += row[d] * dj[d * 6 + b];
        out[r * 6 + b] = v;
      }
    }
    return;
  }
  k -= KU;
  if (k < KW) {
    const int64_t wp = a.Wpf[(p * KW + k) * 2], wf = a.Wpf[(p * KW + k) * 2 + 1];
    a.Wpf_out[(p * KW2 + k) * 2] = wp;
    a.Wpf_out[(p * KW2 + k) * 2 + 1] = wf;
    keys[2 * KU + k] =
        (wp >= 0 && wp < M) ? static_cast<int32_t>(p) * S1 + wp : drop;
    keys[2 * KU + KW + k] =
        (wf >= 0 && wf < N) ? static_cast<int32_t>(p) * S1 + M + wf : drop;
    T* out = static_cast<T*>(a.W_out) + (p * KW2 + k) * 18;
    const int64_t wi = wrap(wp, M), wj = wrap(wf, N);
    if (wi < 0 || wj < 0) {
      fill_nan(out, 18);
      return;
    }
    const T* Wk = static_cast<const T*>(a.W) + (p * KW + k) * 18;
    const T* Di = w.dp + (p * M + wi) * 36;
    const T* Dj = w.df + (p * N + wj) * 9;
    T v18[18], dj[9];
#pragma unroll
    for (int e = 0; e < 18; ++e) v18[e] = Wk[e];
#pragma unroll
    for (int e = 0; e < 9; ++e) dj[e] = Dj[e];
    // (Dp^T W) Df
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      T di[6], row[3];
#pragma unroll
      for (int c = 0; c < 6; ++c) di[c] = Di[c * 6 + r];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        T v = di[0] * v18[d];
#pragma unroll
        for (int c = 1; c < 6; ++c) v += di[c] * v18[c * 3 + d];
        row[d] = v;
      }
#pragma unroll
      for (int b = 0; b < 3; ++b)
        out[r * 3 + b] = row[0] * dj[b] + row[1] * dj[3 + b] + row[2] * dj[6 + b];
    }
    return;
  }
  k -= KW;
  const Lane& L = w.lanes[p];
  if (k < XU) {   // the appended U entries' (i, j)
    int64_t i, j;
    if (k < M) {
      i = k, j = L.r;
    } else if (MONO && k < 2 * M) {
      i = k - M, j = L.s;
    } else {
      const int64_t x = k - (MONO ? 2 * M : M);   // rr, ss, rs
      i = x == 1 ? L.s : L.r;
      j = x == 0 ? L.r : L.s;
    }
    a.Uij_out[(p * KU2 + KU + k) * 2] = i;
    a.Uij_out[(p * KU2 + KU + k) * 2 + 1] = j;
    return;
  }
  k -= XU;   // the appended W entries' (p, f)
  a.Wpf_out[(p * KW2 + KW + k) * 2] = k < N ? L.r : L.s;
  a.Wpf_out[(p * KW2 + KW + k) * 2 + 1] = k < N ? k : k - N;
}

// ---------------------------------------------------------------------------
// launch 5: one warp per pose or feature segment
// ---------------------------------------------------------------------------

// the L1 lines of [p, p + bytes) fetched ahead (no-op on the host)
__device__ __forceinline__ void prefetch_l1(const void* p, int bytes) {
#ifdef __CUDA_ARCH__
  const char* c = static_cast<const char*>(p);
  for (int o = 0; o < bytes; o += 128)
    asm volatile("prefetch.global.L1 [%0];" ::"l"(c + o));
  asm volatile("prefetch.global.L1 [%0];" ::"l"(c + bytes - 1));
#endif
}

// first position in [lo, hi) whose key is >= key
__device__ __forceinline__ int64_t lower_bound(const int32_t* k, int64_t lo,
                                               int64_t hi, int32_t key) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (k[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <typename T, bool MONO>
__global__ void __launch_bounds__(kThreads) gc_emit_kernel(const GcArgs a) {
  constexpr int NE = MONO ? 2 : 1;    // emissions: r (and s)
  __shared__ T xs[kWarps][NE][36];
  const int64_t M = a.M, N = a.N, KU = a.KU, KW = a.KW;
  const int64_t wid = (static_cast<int64_t>(blockIdx.x) * kThreads
                       + threadIdx.x) / 32;
  if (wid >= a.P * (M + N)) return;   // whole warps
  const int l = threadIdx.x & 31;
  T (*x)[36] = xs[(threadIdx.x / 32)];
  const Ptr<T> w(a, MONO);
  const int64_t p = wid / (M + N), sg = wid % (M + N);
  const bool pose = sg < M;
  const Lane& L = w.lanes[p];
  const T* Cp[2] = {w.cp, w.c2p};
  const T* Cf[2] = {w.cf, w.c2f};
  const T* U = static_cast<const T*>(a.U) + p * KU * 36;
  const T* W = static_cast<const T*>(a.W) + p * KW * 18;
  const int64_t C = 2 * KU + 2 * KW;
  const int32_t S1 = static_cast<int32_t>(M + N + 1);
  const int32_t key = static_cast<int32_t>(p) * S1 + static_cast<int32_t>(sg);
  const int64_t lo = lower_bound(a.skeys, p * C, (p + 1) * C, key);
  const int64_t hi = lower_bound(a.skeys, lo, (p + 1) * C, key + 1);

  // this thread's elements: a pose segment's 6x6 at (ra, cb), (ra, cb + 1);
  // a feature segment's 6x3 at (ra, cb)
  const bool on = l < 18;
  const int ra = l / 3;
  const int cb = pose ? 2 * (l % 3) : l % 3;
  T tot[NE][2], acc[NE][2];
#pragma unroll
  for (int e = 0; e < NE; ++e)
#pragma unroll
    for (int q = 0; q < 2; ++q) tot[e][q] = acc[e][q] = T(0);
  int cur = -1;
  for (int64_t b0 = lo; b0 < hi; b0 += 32) {
    // each thread resolves one term of the batch: its list, entry and the
    // Jacobian block it reads
    int part = 0, kk = 0, jj = 0;
    if (b0 + l < hi) {
      int64_t c = a.perm[b0 + l] - p * C;
      if (c < KU) {
        part = 0, kk = static_cast<int>(c);
        jj = static_cast<int>(wrap(a.Uij[(p * KU + c) * 2 + 1], M));
      } else if (c < 2 * KU) {
        c -= KU;
        part = 1, kk = static_cast<int>(c);
        jj = static_cast<int>(wrap(a.Uij[(p * KU + c) * 2], M));
      } else if (c < 2 * KU + KW) {
        c -= 2 * KU;
        part = 2, kk = static_cast<int>(c);
        jj = static_cast<int>(wrap(a.Wpf[(p * KW + c) * 2 + 1], N));
      } else {
        c -= 2 * KU + KW;
        part = 3, kk = static_cast<int>(c);
        jj = static_cast<int>(wrap(a.Wpf[(p * KW + c) * 2], M));
      }
      // the term's blocks into L1 now, all 32 terms' loads in flight at
      // once: the warp then adds them one after another from L1
      if (jj >= 0) {
        const bool u = part < 2, jp = part != 2;
        prefetch_l1(u ? static_cast<const void*>(U + kk * 36)
                      : static_cast<const void*>(W + kk * 18),
                    (u ? 36 : 18) * static_cast<int>(sizeof(T)));
#pragma unroll
        for (int e = 0; e < NE; ++e)
          prefetch_l1(jp ? static_cast<const void*>(Cp[e] + (p * M + jj) * 36)
                         : static_cast<const void*>(Cf[e] + (p * N + jj) * 18),
                      (jp ? 36 : 18) * static_cast<int>(sizeof(T)));
      }
    }
    const int n = static_cast<int>(hi - b0 < 32 ? hi - b0 : 32);
    for (int t = 0; t < n; ++t) {
      const int pt = __shfl_sync(kAll, part, t);
      const int64_t kt = __shfl_sync(kAll, kk, t);
      const int64_t jt = __shfl_sync(kAll, jj, t);
      if (pt != cur) {   // the next list's sum starts from zero
#pragma unroll
        for (int e = 0; e < NE; ++e)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            tot[e][q] += acc[e][q];
            acc[e][q] = T(0);
          }
        cur = pt;
      }
      if (!on) continue;
      if (jt < 0) {
#pragma unroll
        for (int e = 0; e < NE; ++e) acc[e][0] = acc[e][1] = T(nan(""));
        continue;
      }
      if (pt == 0 || pt == 1) {   // U C[uj] at ui, U^T C[ui] at uj
        const T* blk = U + kt * 36;
        T ur[6];
#pragma unroll
        for (int c = 0; c < 6; ++c)
          ur[c] = pt == 0 ? blk[ra * 6 + c] : blk[c * 6 + ra];
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const T* cj = Cp[e] + (p * M + jt) * 36;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            T v = ur[0] * cj[cb + q];
#pragma unroll
            for (int c = 1; c < 6; ++c) v += ur[c] * cj[c * 6 + cb + q];
            acc[e][q] += v;
          }
        }
      } else if (pt == 2) {       // W Cf[wf] at wp
        const T* blk = W + kt * 18;
        const T w0 = blk[ra * 3], w1 = blk[ra * 3 + 1], w2 = blk[ra * 3 + 2];
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const T* cj = Cf[e] + (p * N + jt) * 18;
#pragma unroll
          for (int q = 0; q < 2; ++q)
            acc[e][q] += w0 * cj[cb + q] + w1 * cj[6 + cb + q]
                         + w2 * cj[12 + cb + q];
        }
      } else {                    // C[wp]^T W at wf
        const T* blk = W + kt * 18;
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const T* cj = Cp[e] + (p * M + jt) * 36;
          T v = cj[ra] * blk[cb];
#pragma unroll
          for (int c = 1; c < 6; ++c) v += cj[c * 6 + ra] * blk[c * 3 + cb];
          acc[e][0] += v;
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < NE; ++e)
#pragma unroll
    for (int q = 0; q < 2; ++q) tot[e][q] += acc[e][q];

  const int64_t nC = MONO ? 3 : 1;
  T* part = w.part + (p * (M + N) + sg) * nC * 36;
  if (pose) {
    // m[e] into shared memory
    if (on)
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        x[e][ra * 6 + cb] = tot[e][0];
        x[e][ra * 6 + cb + 1] = tot[e][1];
      }
    __syncwarp();
    const T* dp = w.dp + (p * M + sg) * 36;
    T nu[NE][2];
    if (on) {
#pragma unroll
      for (int e = 0; e < NE; ++e)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int b = cb + q;
          T v = dp[ra] * x[e][b];
#pragma unroll
          for (int c = 1; c < 6; ++c) v += dp[c * 6 + ra] * x[e][c * 6 + b];
          nu[e][q] = v;
        }
      // the cross terms C_i^T m[i]: rr (C_r, m_r), ss (C_s, m_s), rs (C_r,
      // m_s)
      const T* cr = w.cp + (p * M + sg) * 36;
      const T* cs = w.c2p + (p * M + sg) * 36;
#pragma unroll
      for (int o = 0; o < (MONO ? 3 : 1); ++o) {
        const T* ca = o == 1 ? cs : cr;
        const int e = o == 0 ? 0 : 1;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int b = cb + q;
          T v = ca[ra] * x[e][b];
#pragma unroll
          for (int c = 1; c < 6; ++c) v += ca[c * 6 + ra] * x[e][c * 6 + b];
          part[o * 36 + ra * 6 + b] = v;
        }
      }
    }
    __syncwarp();
    if (on)
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        x[e][ra * 6 + cb] = nu[e][0];
        x[e][ra * 6 + cb + 1] = nu[e][1];
      }
    __syncwarp();
    if (on) {
      const int64_t KU2 = KU + (MONO ? 2 * M + 3 : M + 1);
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        // the (slot, slot) emission: newU + newU^T
        const bool sym = sg == (e == 0 ? L.r : L.s);
        T* out = static_cast<T*>(a.U_out) + (p * KU2 + KU + e * M + sg) * 36;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int b = cb + q;
          T v = nu[e][q];
          if (sym) v = v + x[e][b * 6 + ra];
          out[ra * 6 + b] = v;
        }
      }
    }
    return;
  }

  // a feature segment: q = sum + Cf^T V, then newW = q Df
  const int64_t f = sg - M;
  const T* V = static_cast<const T*>(a.V) + (p * N + f) * 9;
  if (on)
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const T* cf = Cf[e] + (p * N + f) * 18;
      const T cv = cf[ra] * V[cb] + cf[6 + ra] * V[3 + cb]
                   + cf[12 + ra] * V[6 + cb];
      x[e][ra * 3 + cb] = tot[e][0] + cv;
    }
  __syncwarp();
  if (!on) return;
  const T* df = w.df + (p * N + f) * 9;
  const int64_t KW2 = KW + (MONO ? 2 * N : N);
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    T* out = static_cast<T*>(a.W_out) + (p * KW2 + KW + e * N + f) * 18;
    out[ra * 3 + cb] = x[e][ra * 3] * df[cb] + x[e][ra * 3 + 1] * df[3 + cb]
                       + x[e][ra * 3 + 2] * df[6 + cb];
  }
  // the cross terms Cf^T q^T, at (ra, 2 (l % 3) + q) of the 6x6
  const T* cr = w.cf + (p * N + f) * 18;
  const T* cs = w.c2f + (p * N + f) * 18;
#pragma unroll
  for (int o = 0; o < (MONO ? 3 : 1); ++o) {
    const T* ca = o == 1 ? cs : cr;
    const int e = o == 0 ? 0 : 1;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int b = 2 * (l % 3) + q;
      part[o * 36 + ra * 6 + b] = ca[ra] * x[e][b * 3] + ca[6 + ra] * x[e][b * 3 + 1]
                                  + ca[12 + ra] * x[e][b * 3 + 2];
    }
  }
}

// ---------------------------------------------------------------------------
// launch 6: the cross sums, two fixed passes
// ---------------------------------------------------------------------------

// block (p, chunk): thread e sums element e of the chunk's segments in order
template <typename T, bool MONO>
__global__ void gc_cross_chunk_kernel(const GcArgs a) {
  const Ptr<T> w(a, MONO);
  const int64_t nC = MONO ? 3 : 1, nseg = a.M + a.N;
  const int64_t nchunk = (nseg + kChunk - 1) / kChunk;
  const int64_t p = blockIdx.x / nchunk, ch = blockIdx.x % nchunk;
  const int e = threadIdx.x;
  const int64_t s1 = nseg < (ch + 1) * kChunk ? nseg : (ch + 1) * kChunk;
  T acc = T(0);
  for (int64_t s = ch * kChunk; s < s1; ++s)
    acc += w.part[(p * nseg + s) * nC * 36 + e];
  w.chunk[(p * nchunk + ch) * nC * 36 + e] = acc;
}

// block p: thread e sums the chunks in order into rr (ss, rs) of U'
template <typename T, bool MONO>
__global__ void gc_cross_total_kernel(const GcArgs a) {
  const Ptr<T> w(a, MONO);
  const int64_t nC = MONO ? 3 : 1, M = a.M, nseg = a.M + a.N;
  const int64_t nchunk = (nseg + kChunk - 1) / kChunk;
  const int64_t p = blockIdx.x;
  const int e = threadIdx.x;
  T acc = T(0);
  for (int64_t ch = 0; ch < nchunk; ++ch)
    acc += w.chunk[(p * nchunk + ch) * nC * 36 + e];
  const int64_t KU2 = a.KU + (MONO ? 2 * M + 3 : M + 1);
  const int64_t row = a.KU + (MONO ? 2 * M : M) + e / 36;
  static_cast<T*>(a.U_out)[(p * KU2 + row) * 36 + e % 36] = acc;
}

inline unsigned blocks(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

template <typename T, bool MONO>
int launch_a(const GcArgs& a, cudaStream_t st) {
  const int64_t M = a.M, N = a.N;
  const int64_t XU = MONO ? 2 * M + 3 : M + 1, XW = MONO ? 2 * N : N;
  gc_lane_kernel<MONO><<<blocks(a.P * 32), kThreads, 0, st>>>(a);
  if (a.P * (M + N) > 0)
    gc_point_kernel<T, MONO><<<blocks(a.P * (M + N)), kThreads, 0, st>>>(a);
  gc_entry_kernel<T, MONO>
      <<<blocks(a.P * (a.KU + a.KW + XU + XW)), kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool MONO>
int launch_b(const GcArgs& a, cudaStream_t st) {
  const int64_t nseg = a.M + a.N;
  const int nC = MONO ? 3 : 1;
  if (a.P * nseg > 0) {
    gc_emit_kernel<T, MONO><<<blocks(a.P * nseg * 32), kThreads, 0, st>>>(a);
    const int64_t nchunk = (nseg + kChunk - 1) / kChunk;
    gc_cross_chunk_kernel<T, MONO>
        <<<static_cast<unsigned>(a.P * nchunk), 36 * nC, 0, st>>>(a);
  }
  gc_cross_total_kernel<T, MONO>
      <<<static_cast<unsigned>(a.P), 36 * nC, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the sizes the kernels index with int32 keys and launch grids
bool valid(const GcArgs* a) {
  if (a->P <= 0 || a->M <= 0 || a->N < 0 || a->KU < 0 || a->KW < 0)
    return false;
  const int64_t C = 2 * a->KU + 2 * a->KW;
  return a->P * (a->M + a->N + 1) < (int64_t{1} << 31)
         && a->P * C < (int64_t{1} << 31) && a->KU < (int64_t{1} << 31)
         && a->KW < (int64_t{1} << 31)
         && a->P * (a->KU + a->KW + 2 * a->M + 2 * a->N + 3) * 32
                < (int64_t{1} << 40);
}

}  // namespace

// The scratch (bytes) a call with these sizes needs; -1 if they are out of
// the kernels' range.
extern "C" int64_t gauge_congruence_scratch(const void* args) {
  const GcArgs* a = static_cast<const GcArgs*>(args);
  if (!valid(a)) return -1;
  return layout(a->P, a->M, a->N, a->mono != 0, a->f32 ? 4 : 8).total;
}

// Launches 1-3 on `stream` (the keys are then sorted by the caller);
// returns cudaGetLastError() (0 on success).
extern "C" int gauge_congruence_a(const void* args, void* stream) {
  const GcArgs* a = static_cast<const GcArgs*>(args);
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->f32)
    return a->mono ? launch_a<float, true>(*a, st)
                   : launch_a<float, false>(*a, st);
  return a->mono ? launch_a<double, true>(*a, st)
                 : launch_a<double, false>(*a, st);
}

// Launches 5-6 on `stream`, after the sort (skeys, perm set).
extern "C" int gauge_congruence_b(const void* args, void* stream) {
  const GcArgs* a = static_cast<const GcArgs*>(args);
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->f32)
    return a->mono ? launch_b<float, true>(*a, st)
                   : launch_b<float, false>(*a, st);
  return a->mono ? launch_b<double, true>(*a, st)
                 : launch_b<double, false>(*a, st);
}

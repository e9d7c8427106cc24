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
// What bounds it: two terms, and a launch takes at least the larger.
// * Bytes. Each kept entry is read once (its T values and its 4-byte
//   position in perm), the offsets once, each output element written once
//   (and read once in the accumulate-into form): one add per value read, far
//   below the card's operations per byte. Least time: those bytes
//   (ops/kernels.seg_sum_bytes) over 3.35 TB/s.
// * The chain. The fixed order makes each output element one dependent
//   chain of adds, however the loads are arranged: the longest segment
//   times the card's dependent add latency (add_chain_*, below, measures
//   it: about 4 ns in float64, 2 ns in float32 on the H100). The lists'
//   zero padding all sums into segment 0, so one segment can hold tens of
//   thousands of entries (20,698 at the 2,048-map mono root's W list,
//   260,288 in the host executor's grouped Schur subtraction at 512 maps),
//   and its values all pass through the one SM that adds them.
//
// Design: two kernels per call, on one stream.
// * Kernel A (seg_sum_direct), one CTA of 256 threads per row block of R =
//   256 / T consecutive output rows of one lane, thread (i, t) owning
//   column t of row i (rows ordered by blockIdx). A block whose rows all
//   hold at most kDirectMax entries is summed there: each thread loads its
//   entries 8 at a time and adds them in order, with no shared memory and
//   few registers, so short rows keep the card full. A block with a longer
//   row is flagged in device memory (no host sync, no host-side list) and
//   left whole to kernel B.
// * Kernel B (seg_sum_ring), one CTA per SM taking the flagged blocks in
//   turn (launched as a programmatic dependent of A, so its launch overlaps
//   A's end): 256 fold threads mapped as in A and kLoaders loader warps. The
//   block's sorted positions stream through a ring of kStages
//   shared-memory stages (kStageBytes of values each, and their perm
//   positions); loader warps fill stages with bulk (TMA) copies of whole
//   value rows, or cp.async, and each stage's `full` mbarrier completes as
//   the copies land; the fold threads add each arrived stage in list order
//   from shared memory and signal its `empty` mbarrier. No CTA-wide
//   barrier per chunk, so the chain of adds waits only for data, while up
//   to kStages chunks are in flight ahead of it.
// What is left: one SM gathers a long segment's scattered rows at some
// 17-28 GB/s (its loads in flight bound it), and the fold from shared
// memory runs at about 6 ns per float64 add where the chain needs 4, so
// the longest launches take about 3 times their chain floor (PERF.md).
// Each element is written once, by its one thread, so no zero fill, no
// atomics on values and no second pass; an empty segment writes its base
// (or zero). Base and out may be the same tensor (the accumulate-into form
// updates in place: each element is read and written by its one thread).
// Ring depth and stage size: 6 x 32 KB plus the positions, one CTA per SM
// (kernel B runs few CTAs, so its shared memory costs kernel A nothing);
// chosen on the card among 4-8 stages of 16-32 KB (_archive/k3_ab.py).
// Tails of more than 256 elements are refused (the port's largest is 36).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // kernel A's CTA; kernel B's fold threads
constexpr int kLoaders = 4;           // kernel B's loader warps
// the ring: kStages stages of kStageBytes of values, and as many stages of
// their perm positions, in dynamic shared memory
constexpr int kStages = 6;
constexpr int kStageBytes = 32768;
constexpr int kMaxChunk = 1024;       // entries per stage, at most
constexpr int kDirectMax = 64;        // a row of more entries goes to the ring
static_assert(kStages >= 2, "a ring of at least two stages");
static_assert(kStageBytes % 16 == 0 && kStageBytes / 8 >= kThreads,
              "a stage holds at least 256 doubles");

// entries per stage for a tail and an element size
__host__ __device__ constexpr int chunk_of(int tail, int esz) {
  return kStageBytes / esz / tail < kMaxChunk ? kStageBytes / esz / tail
                                              : kMaxChunk;
}

// the ring's bytes: 2 kStages mbarriers (full, empty), the value stages,
// the perm stages (kStages <= 8 keeps it under the 227 KB a CTA may use)
__host__ __device__ constexpr int ring_bytes(int tail, int esz) {
  return 16 * kStages + kStages * kStageBytes
         + kStages * chunk_of(tail, esz) * 4;
}

__device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ double add(double x, double y) { return __dadd_rn(x, y); }
__device__ __forceinline__ double sub(double x, double y) { return __dsub_rn(x, y); }

template <typename T>
__device__ __forceinline__ void copy_async(T* smem, const T* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(sizeof(T))
               : "memory");
}

// waits until this thread's cp.async copies have landed
__device__ __forceinline__ void wait_all_async() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// arrives on bar when this thread's cp.async copies so far have landed
__device__ __forceinline__ void mbar_arrive_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// whether bar has completed the phase of this parity
__device__ __forceinline__ bool mbar_done(uint64_t* bar, unsigned parity) {
  unsigned done;
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

// waits until bar completes the phase of this parity; a wait of more than
// about ten seconds can only be a fault, and traps (the launch then fails)
// instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const long long t0 = clock64();
  while (!mbar_done(bar, parity))
    if (clock64() - t0 > 20000000000LL) __trap();
}

// adds bytes to the transaction count that bar's current phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes)
               : "memory");
}

// one bulk (TMA) copy of bytes (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, counted on bar's transactions
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <typename T, bool kNegate>
__device__ __forceinline__ T fold(T acc, T v) {
  return kNegate ? sub(acc, v) : add(acc, v);
}

// acc (+|-)= v[0], v[tail], ..., v[(n - 1) tail], in that order, from
// shared memory: each batch of 8 loads is issued before the adds of the
// batch before it, so the chain of adds does not wait on the loads
template <typename T, bool kNegate>
__device__ __forceinline__ T fold_run(T acc, const T* v, int n, int tail) {
  int j = 0;
  if (n >= 8) {
    T w[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) w[u] = v[u * tail];
    for (j = 8; j + 8 <= n; j += 8) {
      T x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = v[(j + u) * tail];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc = fold<T, kNegate>(acc, w[u]);
#pragma unroll
      for (int u = 0; u < 8; ++u) w[u] = x[u];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = fold<T, kNegate>(acc, w[u]);
  }
  for (; j < n; ++j) acc = fold<T, kNegate>(acc, v[j * tail]);
  return acc;
}

// The rows of row block `block`: R = 256 / tail consecutive output rows of
// one lane; thread (i, t) owns column t of row i, if there is one.
struct Rows {
  int per_cta, i, t;
  bool folds;
  int64_t r0, r1, g0, elem;
};

__device__ __forceinline__ Rows rows_of(int64_t block, int64_t num, int tail,
                                        int64_t blocks_per_lane) {
  Rows w;
  w.per_cta = kThreads / tail;
  const int64_t lane = block / blocks_per_lane;
  w.r0 = (block - lane * blocks_per_lane) * w.per_cta;
  w.r1 = min(w.r0 + w.per_cta, num);
  w.g0 = lane * (num + 1) + w.r0;            // the block's first segment
  w.i = threadIdx.x / tail;
  w.t = threadIdx.x - w.i * tail;
  w.folds = w.i < w.per_cta && w.r0 + w.i < w.r1;
  w.elem = (lane * num + w.r0 + w.i) * tail + w.t;
  return w;
}

// Kernel A, one CTA per row block. A block whose rows all hold at most
// kDirectMax entries is summed here: each thread loads its row's entries
// 8 at a time (their positions, then their values), the last few one by
// one, and adds them in order.
// A block with a longer row is left whole to kernel B: flags[block] says
// which (every block writes its flag, so the flags need no clearing).
template <typename T, bool kNegate>
__global__ void __launch_bounds__(kThreads)
seg_sum_direct(const int32_t* __restrict__ off,
               const int32_t* __restrict__ perm, const T* __restrict__ vals,
               const T* base, T* out, int64_t num, int tail,
               int64_t blocks_per_lane, int8_t* flags) {
  // kernel B may launch now; it waits for this grid before reading flags
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const Rows w = rows_of(blockIdx.x, num, tail, blocks_per_lane);
  int64_t lo = 0, hi = 0;
  if (w.folds) {
    lo = __ldg(off + w.g0 + w.i);
    hi = __ldg(off + w.g0 + w.i + 1);
  }
  const bool ring = __syncthreads_or(w.folds && hi - lo > kDirectMax);
  if (threadIdx.x == 0) flags[blockIdx.x] = ring;
  if (ring || !w.folds) return;
  T acc = base != nullptr ? base[w.elem] : T(0);
  int64_t j = lo;
  for (; j + 8 <= hi; j += 8) {
    T v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = __ldg(vals + static_cast<int64_t>(__ldg(perm + j + u)) * tail
                   + w.t);
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = fold<T, kNegate>(acc, v[u]);
  }
  for (; j < hi; ++j)
    acc = fold<T, kNegate>(
        acc, __ldg(vals + static_cast<int64_t>(__ldg(perm + j)) * tail + w.t));
  out[w.elem] = acc;
}

// Kernel B, one CTA per SM, each taking the flagged row blocks in turn,
// warp-specialized: 256 fold threads (thread (i, t) folds column t of row
// i, as in kernel A) and kLoaders loader warps. A block's rows hold one
// contiguous range of sorted positions [pos_lo, pos_hi) (no drop segment
// inside it), streamed through a ring of kStages stages in chunks of C =
// chunk_of(tail, esz) entries; chunks are numbered across the CTA's blocks
// and chunk c goes to stage c % kStages. Loader warp c % kLoaders copies
// chunk c: it waits until the stage is empty (the fold of chunk c -
// kStages done), loads the chunk's perm positions into the stage, then
// copies the values, one bulk (TMA) copy per value row where rows are
// whole 16-byte units (row_bytes > 0), else with cp.async element by
// element (neighbouring lanes copy neighbouring elements); the stage's
// `full` mbarrier completes when every copy has landed. The fold threads
// wait for chunk c to be full, fold it in list order from shared memory,
// and arrive on its `empty` mbarrier, one lane per warp. No CTA-wide
// barrier per chunk: the chain of adds waits only for data, and up to
// kStages chunks are in flight ahead of it.
template <typename T, bool kNegate>
__global__ void __launch_bounds__(kThreads + 32 * kLoaders)
seg_sum_ring(const int32_t* __restrict__ off,
             const int32_t* __restrict__ perm, const T* __restrict__ vals,
             const T* base, T* out, int64_t num, int tail,
             int64_t blocks_per_lane, const int8_t* flags, int64_t blocks,
             int row_bytes) {
  constexpr int kElems = kStageBytes / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* const empty = full + kStages;
  T* const vring = reinterpret_cast<T*>(smem + 16 * kStages);
  int32_t* const pring = reinterpret_cast<int32_t*>(
      smem + 16 * kStages + kStages * kStageBytes);
  __shared__ int64_t found[kThreads];   // flagged blocks of one scan
  __shared__ int n_found;
  const int chunk = chunk_of(tail, static_cast<int>(sizeof(T)));
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 32);                  // a loader warp's lanes
      mbar_init(empty + s, kThreads / 32);      // the fold warps
    }
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // kernel A's flags
  const bool loader = threadIdx.x >= kThreads;
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x - kThreads) >> 5;   // loader warp
  int64_t c0 = 0;                   // the CTA's chunks before this block
  // this CTA's blocks: gridDim.x apart; each scan looks at 256 of them
  for (int64_t s0 = blockIdx.x; s0 < blocks;
       s0 += static_cast<int64_t>(gridDim.x) * kThreads) {
    if (threadIdx.x == 0) n_found = 0;
    __syncthreads();
    const int64_t mine = s0 + static_cast<int64_t>(threadIdx.x) * gridDim.x;
    if (threadIdx.x < kThreads && mine < blocks && flags[mine])
      found[atomicAdd(&n_found, 1)] = mine;
    __syncthreads();
    const int n_blocks = n_found;
    for (int k = 0; k < n_blocks; ++k) {
      const Rows w = rows_of(found[k], num, tail, blocks_per_lane);
      const int64_t pos_lo = __ldg(off + w.g0);
      const int64_t pos_hi = __ldg(off + w.g0 + (w.r1 - w.r0));
      const int64_t n_chunks = (pos_hi - pos_lo + chunk - 1) / chunk;
      if (loader) {
        // (q, t) of this lane's first element and its step of 32 elements
        const int dq = 32 / tail, dt = 32 % tail;
        for (int64_t c = (warp - c0 % kLoaders + kLoaders) % kLoaders;
             c < n_chunks; c += kLoaders) {
          const int64_t g = c0 + c;
          const int s = static_cast<int>(g % kStages);
          if (g >= kStages) mbar_wait(empty + s, ((g / kStages) - 1) & 1);
          const int64_t b = pos_lo + c * chunk;
          const int n = static_cast<int>(min(pos_hi - b,
                                             static_cast<int64_t>(chunk)));
          int32_t* ps = pring + s * chunk;
          for (int x0 = 0; x0 < n; x0 += 256) {   // 8 loads in flight a lane
            int32_t pv[8];
  #pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int x = x0 + lane + 32 * u;
              pv[u] = x < n ? __ldg(perm + b + x) : 0;
            }
  #pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int x = x0 + lane + 32 * u;
              if (x < n) ps[x] = pv[u];
            }
          }
          __syncwarp();
          T* vs = vring + s * kElems;
          if (row_bytes) {     // a bulk copy per row
            if (lane == 0) mbar_expect_tx(full + s, n * row_bytes);
            __syncwarp();
            for (int q = lane; q < n; q += 32)
              bulk_copy(vs + q * tail, vals + static_cast<int64_t>(ps[q]) * tail,
                        row_bytes, full + s);
          } else {
            int q = lane / tail, t = lane % tail;
            for (int x0 = 0; x0 < n * tail; x0 += 256) {
              int qs[8], ts[8], src[8];
  #pragma unroll
              for (int u = 0; u < 8; ++u) {
                qs[u] = q;
                ts[u] = t;
                q += dq;
                t += dt;
                if (t >= tail) {
                  t -= tail;
                  ++q;
                }
              }
  #pragma unroll
              for (int u = 0; u < 8; ++u)      // 8 positions, then 8 copies
                src[u] = x0 + lane + 32 * u < n * tail ? ps[qs[u]] : 0;
  #pragma unroll
              for (int u = 0; u < 8; ++u) {
                const int x = x0 + lane + 32 * u;
                if (x < n * tail)
                  copy_async(vs + x,
                             vals + static_cast<int64_t>(src[u]) * tail + ts[u]);
              }
            }
          }
          if (row_bytes)
            mbar_arrive(full + s);
          else
            mbar_arrive_async(full + s);
        }
      } else {
        int64_t lo = 0, hi = 0;
        T acc = T(0);
        if (w.folds) {
          lo = __ldg(off + w.g0 + w.i);
          hi = __ldg(off + w.g0 + w.i + 1);
          if (base != nullptr) acc = base[w.elem];
        }
        for (int64_t c = 0; c < n_chunks; ++c) {
          const int64_t g = c0 + c;
          const int s = static_cast<int>(g % kStages);
          mbar_wait(full + s, (g / kStages) & 1);
          const int64_t b = pos_lo + c * chunk;
          const int64_t a = max(lo, b);
          const int n = static_cast<int>(min(hi, b + chunk) - a);
          if (w.folds && n > 0)
            acc = fold_run<T, kNegate>(
                acc, vring + s * kElems + (a - b) * tail + w.t, n, tail);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + s);
        }
        if (w.folds) out[w.elem] = acc;
      }
      c0 += n_chunks;
    }
    __syncthreads();                // `found` is read; the next scan may go
  }
  if (loader) wait_all_async();
}

template <typename T>
int launch(const void* off, const void* perm, const void* vals,
           const void* base, void* out, void* flags, int64_t rows,
           int64_t num, int64_t tail, int negate, void* stream) {
  if (rows < 0 || num < 0 || tail < 1 || tail > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  if (num == 0 || rows % num != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_cta = kThreads / tail;
  const int64_t blocks_per_lane = (num + per_cta - 1) / per_cta;
  const int64_t grid = rows / num * blocks_per_lane;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* o = static_cast<const int32_t*>(off);
  const auto* p = static_cast<const int32_t*>(perm);
  const auto* v = static_cast<const T*>(vals);
  const auto* b = static_cast<const T*>(base);
  auto* y = static_cast<T*>(out);
  auto* fl = static_cast<int8_t*>(flags);
  const int tl = static_cast<int>(tail);
  auto* direct = negate ? &seg_sum_direct<T, true> : &seg_sum_direct<T, false>;
  auto* ring = negate ? &seg_sum_ring<T, true> : &seg_sum_ring<T, false>;
  // once per kernel and device: the largest ring (tail 1) allowed, and the
  // ring kernel's grid (one CTA per SM)
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  static int ring_grid[2][64] = {};
  int& rg = ring_grid[negate != 0][dev];
  if (rg == 0) {
    e = cudaFuncSetAttribute(ring, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ring_bytes(1, sizeof(T)));
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&rg, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  direct<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      o, p, v, b, y, num, tl, blocks_per_lane, fl);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid < rg ? grid : rg));
  cfg.blockDim = dim3(kThreads + 32 * kLoaders);
  cfg.dynamicSmemBytes = ring_bytes(tl, sizeof(T));
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int row = tl * static_cast<int>(sizeof(T));
  const bool bulk = row % 16 == 0
                    && reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  e = cudaLaunchKernelEx(&cfg, ring, o, p, v, b, y, num, tl, blocks_per_lane,
                         static_cast<const int8_t*>(fl), grid,
                         bulk ? row : 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The chain-floor probe (not a kernel of the port): one thread adds x[1] to
// x[0] n times, each add waiting for the last, and writes the sum to out[0].
// Its time over n is the card's dependent add latency in T.
template <typename T>
__global__ void add_chain_kernel(const T* __restrict__ x, T* out, int64_t n) {
  T acc = x[0];
  const T y = x[1];
  for (int64_t j = 0; j < n; j += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = add(acc, y);
  }
  out[0] = acc;
}

template <typename T>
int chain(const void* x, void* out, int64_t n, void* stream) {
  if (n < 0 || n % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  add_chain_kernel<T><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// off int32 [P * (num + 1) + 1] and perm int32 [P * K] from the plan,
// vals [P * K, tail], out [rows = P * num, tail] and base (null, or the
// accumulate-into form's input, which may be out itself), all contiguous;
// 1 <= tail <= 256; flags: int8 scratch of P * ceil(num / (256 / tail))
// elements (one per row block: which blocks kernel B sums; written by
// kernel A, needs no clearing). negate != 0 subtracts every entry
// (index_add_'s alpha = -1). Writes every element of out; launches kernel
// A then kernel B on `stream`; returns the first CUDA error (0 on
// success), cudaErrorInvalidValue for arguments out of range.
extern "C" int seg_sum_f32(const void* off, const void* perm,
                           const void* vals, const void* base, void* out,
                           void* flags, int64_t rows, int64_t num,
                           int64_t tail, int negate, void* stream) {
  return launch<float>(off, perm, vals, base, out, flags, rows, num, tail,
                       negate, stream);
}

extern "C" int seg_sum_f64(const void* off, const void* perm,
                           const void* vals, const void* base, void* out,
                           void* flags, int64_t rows, int64_t num,
                           int64_t tail, int negate, void* stream) {
  return launch<double>(off, perm, vals, base, out, flags, rows, num, tail,
                        negate, stream);
}

// The probe: x [2] and out [1] on the card, n a multiple of 8.
extern "C" int add_chain_f32(const void* x, void* out, int64_t n,
                             void* stream) {
  return chain<float>(x, out, n, stream);
}

extern "C" int add_chain_f64(const void* x, void* out, int64_t n,
                             void* stream) {
  return chain<double>(x, out, n, stream);
}

// Block-COO -> dense for Hopper (sm_90a): kernel K1.
//
// Replaces the TPU kernel linearsfm_tpu/ops/pallas_kernels.py:
// blockcoo_to_dense (body _coo_dense_kernel). It builds the dense
// [R*M, C*N] matrices of the Schur assembly (A, Wd, Yd in ops/schur.py) from
// block-COO lists: entry k adds the R x C block vals[k] at block
// (rows[k], cols[k]); duplicate coordinates add up in list order. float32 is
// the main path (the Schur preconditioner); float64 serves the plain-Cholesky
// levels, which the TPU kernel could not (Mosaic has no 64-bit vectors).
//
// What bounds it: the bytes of the output, written once. A dense output (up
// to 12288 x 12288 f32 at the 2,048-map root, 0.6 GB) is one to three orders
// of magnitude larger than its entry list, so the least time is the output's
// bytes over the card's memory rate. The kernel writes every output byte
// exactly once, from shared memory: the wrapper allocates the output with
// torch.empty (no fill pass) and no element is read back from global memory.
// A scatter does no products, so the tensor cores have no part in it.
//
// Design, after the TPU kernel's (zero the output stripe in fast memory, add
// the entries there, write it out once):
// * A plan per block list (ops/kernels.coo_plan): one stable sort of the key
//   (lane*M + row)*N + col, invalid entries last, gives the permutation
//   `perm`, the sorted block columns `scol` and CSR offsets `row_ptr` over the
//   lane-folded block rows. In a block row the entries are ordered by column,
//   and the duplicates of a coordinate sit next to each other in list order.
//   A launch densifies a column window [col_lo, col_lo + width) of the plan
//   (a feature stripe of the Schur assembly): in each row the window's
//   entries are a contiguous sub-range, found by binary search in `scol`.
// * Tiles: the output is cut into tiles of TB block rows by TW columns, with
//   TW * sizeof(T) = 768 bytes (192 f32 or 96 f64 columns: a multiple of 3,
//   of 6 and of 16 bytes) and TB chosen so that a tile fills 27 KB (6 block
//   rows of 6). A persistent grid of three CTAs per SM deals the tiles out
//   round-robin: a W list is banded (a pose sees the features near it), so a
//   row of tiles holds its entries in a few neighbouring tiles, and dealing
//   neighbours to different CTAs spreads that work. Each CTA holds two tile
//   buffers in shared memory. Per tile: zero a buffer, add the tile's
//   entries into it, store it.
// * A producer warp runs up to two tiles ahead of eight consumer warps
//   (named barriers, two slots). It finds each row's sub-range, then stages
//   the tile's entries in shared memory: columns, entry indices and rows of
//   up to 512, and the values of the first 5,760 bytes' worth, copied with
//   cp.async. So the consumers' adds read shared memory, and the chains of
//   dependent global loads sit off their path.
// * Entries in parallel, order fixed, no atomics: a group of R*C consumer
//   threads takes one entry at a time, thread t its element t. Only the
//   first entry of a run of equal coordinates works: its thread sums element
//   t over the run in list order, from zero, and stores the sum. Every output
//   element is thus written by one thread, in the order of the plain version
//   (index_put_ with accumulate=True, which sums duplicates in stable sorted
//   order).
// * Asynchronous stores: a finished tile leaves in one TMA copy
//   (cp.async.bulk.tensor.2d, shared -> global, the tensor map clipping the
//   matrix's edges), with an L2 evict-first hint so that the streaming output
//   does not push the plan and the values out of the L2. A buffer is refilled
//   two tiles later, after cp.async.bulk.wait_group.read 1, so one tile's
//   store overlaps the next tile's work. (One cp.async.bulk per tile row,
//   36 a tile, held the issuing warp for a large part of each tile.)
//   Where a row's bytes are not a multiple of 16 (odd sizes such as M = 37,
//   N = 53), the same kernel stores the tile with plain coalesced stores.
// * What holds it back: tiles with hundreds of entries (a densely banded
//   list, as mono level 6's W): the entries past the staged ones are loaded
//   from global memory by the consumers, and the producer's searches are
//   chains of dependent loads, all inside one CTA.

#include <cuda.h>   // CUtensorMap and the encoder's types
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 256;             // 8 warps: zero, add, store
constexpr int kThreads = kConsumers + 32;   // + 1 producer warp
constexpr int kTileBytes = 27648;   // one tile buffer: 36 rows of 768 bytes
constexpr int kRowBytes = 768;      // a full tile row
constexpr int kMaxTB = 16;          // block rows per tile, at most
constexpr int kCap = 512;           // entries of a tile staged: column, index
constexpr int kValBytes = 5760;     // entries' values staged per tile slot
constexpr int kUnroll = 8;          // entries per group per round

// named barriers (0 is __syncthreads): consumers among themselves; the
// producer's "slot b full" and the consumers' "slot b empty"
constexpr int kBarCons = 1, kBarFull = 2, kBarEmpty = 4;

struct Params {
  const int* row_ptr;   // [n_brows + 1] CSR offsets into the sorted entries
  const int* perm;      // [nnz] entry index of each sorted position
  const int* scol;      // [nnz] block column of each sorted position
  const void* vals;     // [entries, R, C]
  void* out;            // [n_brows * R, C * width]
  int64_t n_brows;      // lane-folded block rows (P * M)
  int64_t n_cols;       // block columns of the plan (N)
  int64_t col_lo;       // first block column of the window
  int64_t ldo;          // C * width: output row length (elements)
  int64_t n_ct;         // column tiles per row tile
  int64_t n_tiles;
  int R, C;
  int TB, TW;           // tile: block rows, columns (elements)
  int sw;               // smem row stride: min(TW, ldo), the store box width
  int vcap;             // entries whose values fit in a slot
  int chunk;            // bytes per cp.async of values (4, 8 or 16)
  int bulk;             // tiles leave by TMA (else plain stores)
};

// One slot of what the producer warp prepares for a tile: per block row
// r < nb, the sorted positions [beg[r], beg[r] + pre[r+1] - pre[r]) of its
// entries in the tile's columns (pre: the exclusive prefix of the rows'
// counts); the first kCap entries' columns, entry indices and rows, and the
// values of the first vcap (in the slot's value buffer).
struct Meta {
  int beg[kMaxTB];
  int pre[kMaxTB + 1];
  int col[kCap];
  int ent[kCap];
  unsigned char row[kCap];   // the entry's block row in the tile
};

struct Tile {
  int64_t br0;   // first block row
  int64_t c0;    // first output column
  int64_t bc0;   // first block column (absolute)
  int nb;        // block rows
  int w;         // columns
};

__device__ __forceinline__ Tile tile_at(const Params& p, int64_t tile) {
  Tile t;
  const int64_t bt = tile / p.n_ct;
  t.c0 = (tile - bt * p.n_ct) * p.TW;
  t.br0 = bt * p.TB;
  t.nb = static_cast<int>(min(static_cast<int64_t>(p.TB), p.n_brows - t.br0));
  t.w = static_cast<int>(min(static_cast<int64_t>(p.TW), p.ldo - t.c0));
  t.bc0 = p.col_lo + t.c0 / p.C;
  return t;
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared without registers, completed by cp_async_wait_all
__device__ __forceinline__ void cp_async(void* sdst, const void* gsrc,
                                         int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(sdst)),
                 "l"(gsrc)
                 : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     smem_addr(sdst)),
                 "l"(gsrc)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(sdst)),
                 "l"(gsrc)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the whole tile, shared -> global, in one asynchronous TMA copy; the
// tensor map clips rows and columns past the matrix
__device__ __forceinline__ void tma_store_tile(const CUtensorMap* map,
                                               const void* ssrc, int col,
                                               int row) {
  // the output streams past the L2: evict it first, so that the plan and
  // the values the producers read stay resident
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint "
      "[%0, {%2, %3}], [%1], %4;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(ssrc)), "r"(col), "r"(row), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the smem reads of all but the newest bulk group are done
__device__ __forceinline__ void bulk_wait_read_1() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// the row r < nb with pre[r] <= e < pre[r + 1]
__device__ __forceinline__ int row_of(const int* pre, int nb, int e) {
  int r = 0, hi = nb;
  while (hi - r > 1) {
    const int mid = (r + hi) >> 1;
    if (pre[mid] <= e) r = mid;
    else hi = mid;
  }
  return r;
}

// first q in [lo, hi) with scol[q] >= key (hi if none)
__device__ __forceinline__ int lower_bound(const int* scol, int lo, int hi,
                                           int64_t key) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (scol[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Producer warp. For each of this CTA's tiles, lane r < nb finds row r's
// sub-range: its start by binary search for the tile's first block column
// (none for a tile at column 0), its end at the row's end when the tile
// reaches past the plan's last column, else by an exponential, then binary,
// search from the start (a row holds few entries in one tile). Then the
// rows' prefix, the staged columns, entry indices and rows, and the values,
// copied with cp.async, before the slot is handed over.
template <typename T>
__device__ void produce(const Params& p, Meta* meta, unsigned char* vbufs,
                        int lane) {
  const int RC = p.R * p.C;
  int it = 0;
  for (int64_t tile = blockIdx.x; tile < p.n_tiles;
       tile += gridDim.x, ++it) {
    const int b = it & 1;
    if (it >= 2) bar_sync(kBarEmpty + b, kThreads);   // tile it-2 consumed
    const Tile t = tile_at(p, tile);
    Meta& m = meta[b];
    const int64_t bc1 = t.bc0 + t.w / p.C;
    int beg = 0, end = 0;
    if (lane < t.nb) {
      const int a = p.row_ptr[t.br0 + lane];
      const int rend = p.row_ptr[t.br0 + lane + 1];
      beg = t.bc0 == 0 ? a : lower_bound(p.scol, a, rend, t.bc0);
      if (bc1 >= p.n_cols) {
        end = rend;
      } else {
        int lo = beg, hi = rend, step = 1;
        while (lo < hi) {   // exponential: scol[lo - 1] < bc1 (or lo = beg)
          const int probe = min(lo + step - 1, hi - 1);
          if (p.scol[probe] >= bc1) {
            hi = probe;
            break;
          }
          lo = probe + 1;
          step <<= 1;
        }
        end = lower_bound(p.scol, lo, hi, bc1);
      }
    }
    const int n = end - beg;
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    if (lane < t.nb) {
      m.beg[lane] = beg;
      m.pre[lane] = incl - n;
    }
    if (lane == 0) m.pre[t.nb] = total;
    __syncwarp();
    const int ns = min(total, kCap);
#pragma unroll 8
    for (int j = lane; j < ns; j += 32) {
      const int r = row_of(m.pre, t.nb, j);
      const int s = m.beg[r] + (j - m.pre[r]);
      m.col[j] = p.scol[s];
      m.ent[j] = p.perm[s];
      m.row[j] = static_cast<unsigned char>(r);
    }
    __syncwarp();
    const int nv = min(total, p.vcap);
    if (nv > 0) {
      const int per = RC * static_cast<int>(sizeof(T)) / p.chunk;
      const unsigned char* src = static_cast<const unsigned char*>(p.vals);
      unsigned char* dst = vbufs + b * kValBytes;
      for (int q = lane; q < nv * per; q += 32) {
        const int j = q / per, c = q - j * per;
        cp_async(dst + (j * per + c) * p.chunk,
                 src + (static_cast<int64_t>(m.ent[j]) * per + c) * p.chunk,
                 p.chunk);
      }
      cp_async_wait_all();
    }
    __threadfence_block();
    __syncwarp();
    bar_arrive(kBarFull + b, kThreads);
  }
  // the consumers' last two "empty" arrivals
  for (int k = it >= 2 ? it - 2 : 0; k < it; ++k)
    bar_sync(kBarEmpty + (k & 1), kThreads);
}

template <typename T>
__device__ void consume(const CUtensorMap* map, const Params& p,
                        const Meta* meta, T* bufs,
                        const unsigned char* vbufs, int tid) {
  const int R = p.R, C = p.C, RC = R * C, sw = p.sw;
  const T* __restrict__ vals = static_cast<const T*>(p.vals);
  T* __restrict__ out = static_cast<T*>(p.out);
  // groups of RC threads, one entry each at a time; thread tt of a group
  // owns element (i_r, j_c) of the block
  const int groups = kConsumers / RC, g = tid / RC, tt = tid - g * RC;
  const int i_r = tt / C, j_c = tt - i_r * C;
  int it = 0;
  for (int64_t tile = blockIdx.x; tile < p.n_tiles;
       tile += gridDim.x, ++it) {
    const int b = it & 1;
    const Tile t = tile_at(p, tile);
    T* buf = bufs + b * (kTileBytes / sizeof(T));
    const T* vbuf = reinterpret_cast<const T*>(vbufs + b * kValBytes);
    const int rows = t.nb * R, n_elem = rows * sw;

    // this buffer's store, two tiles back, has finished reading it
    if (p.bulk && tid == 0) bulk_wait_read_1();
    bar_sync(kBarCons, kConsumers);
    {
      uint4* b4 = reinterpret_cast<uint4*>(buf);
      const int n4 = (n_elem * static_cast<int>(sizeof(T)) + 15) / 16;
      for (int i = tid; i < n4; i += kConsumers) b4[i] = make_uint4(0, 0, 0, 0);
    }
    bar_sync(kBarFull + b, kThreads);   // slot b ready, buffer zeroed
    const Meta& m = meta[b];
    const int total = m.pre[t.nb];
    const int nv = min(total, p.vcap);

    // entry e of the tile (sorted order): staged, or read from the plan
    auto row_at = [&](int e) {
      return e < kCap ? static_cast<int>(m.row[e]) : row_of(m.pre, t.nb, e);
    };
    auto col_at = [&](int e, int r) {
      return e < kCap ? m.col[e] : p.scol[m.beg[r] + (e - m.pre[r])];
    };
    auto val_at = [&](int e, int r) -> T {
      if (e < nv) return vbuf[e * RC + tt];
      const int k = e < kCap ? m.ent[e] : p.perm[m.beg[r] + (e - m.pre[r])];
      return vals[static_cast<int64_t>(k) * RC + tt];
    };
    // group g takes entries g, g + G, ...; its thread tt owns element tt.
    // Only the head of a run of equal coordinates works: it sums the run in
    // list order, from zero. Values past the staged ones come from global
    // memory, so kUnroll entries' loads go out before any sum.
    if (g < groups) {
      for (int e0 = g; e0 < total; e0 += groups * kUnroll) {
        T v[kUnroll];
        unsigned heads = 0;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int e = e0 + u * groups;
          if (e < total) {
            const int r = row_at(e);
            if (e == m.pre[r] || col_at(e - 1, r) != col_at(e, r)) {
              heads |= 1u << u;
              v[u] = val_at(e, r);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (!(heads >> u & 1u)) continue;
          const int e = e0 + u * groups, r = row_at(e), col = col_at(e, r);
          const int qe = m.pre[r + 1];
          T acc = T(0) + v[u];
          for (int q = e + 1; q < qe && col_at(q, r) == col; ++q)
            acc += val_at(q, r);
          buf[(r * R + i_r) * sw + static_cast<int>(col - t.bc0) * C + j_c] =
              acc;
        }
      }
    }
    fence_proxy_async_shared();   // smem writes -> visible to the TMA
    bar_sync(kBarCons, kConsumers);
    bar_arrive(kBarEmpty + b, kThreads);   // slot b may be refilled

    if (p.bulk) {
      if (tid == 0) {
        tma_store_tile(map, buf, static_cast<int>(t.c0),
                       static_cast<int>(t.br0 * R));
        bulk_commit();
      }
    } else {
      T* orow = out + (t.br0 * R) * p.ldo + t.c0;
      const int n = rows * t.w;
      for (int i = tid; i < n; i += kConsumers) {
        const int rr = i / t.w, cc = i - rr * t.w;
        orow[rr * p.ldo + cc] = buf[rr * sw + cc];
      }
    }
  }
  if (p.bulk && tid == 0) bulk_wait_all();
}

// dynamic shared memory: two tile buffers, then two value buffers
constexpr int kSmemBytes = 2 * kTileBytes + 2 * kValBytes;

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
    blockcoo_dense_kernel(const __grid_constant__ CUtensorMap map,
                          const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Meta meta[2];
  unsigned char* vbufs = smem + 2 * kTileBytes;
  if (threadIdx.x >= kConsumers)
    produce<T>(p, meta, vbufs, threadIdx.x - kConsumers);
  else
    consume<T>(&map, p, meta, reinterpret_cast<T*>(smem), vbufs,
               threadIdx.x);
}

int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

template <typename T>
int launch(const void* row_ptr, const void* perm, const void* scol,
           const void* vals, void* out, int64_t n_brows, int64_t n_cols,
           int R, int C, int64_t col_lo, int64_t width, void* stream) {
  if (R <= 0 || C <= 0 || R * C > 64 || n_brows < 0 || width < 0 ||
      n_cols < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_brows == 0 || width == 0) return static_cast<int>(cudaSuccess);
  const int esz = static_cast<int>(sizeof(T));
  // TW: a multiple of C and of 16 bytes, near 768 bytes, with R rows of it
  // inside one tile buffer
  const int unit = C / gcd(C, 16 / esz) * (16 / esz);
  int TW = kRowBytes / esz / unit * unit;
  const int fit = kTileBytes / (R * esz) / unit * unit;
  if (fit < TW) TW = fit;
  if (TW < unit) TW = unit;
  const int64_t ldo = static_cast<int64_t>(C) * width;
  const int w_full = static_cast<int>(ldo < TW ? ldo : TW);
  int TB = kTileBytes / (R * w_full * esz);
  if (TB > kMaxTB) TB = kMaxTB;
  if (TB * R > 256) TB = 256 / R;   // a TMA box has at most 256 rows
  if (TB < 1 || static_cast<int64_t>(TB) * R * w_full * esz > kTileBytes ||
      n_brows * R >= (int64_t(1) << 31) || ldo >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.row_ptr = static_cast<const int*>(row_ptr);
  p.perm = static_cast<const int*>(perm);
  p.scol = static_cast<const int*>(scol);
  p.vals = vals;
  p.out = out;
  p.n_brows = n_brows;
  p.n_cols = n_cols;
  p.col_lo = col_lo;
  p.ldo = ldo;
  p.n_ct = (ldo + TW - 1) / TW;
  p.n_tiles = (n_brows + TB - 1) / TB * p.n_ct;
  p.R = R;
  p.C = C;
  p.TB = TB;
  p.TW = TW;
  p.sw = w_full;
  p.vcap = kValBytes / (R * C * esz) < kCap ? kValBytes / (R * C * esz) : kCap;
  {   // the widest cp.async that divides an entry's values and their base
    const int eb = R * C * esz;
    const uintptr_t va = reinterpret_cast<uintptr_t>(vals);
    p.chunk = (eb % 16 == 0 && va % 16 == 0) ? 16
              : (eb % 8 == 0 && va % 8 == 0) ? 8 : 4;
    if (eb % 4 != 0 || va % 4 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  p.bulk = (ldo * esz) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(out) % 16 == 0;
  CUtensorMap map = {};
  if (p.bulk) {   // the output as a 2-D tensor, boxes of one tile
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(ldo),
                                static_cast<cuuint64_t>(n_brows * R)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldo * esz)};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(w_full),
                               static_cast<cuuint32_t>(TB * R)};
    const cuuint32_t elem[2] = {1, 1};
    if (encode(&map,
               esz == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
               2, out, dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_NONE,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }

  const int smem = kSmemBytes;
  auto kern = blockcoo_dense_kernel<T>;
  // per device, once: the shared-memory opt-in and the persistent grid size
  static int grid_of_dev[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (grid_of_dev[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, kThreads, smem)) != cudaSuccess)
      return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid_of_dev[dev] = sms * per_sm;
  }
  int64_t grid = grid_of_dev[dev];
  if (grid > p.n_tiles) grid = p.n_tiles;
  kern<<<static_cast<unsigned>(grid), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(map, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// row_ptr[n_brows + 1], perm[nnz], scol[nnz] (int32): the plan of
// ops/kernels.coo_plan over n_cols block columns; vals[entries, R, C];
// out[n_brows * R, C * width], uninitialised: every element is written.
// Densifies the block columns [col_lo, col_lo + width) of the plan. Launches on `stream`; returns the
// first CUDA error of the set-up or the launch (0 on success).
extern "C" int blockcoo_dense_f32(const void* row_ptr, const void* perm,
                                  const void* scol, const void* vals,
                                  void* out, int64_t n_brows, int64_t n_cols,
                                  int R, int C, int64_t col_lo, int64_t width,
                                  void* stream) {
  return launch<float>(row_ptr, perm, scol, vals, out, n_brows, n_cols, R, C,
                     col_lo, width, stream);
}

extern "C" int blockcoo_dense_f64(const void* row_ptr, const void* perm,
                                  const void* scol, const void* vals,
                                  void* out, int64_t n_brows, int64_t n_cols,
                                  int R, int C, int64_t col_lo, int64_t width,
                                  void* stream) {
  return launch<double>(row_ptr, perm, scol, vals, out, n_brows, n_cols, R, C,
                     col_lo, width, stream);
}

// Hopper (sm_90a) kernels for per-vertex reductions over an ELL neighbour
// matrix nbrs [n, D] (int32, pad = n).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/segment_ell.py:
//   ell_stat (_kernel, pallas_call at line 120)           -> ell_stat_kernel
//   ell_aggregate (_agg_kernel, pallas_call at line 212)  -> ell_aggregate_kernel
//
// Design. The TPU kernels walk a (n/BN, D/BD) grid in order and carry the
// running reduction, and a neighbour count that pins max of an empty row
// to 0, from one D block to the next in the output block. Hopper's blocks
// run in no order, so here a row is reduced by one thread (ell_stat) or
// one warp (ell_aggregate) that loops over all of D itself: the reduction
// lives in registers, with no second grid dimension, no atomics and no
// count array.
//   ell_stat: a row's work is a few bytes of ids and one random 4- or
//   8-byte gather a live neighbour, so what bounds it is keeping the nbrs
//   stream and enough gathers in flight. A block owns a tile of kRows
//   (256) consecutive rows. Whole rows, when the tile fits kTileBytes (all
//   of D = 38 on the ER graph), are one contiguous span of nbrs: the block
//   reads it 16 bytes a thread, kLoadVecs loads in flight before any
//   store, evict-first (nbrs is read once), into shared memory, with a
//   scalar head and tail where the span is not 16-byte aligned. Each
//   thread then takes entries t, t + 256, ... of the tile, issues kGathers
//   gathers of vals before it uses any, and writes each entry's
//   contribution over its id: a count's 0 or 1 (the row's self value
//   staged in shared memory), a sum's value, max's value or, for a pad
//   entry, the sentinel, with the row marked as holding a neighbour. Then
//   each thread folds its own row's slots in column order from shared
//   memory: one loop for the four ops and three dtypes, with no shuffles,
//   so a float32 sum adds in the plain version's order and is bit for bit
//   its result. A wider row is cut into column chunks of the tile's width,
//   read an id a thread, and the accumulator carries from chunk to chunk
//   in registers. The outputs leave as one coalesced store of 256.
//   Measured on the ELL matrix of erdos_renyi(2**21, 16M) with its core
//   numbers (NVIDIA H100 80GB HBM3, 700.00 W, scripts/time_kernel_api.py):
//   0.284-0.291 ms for each int32 and float32 instance (the warp a row of
//   before: 0.354-0.466, and 0.736 for the float32 sum's shuffle walk).
//   What bounds it is L2's rate for 32-byte sectors: each live gather
//   moves one, so the gathers and the nbrs stream take 1.34 GB from L2,
//   at about 4.7 TB/s, the rate at which torch.index_select gathers the
//   same live ids (0.2691-0.2718 ms; 0.1231-0.1238 with the ids sorted).
//   So neither more gathers in flight (16 a thread: up to 0.35 ms), nor
//   smaller tiles (128 or 64 rows: 0.29-0.31), nor a persistent grid that
//   copies the next tile's ids by cp.async while it gathers this one (two
//   stages, 2 blocks an SM: 0.31-0.33) was faster.
//   ell_aggregate: the lanes lie across F instead, and the row's work is
//   its live neighbours' feature-row gathers (a random 4F- or 2F-byte read
//   each), so what bounds it is how many of them are in flight and how
//   few instructions each costs. The warp reads its row's ids once,
//   coalesced, 64 columns at a time (two ids a lane; the next row's first
//   64 are loaded before this row's gathers); each lane turns its two ids
//   into feature-row offsets, and the warp compacts the live ones, in
//   column order, into a 64-entry list in shared memory (ballots and
//   popcounts give each its slot): pad entries cost nothing further. The
//   warp then reads the list by broadcast loads, kUnroll entries at a
//   time, issuing all kUnroll gathers of a group before folding any, so a
//   warp has kUnroll rows in flight instead of one. Each lane loads 4
//   features with one vector load (float4 for float32, 8 bytes for
//   bfloat16) where F % 4 == 0 and the feats and out bases allow it, else
//   4 scalar loads 32 apart (the C entry picks the instance). Every output
//   element still folds its neighbours in column order, so a float32 sum
//   is bit for bit the plain version's. Measured on the ELL matrix of
//   erdos_renyi(2**21, 16M) with [n, 100] features (NVIDIA H100 80GB
//   HBM3, 700.00 W, scripts/time_kernel_api.py): broadcasting the offsets
//   by shuffles instead of the shared list took 3.55 ms against 3.07 for
//   bfloat16 max (the walk's instructions, and spills in the float32 max
//   instance), and 4 gathers in flight against 8 were 2-3% slower.
//
// Semantics kept from the reference (segment_ell.py and kernels/ref.py):
//   * an id is a neighbour when id < n; a negative id is a neighbour too
//     and wraps once over the n + 1 long value vector (jnp.take), so -1
//     reads the zero sentinel row; an id still outside [0, n] reads 0
//     (take's fill_value);
//   * counts and integer sums wrap to the value type, as the kernel's cast
//     of its int64 partial back to vals' dtype does (unsigned arithmetic
//     here, so the wrap is defined);
//   * max folds the sentinel (-(2**30) for ell_stat, -1e30 for
//     ell_aggregate) in wherever the row holds a pad entry, and a row with
//     no neighbour returns 0; NaN propagates as jnp.max does;
//   * ell_aggregate's sum accumulates in float32 and rounds once to the
//     output type (the Pallas kernel rounds a bf16 sum at every 64-column
//     D block; the reference oracle, like this kernel, once).
//
// Bound. ell_stat: the nbrs matrix (4 B an entry), vals and self_vals once
// and the output once; the vals gathers are random 4 B reads that the 50 MB
// L2 mostly serves (vals of a 2M-vertex graph is 8 MB). ell_aggregate: the
// nbrs matrix, feats and the output once is its byte bound, but its real
// traffic is one F-wide feature row gathered per live neighbour, in whole
// 32-byte sectors (13 for a 400-byte float32 row, 7 for a 200-byte bf16
// one), which is what limits it.
//
// C interface for ctypes: every function returns cudaGetLastError() of its
// launch; the caller raises when it is not 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op { COUNT_GE = 0, COUNT_GT = 1, SUM = 2, MAX = 3 };
enum DType { I32 = 0, I64 = 1, F32 = 2, BF16 = 3 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 132LL * 32;
constexpr int kRows = kThreads;        // ell_stat: rows a tile, a thread each
constexpr int kTileBytes = 80 * 1024;  // ell_stat: a tile's slots at most
constexpr int kGathers = 8;            // ell_stat: gathers in flight a thread
constexpr int kLoadVecs = 4;           // ell_stat: 16-byte id loads in flight
constexpr int kPerLane = 4;  // ell_aggregate: features a lane holds
constexpr int kUnroll = 8;   // ell_aggregate: gathers in flight a warp

// the accumulator of a sum: wrapping unsigned for the integer types
template <typename T> struct Acc { using type = T; };
template <> struct Acc<int> { using type = unsigned int; };
template <> struct Acc<long long> { using type = unsigned long long; };

template <typename T> __device__ __forceinline__ bool is_nan(T) { return false; }
template <> __device__ __forceinline__ bool is_nan<float>(float x) { return x != x; }

// jnp.max: NaN wins, then the larger value, and a tie keeps a. Two
// compares and a select: ell_aggregate folds every gathered feature with
// it, and a third compare (keeping a's NaN when both are NaN) made the
// float32 and bfloat16 max instances 6% and 28% slower (NVIDIA H100 80GB
// HBM3, 700.00 W, scripts/time_kernel_api.py)
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (b > a || is_nan(b)) ? b : a;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the row of id in the (n + 1)-row extended value array, or -1 for the
// zero fill (the sentinel row n reads 0 too)
__device__ __forceinline__ long long ext_row(int id, long long n) {
  long long r = id < 0 ? (long long)id + n + 1 : (long long)id;
  return (r >= 0 && r < n) ? r : -1;
}

// ell_stat: one shared-memory slot of a tile, an id first and then the
// entry's contribution: 4 bytes, but 8 for an int64 sum's or max's value
template <typename T, int OP> struct Slot { using type = unsigned int; };
template <> struct Slot<long long, SUM> { using type = unsigned long long; };
template <> struct Slot<long long, MAX> { using type = unsigned long long; };

__device__ __forceinline__ unsigned to_slot(int x) { return (unsigned)x; }
__device__ __forceinline__ unsigned to_slot(float x) { return __float_as_uint(x); }
__device__ __forceinline__ unsigned long long to_slot(long long x) {
  return (unsigned long long)x;
}
__device__ __forceinline__ void from_slot(unsigned s, int& x) { x = (int)s; }
__device__ __forceinline__ void from_slot(unsigned s, float& x) { x = __uint_as_float(s); }
__device__ __forceinline__ void from_slot(unsigned long long s, long long& x) {
  x = (long long)s;
}

// four ids of one 16-byte load into four slots (two 16-byte stores for
// 8-byte slots); p is 16-byte aligned
__device__ __forceinline__ void store_ids(unsigned* p, int4 q) {
  *reinterpret_cast<int4*>(p) = q;
}
__device__ __forceinline__ void store_ids(unsigned long long* p, int4 q) {
  auto w = reinterpret_cast<ulonglong2*>(p);
  w[0] = make_ulonglong2((unsigned)q.x, (unsigned)q.y);
  w[1] = make_ulonglong2((unsigned)q.z, (unsigned)q.w);
}

// Stage the ids of rows [v0, v0 + rows) x columns [c0, c0 + cols) in
// shared memory, entry (r, c) at slot r * cols + c of the returned tile.
// Whole rows (cols == D) are one contiguous span of nbrs: read 16 bytes a
// thread, kLoadVecs loads in flight before any store, with a scalar head
// up to the first 16-byte boundary and a scalar tail; the tile starts sh
// slots into buf so that the span's 16-byte words land on 16-byte words.
// A chunk of a wider row is read an id a thread, coalesced along c.
template <typename S>
__device__ __forceinline__ S* load_tile(S* buf, const int* __restrict__ nbrs,
                                        long long v0, int rows, long long D,
                                        long long c0, int cols) {
  const int t = threadIdx.x;
  const int total = rows * cols;
  if (cols != D) {
    for (int e = t; e < total; e += kThreads) {
      const int r = e / cols;
      buf[e] = (S)(unsigned)nbrs[(v0 + r) * D + c0 + (e - r * cols)];
    }
    return buf;
  }
  const int* src = nbrs + v0 * D;
  const int sh = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int head = min((4 - sh) & 3, total);
  S* tile = buf + sh;
  if (t < head) tile[t] = (S)(unsigned)src[t];
  const int nvec = (total - head) >> 2;
  const int4* vsrc = reinterpret_cast<const int4*>(src + head);
  for (int i0 = t; i0 < nvec; i0 += kThreads * kLoadVecs) {
    int4 q[kLoadVecs];
#pragma unroll
    for (int u = 0; u < kLoadVecs; ++u)
      if (i0 + u * kThreads < nvec) q[u] = __ldcs(vsrc + i0 + u * kThreads);
#pragma unroll
    for (int u = 0; u < kLoadVecs; ++u)
      if (i0 + u * kThreads < nvec) store_ids(tile + head + 4 * (i0 + u * kThreads), q[u]);
  }
  const int done = head + 4 * nvec;
  if (t < total - done) tile[done + t] = (S)(unsigned)src[done + t];
  return tile;
}

// Resolve the tile's entries and write each one's contribution over its
// id: a thread takes entries t, t + kThreads, ... and issues kGathers
// gathers of vals before it uses any. count_ge / count_gt: 1 for a
// neighbour that compares true against its row's self value; sum: the
// value, 0 for a pad; max: the value, the sentinel for a pad, and the row
// marked as holding a neighbour.
template <typename T, int OP, typename S>
__device__ __forceinline__ void gather_tile(S* tile, int total, int cols,
                                            const T* __restrict__ vals,
                                            const T* selfs,
                                            unsigned char* has, long long n) {
  const T neg = T(-(1 << 30));
  const int t = threadIdx.x;
  // the row and column of the thread's entry, stepped kThreads entries at
  // a time (only the counts and max read them)
  int r = t / cols, c = t - r * cols;
  const int sr = kThreads / cols, sc = kThreads - sr * cols;
  for (int e0 = t; e0 < total; e0 += kThreads * kGathers) {
    T x[kGathers];
    bool live[kGathers];
#pragma unroll
    for (int u = 0; u < kGathers; ++u) {
      const int e = e0 + u * kThreads;
      const int id = e < total ? (int)(unsigned)tile[e] : 0;
      live[u] = e < total && (long long)id < n;
      const long long at = live[u] ? ext_row(id, n) : -1;
      x[u] = at >= 0 ? __ldg(vals + at) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kGathers; ++u) {
      const int e = e0 + u * kThreads;
      if (e < total) {
        if constexpr (OP == COUNT_GE) tile[e] = live[u] && x[u] >= selfs[r];
        if constexpr (OP == COUNT_GT) tile[e] = live[u] && x[u] > selfs[r];
        if constexpr (OP == SUM) tile[e] = to_slot(x[u]);
        if constexpr (OP == MAX) {
          tile[e] = to_slot(live[u] ? x[u] : neg);
          if (live[u]) has[r] = 1;
        }
      }
      c += sc;
      r += sr;
      if (c >= cols) {
        c -= cols;
        ++r;
      }
    }
  }
}

// A block owns kRows consecutive rows and one thread folds each. Per chunk
// of at most C columns (all of D when the tile fits kTileBytes): stage the
// ids, gather, then fold the row's slots in column order from shared
// memory, the accumulator carried in registers from chunk to chunk.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
ell_stat_kernel(const int* __restrict__ nbrs, const T* __restrict__ vals,
                const T* __restrict__ self_vals, T* __restrict__ out,
                long long n, long long D, int C) {
  using A = typename Acc<T>::type;
  using S = typename Slot<T, OP>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T* selfs = reinterpret_cast<T*>(smem);
  unsigned char* has = smem + kRows * sizeof(T);
  S* buf = reinterpret_cast<S*>(has + kRows);
  const int t = threadIdx.x;
  const long long v0 = (long long)blockIdx.x * kRows;
  const int rows = n - v0 < kRows ? (int)(n - v0) : kRows;
  if (OP == COUNT_GE || OP == COUNT_GT) selfs[t] = t < rows ? self_vals[v0 + t] : T(0);
  if (OP == MAX) has[t] = 0;
  unsigned cnt = 0;
  A sum = A(0);
  T mx = T(0);
  bool first = true;
  for (long long c0 = 0; c0 < D; c0 += C) {
    const int cols = D - c0 < C ? (int)(D - c0) : C;
    S* tile = load_tile(buf, nbrs, v0, rows, D, c0, cols);
    __syncthreads();
    gather_tile<T, OP>(tile, rows * cols, cols, vals, selfs, has, n);
    __syncthreads();
    if (t < rows) {
      const S* row = tile + t * cols;
#pragma unroll 4
      for (int j = 0; j < cols; ++j) {
        const S s = row[j];
        if constexpr (OP == COUNT_GE || OP == COUNT_GT) {
          cnt += (unsigned)s;
        } else {
          T x;
          from_slot(s, x);
          if (OP == SUM) sum += (A)x;
          if (OP == MAX) {
            mx = first ? x : max_nan(mx, x);
            first = false;
          }
        }
      }
    }
    if (c0 + C < D) __syncthreads();  // the next chunk rewrites the tile
  }
  if (t < rows) {
    T res;
    if (OP == COUNT_GE || OP == COUNT_GT) res = (T)(A)cnt;
    if (OP == SUM) res = (T)sum;
    if (OP == MAX) res = has[t] ? mx : T(0);
    out[v0 + t] = res;
  }
}

// ell_aggregate: a lane's 4 features of one feature row, raw (VEC: one
// 16-byte float4 or one 8-byte load of 4 bf16 at element f; else 4 scalar
// loads at f, f + 32, f + 64, f + 96), zero where out of range
template <typename T, bool VEC> struct Quad;
template <> struct Quad<float, true> {
  float4 v;
  __device__ __forceinline__ void load(const float* p, long long f, long long F) {
    v = f < F ? __ldg(reinterpret_cast<const float4*>(p + f)) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ float get(int k) const {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  }
};
template <> struct Quad<__nv_bfloat16, true> {
  uint2 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p, long long f, long long F) {
    v = f < F ? __ldg(reinterpret_cast<const uint2*>(p + f)) : make_uint2(0u, 0u);
  }
  __device__ __forceinline__ float get(int k) const {
    const unsigned w = k < 2 ? v.x : v.y;  // bf16 k at bits 16 * (k % 2)
    return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};
template <typename T> struct Quad<T, false> {
  float x[kPerLane];
  __device__ __forceinline__ void load(const T* p, long long f, long long F) {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k)
      x[k] = f + 32 * k < F ? to_f(p[f + 32 * k]) : 0.f;
  }
  __device__ __forceinline__ float get(int k) const { return x[k]; }
};

// the lane's ids of columns j0 + lane and j0 + 32 + lane (0 past D)
__device__ __forceinline__ void load_ids(const int* row, long long j0,
                                         long long D, int lane, int& a,
                                         int& b) {
  a = j0 + lane < D ? row[j0 + lane] : 0;
  b = j0 + 32 + lane < D ? row[j0 + 32 + lane] : 0;
}

// where a live id's feature row starts in feats (-1: it reads the zero
// fill)
__device__ __forceinline__ long long row_offset(int id, long long n,
                                                long long F) {
  const long long r = ext_row(id, n);
  return r >= 0 ? r * F : -1;
}

template <typename T, int OP, bool VEC>
__global__ void __launch_bounds__(kThreads)
ell_aggregate_kernel(const int* __restrict__ nbrs, const T* __restrict__ feats,
                     T* __restrict__ out, long long n, long long D,
                     long long F) {
  const unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long warp0 = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarps;
  const float neg = to_f(from_f<T>(-1e30f));  // the sentinel in T
  // the warp's live columns' feature-row offsets, in column order
  __shared__ long long offs[kWarps][64];
  long long* buf = offs[threadIdx.x >> 5];
  // this lane's first feature in a pass of 32 * kPerLane
  const int lane_f = VEC ? kPerLane * lane : lane;
  int next_a = 0, next_b = 0;
  if (warp0 < n) load_ids(nbrs + warp0 * D, 0, D, lane, next_a, next_b);
  for (long long v = warp0; v < n; v += stride) {
    const int* row = nbrs + v * D;
    const int first_a = next_a, first_b = next_b;
    if (v + stride < n)  // the next row's ids, in flight with this row
      load_ids(row + stride * D, 0, D, lane, next_a, next_b);
    for (long long f0 = 0; f0 < F; f0 += 32 * kPerLane) {
      const long long f = f0 + lane_f;
      float acc[kPerLane];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k)
        acc[k] = OP == SUM ? 0.f : __int_as_float(0xff800000);  // -inf
      bool any = false, pad = false;  // warp-uniform
      for (long long j0 = 0; j0 < D; j0 += 64) {
        int ida = first_a, idb = first_b;
        if (j0 > 0) load_ids(row, j0, D, lane, ida, idb);
        const bool in_a = j0 + lane < D, in_b = j0 + 32 + lane < D;
        const bool live_a = in_a && (long long)ida < n;
        const bool live_b = in_b && (long long)idb < n;
        // each lane resolves its own two columns once; the gathers below
        // only read the offsets back
        const long long off_a = live_a ? row_offset(ida, n, F) : -1;
        const long long off_b = live_b ? row_offset(idb, n, F) : -1;
        const unsigned lo = __ballot_sync(kAll, live_a);
        const unsigned hi = __ballot_sync(kAll, live_b);
        pad = pad || __any_sync(kAll, (in_a && !live_a) || (in_b && !live_b));
        any = any || (lo | hi) != 0;
        const unsigned lt = (1u << lane) - 1;  // the lanes below this one
        if (live_a) buf[__popc(lo & lt)] = off_a;
        if (live_b) buf[__popc(lo) + __popc(hi & lt)] = off_b;
        __syncwarp();
        const int total = __popc(lo) + __popc(hi);
        for (int k0 = 0; k0 < total; k0 += kUnroll) {
          Quad<T, VEC> x[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const long long o = k0 + u < total ? buf[k0 + u] : -1;
            x[u].load(feats + (o >= 0 ? o : 0), f, o >= 0 ? F : 0);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (k0 + u >= total) break;
#pragma unroll
            for (int k = 0; k < kPerLane; ++k) {
              if (OP == SUM) acc[k] += x[u].get(k);
              else acc[k] = max_nan(acc[k], x[u].get(k));
            }
          }
        }
        __syncwarp();  // the next chunk rewrites the list
      }
      float res[kPerLane];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        res[k] = acc[k];
        if (OP == MAX) res[k] = !any ? 0.f : pad ? max_nan(acc[k], neg) : acc[k];
      }
      T* o = out + v * F;
      if constexpr (VEC) {
        if (f < F) {
          if constexpr (sizeof(T) == 4) {
            *reinterpret_cast<float4*>(o + f) = make_float4(res[0], res[1], res[2], res[3]);
          } else {
            unsigned h[kPerLane];
#pragma unroll
            for (int k = 0; k < kPerLane; ++k)
              h[k] = __bfloat16_as_ushort(from_f<__nv_bfloat16>(res[k]));
            *reinterpret_cast<uint2*>(o + f) =
                make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < kPerLane; ++k)
          if (f + 32 * k < F) o[f + 32 * k] = from_f<T>(res[k]);
      }
    }
  }
}

unsigned blocks_for(long long rows) {
  long long b = (rows + kWarps - 1) / kWarps;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return (unsigned)(b < 1 ? 1 : b);
}

template <typename T, int OP>
int launch_stat_op(const int* nb, const T* va, const T* sv, T* o, long long n,
                   long long D, cudaStream_t st) {
  using S = typename Slot<T, OP>::type;
  // columns a tile: all of D while the tile fits kTileBytes
  const long long cap = kTileBytes / (kRows * (long long)sizeof(S));
  const int C = (int)(D < cap ? D : cap);
  // self values, row marks, the tile and the up to 3 slots of its shift
  const size_t smem = kRows * (sizeof(T) + 1) + ((size_t)kRows * C + 4) * sizeof(S);
  auto kernel = ell_stat_kernel<T, OP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long g = (n + kRows - 1) / kRows;
  if (g > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)g, kThreads, smem, st>>>(nb, va, sv, o, n, D, C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_stat(const void* nbrs, const void* vals, const void* self_vals,
                void* out, long long n, long long D, int op, cudaStream_t st) {
  auto nb = (const int*)nbrs;
  auto va = (const T*)vals;
  auto sv = (const T*)self_vals;
  auto o = (T*)out;
  switch (op) {
    case COUNT_GE: return launch_stat_op<T, COUNT_GE>(nb, va, sv, o, n, D, st);
    case COUNT_GT: return launch_stat_op<T, COUNT_GT>(nb, va, sv, o, n, D, st);
    case SUM: return launch_stat_op<T, SUM>(nb, va, sv, o, n, D, st);
    case MAX: return launch_stat_op<T, MAX>(nb, va, sv, o, n, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int OP>
void launch_agg_op(bool vec, unsigned g, const int* nb, const T* fe, T* o,
                   long long n, long long D, long long F, cudaStream_t st) {
  if (vec)
    ell_aggregate_kernel<T, OP, true><<<g, kThreads, 0, st>>>(nb, fe, o, n, D, F);
  else
    ell_aggregate_kernel<T, OP, false><<<g, kThreads, 0, st>>>(nb, fe, o, n, D, F);
}

template <typename T>
int launch_agg(const void* nbrs, const void* feats, void* out, long long n,
               long long D, long long F, int op, cudaStream_t st) {
  auto nb = (const int*)nbrs;
  auto fe = (const T*)feats;
  auto o = (T*)out;
  const unsigned g = blocks_for(n);
  // one vector load of 4 features a lane: every row of feats and out must
  // start on a multiple of 4 elements (16 B float32, 8 B bfloat16)
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = F % 4 == 0 && (uintptr_t)feats % align == 0 &&
                   (uintptr_t)out % align == 0;
  switch (op) {
    case SUM: launch_agg_op<T, SUM>(vec, g, nb, fe, o, n, D, F, st); break;
    case MAX: launch_agg_op<T, MAX>(vec, g, nb, fe, o, n, D, F, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out [n] in vals' type; n > 0 and D > 0 (the wrapper short-circuits the
// empty cases). dtype: I32, I64 or F32.
int ell_stat(const void* nbrs, const void* vals, const void* self_vals,
             void* out, long long n, long long D, int op, int dtype,
             void* stream) {
  auto st = (cudaStream_t)stream;
  switch (dtype) {
    case I32: return launch_stat<int>(nbrs, vals, self_vals, out, n, D, op, st);
    case I64: return launch_stat<long long>(nbrs, vals, self_vals, out, n, D, op, st);
    case F32: return launch_stat<float>(nbrs, vals, self_vals, out, n, D, op, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out [n, F] in feats' type; n > 0 and D > 0. dtype: F32 or BF16.
int ell_aggregate(const void* nbrs, const void* feats, void* out, long long n,
                  long long D, long long F, int op, int dtype, void* stream) {
  auto st = (cudaStream_t)stream;
  switch (dtype) {
    case F32: return launch_agg<float>(nbrs, feats, out, n, D, F, op, st);
    case BF16: return launch_agg<__nv_bfloat16>(nbrs, feats, out, n, D, F, op, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

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
// run in no order, so here one warp owns a row and loops over all of D
// itself: the reduction lives in registers, with no second grid dimension,
// no atomics and no count array.
//   ell_stat: the 32 lanes read the row's ids together (coalesced) and
//   each gathers vals[id]. For the counts, max and integer sums each lane
//   folds into its own partial and a warp shuffle tree combines the lanes
//   (exact in any order: integer sums wrap). A float32 sum instead folds
//   each 32-column chunk in column order (the gathered values broadcast
//   lane by lane with shuffles), so it adds in the plain version's order
//   and is bit for bit its result on any data. The serial fold is slow:
//   run for int32 too, it took 0.72 ms against the tree's 0.35 ms on the
//   ELL matrix of erdos_renyi(2**21, 16M) (chip_smoke.py, NVIDIA H100
//   80GB HBM3, 700.00 W), so integer sums keep the tree.
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

#include <type_traits>

namespace {

enum Op { COUNT_GE = 0, COUNT_GT = 1, SUM = 2, MAX = 3 };
enum DType { I32 = 0, I64 = 1, F32 = 2, BF16 = 3 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 132LL * 32;
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

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
ell_stat_kernel(const int* __restrict__ nbrs, const T* __restrict__ vals,
                const T* __restrict__ self_vals, T* __restrict__ out,
                long long n, long long D) {
  using A = typename Acc<T>::type;
  const int lane = threadIdx.x & 31;
  const long long warp0 = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarps;
  const T neg = T(-(1 << 30));
  for (long long v = warp0; v < n; v += stride) {
    const int* row = nbrs + v * D;
    if constexpr (OP == SUM && std::is_floating_point<T>::value) {
      // column order: every lane adds the chunk's 32 values in j order
      A sum = A(0);
      for (long long j0 = 0; j0 < D; j0 += 32) {
        const long long j = j0 + lane;
        A x = A(0);
        if (j < D) {
          const int id = row[j];
          const long long r = (long long)id < n ? ext_row(id, n) : -1;
          if (r >= 0) x = (A)vals[r];
        }
        const int m = D - j0 < 32 ? (int)(D - j0) : 32;
        for (int s = 0; s < m; ++s) sum += __shfl_sync(0xffffffffu, x, s);
      }
      if (lane == 0) out[v] = (T)sum;
      continue;
    }
    const T mine = self_vals[v];
    unsigned cnt = 0;  // neighbours (count ops: matching neighbours)
    A sum = A(0);
    T mx = neg;
    bool pad = false, any = false, first = true;
    for (long long j = lane; j < D; j += 32) {
      const int id = row[j];
      const bool valid = (long long)id < n;
      if (!valid) {
        pad = true;
        continue;
      }
      const long long r = ext_row(id, n);
      const T x = r >= 0 ? vals[r] : T(0);
      if (OP == COUNT_GE) cnt += x >= mine;
      if (OP == COUNT_GT) cnt += x > mine;
      if (OP == SUM) sum += (A)x;
      if (OP == MAX) {
        mx = first ? x : max_nan(mx, x);
        first = false;
        any = true;
      }
    }
    if (OP == MAX) {
      // fold the lanes: a lane with neither a neighbour nor a pad entry
      // holds nothing; the sentinel joins wherever the row has a pad entry
      bool has = any;
      for (int o = 16; o > 0; o >>= 1) {
        const T m2 = __shfl_xor_sync(0xffffffffu, mx, o);
        const bool h2 = __shfl_xor_sync(0xffffffffu, (int)has, o);
        mx = !has ? m2 : !h2 ? mx : max_nan(mx, m2);
        has = has || h2;
      }
      const bool row_pad = __any_sync(0xffffffffu, pad);
      if (lane == 0) {
        T res = T(0);
        if (has) res = row_pad ? max_nan(mx, neg) : mx;
        out[v] = res;
      }
    } else if (OP == SUM) {
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) out[v] = (T)sum;
    } else {
      for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
      if (lane == 0) out[v] = (T)(A)cnt;
    }
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

template <typename T>
int launch_stat(const void* nbrs, const void* vals, const void* self_vals,
                void* out, long long n, long long D, int op, cudaStream_t st) {
  auto nb = (const int*)nbrs;
  auto va = (const T*)vals;
  auto sv = (const T*)self_vals;
  auto o = (T*)out;
  const unsigned g = blocks_for(n);
  switch (op) {
    case COUNT_GE: ell_stat_kernel<T, COUNT_GE><<<g, kThreads, 0, st>>>(nb, va, sv, o, n, D); break;
    case COUNT_GT: ell_stat_kernel<T, COUNT_GT><<<g, kThreads, 0, st>>>(nb, va, sv, o, n, D); break;
    case SUM: ell_stat_kernel<T, SUM><<<g, kThreads, 0, st>>>(nb, va, sv, o, n, D); break;
    case MAX: ell_stat_kernel<T, MAX><<<g, kThreads, 0, st>>>(nb, va, sv, o, n, D); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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

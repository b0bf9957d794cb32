// Hopper (sm_90a) kernels for the core-maintenance round statistics.
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/coremaint.py:
//   coo_stat (_stat_kernel)                     -> stat_kernel<STAT>
//   fused_removal_round (_removal_kernel)       -> removal_round_kernel
//                                                  + removal_decide_kernel
//   fused_promotion_stats (_promotion_kernel)   -> stat_kernel<HI_DOUT>
//                                                  + promotion_decide_kernel
//   coo_stat(stat="wsum") (_wsum_kernel)        -> wsum_kernel
//
// Design of stat_kernel. The work is edge-parallel: one thread per slot of
// the COO window reads src, dst and valid (coalesced), gathers
// core/label/aux of both endpoints (random reads), evaluates the same
// predicates as the Pallas kernel's _edge_columns, and adds each nonzero
// indicator into the packed int32 output out[n, C] with atomicAdd. Integer
// sums are exact in any order, so the result is bit-identical to the
// reference. The TPU's one-hot matmuls and its (n/BN, E/BE) grid with
// whole vertex vectors in VMEM are not carried over: Hopper has no use for
// a dense one-hot and no in-order grid.
//
// Design of wsum_kernel and removal_round_kernel (the two hottest edge
// passes). from_graph lays the slots out in CSR order, sorted by src, so a
// high-degree vertex owns a long run of consecutive slots with one src.
// One atomicAdd a slot on the src side sends a whole run to one address,
// where the atomics serialise at L2. So each thread takes kSlots
// consecutive slots, loaded as one 128-bit word per int32 column and one
// 32-bit word of valid bytes (scalar loads for the window's ragged tail and
// for a base pointer that is not aligned), folds its own slots that share a
// src, and a segmented scan over the warp's lanes by shuffles, keyed by the
// raw src, joins the runs across lanes (warp_segmented_add): a run costs
// one atomic per nonzero column per warp it touches instead of one per
// slot. The dst side stays one atomic per slot and nonzero column: within
// a run dst ascends, so those atomics spread over the vertex range. Any
// grouping of equal keys gives the same integer sums, so the results stay
// bit for bit those of the plain version on any slot order; sortedness
// decides only the speed.
//
// The fused decision. The TPU kernels decide on the last edge block,
// which works only because the TPU grid runs in order. Here blocks finish
// in any order, so the per-vertex decision runs as a second tiny launch
// on the same stream, after every edge has contributed.
//
// Bound. Bytes: each slot's src, dst (4 B each) and valid (1 B), the
// vertex state read once and the output written once. In practice the
// random endpoint gathers and the dst-side atomics over the vertex range
// limit it, and for stat_kernel the src-side atomics on high-degree (hub)
// vertices of power-law graphs too.
//
// wsum. The weighted h-index bisection's inner pass: each live slot adds its
// int32 weight to an endpoint whose OTHER endpoint's core clears the
// endpoint's own int32 threshold (the bisection's mid). The thresholds are
// integers, not a mask, and the contribution is the weight, not 1, so it
// has its own kernel and C entry point, as the TPU kernel has its own body.
// Bytes: valid (1 B a slot), src, dst and w (12 B a live slot), core,
// thresh and the output (4 B a vertex each).
//
// Out-of-range endpoints follow jnp.take(fill_value=0) in the reference:
// an index in [-n, 0) wraps once, anything else outside [0, n) reads 0;
// the scatter to an endpoint outside [0, n) is dropped (runs are keyed by
// the raw index, so a run of such an endpoint is dropped whole).
//
// C interface for ctypes: every function returns cudaGetLastError() of
// its launch(es); the caller raises when it is not 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Stat { MCD_HI_DOUT = 0, HI_DOUT = 1, MCD = 2, DIN = 3, SAME_IN = 4 };

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 64;
constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kSlots = 4;  // consecutive slots a thread of the run-folding
                           // kernels takes: one 128-bit load per column

template <int STAT>
struct Cols {
  static constexpr int value = STAT == MCD_HI_DOUT ? 3 : STAT == HI_DOUT ? 2 : 1;
};

__device__ __forceinline__ long long wrap(int i, long long n) {
  // jnp.take index normalisation: one wrap for negative indices
  return i < 0 ? (long long)i + n : (long long)i;
}

template <typename T>
__device__ __forceinline__ T take0(const T* __restrict__ x, long long i,
                                   long long n) {
  return (i >= 0 && i < n) ? x[i] : T(0);
}

__device__ __forceinline__ void add_if(int* p, bool c) {
  if (c) atomicAdd(p, 1);
}

template <int STAT>
__global__ void __launch_bounds__(kThreads)
stat_kernel(const int* __restrict__ src, const int* __restrict__ dst,
            const uint8_t* __restrict__ valid, const int* __restrict__ core,
            const long long* __restrict__ label,
            const uint8_t* __restrict__ aux, int* __restrict__ out,
            long long E, long long n) {
  constexpr int C = Cols<STAT>::value;
  constexpr bool kLabel = STAT == MCD_HI_DOUT || STAT == HI_DOUT || STAT == DIN;
  constexpr bool kAux = STAT == DIN || STAT == SAME_IN;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < E;
       e += stride) {
    if (!valid[e]) continue;  // every column is gated by valid
    const int s = src[e];
    const int d = dst[e];
    const long long sg = wrap(s, n);
    const long long dg = wrap(d, n);
    const int cs = take0(core, sg, n);
    const int cd = take0(core, dg, n);
    long long ls = 0, ld = 0;
    if (kLabel) {
      ls = take0(label, sg, n);
      ld = take0(label, dg, n);
    }
    bool as = false, ad = false;
    if (kAux) {
      as = take0(aux, sg, n) != 0;
      ad = take0(aux, dg, n) != 0;
    }
    const bool same = cs == cd;
    const bool s_ok = s >= 0 && (long long)s < n;
    const bool d_ok = d >= 0 && (long long)d < n;
    int* os = out + (long long)s * C;
    int* od = out + (long long)d * C;
    if (STAT == MCD_HI_DOUT) {
      if (s_ok) {
        add_if(os + 0, cd >= cs);
        add_if(os + 1, cd > cs);
        add_if(os + 2, same && ld > ls);
      }
      if (d_ok) {
        add_if(od + 0, cs >= cd);
        add_if(od + 1, cs > cd);
        add_if(od + 2, same && ls > ld);
      }
    } else if (STAT == HI_DOUT) {
      if (s_ok) {
        add_if(os + 0, cd > cs);
        add_if(os + 1, same && ld > ls);
      }
      if (d_ok) {
        add_if(od + 0, cs > cd);
        add_if(od + 1, same && ls > ld);
      }
    } else if (STAT == MCD) {
      if (s_ok) add_if(os, cd >= cs);
      if (d_ok) add_if(od, cs >= cd);
    } else if (STAT == DIN) {
      if (s_ok) add_if(os, same && ld < ls && ad);
      if (d_ok) add_if(od, same && ls < ld && as);
    } else {  // SAME_IN
      if (s_ok) add_if(os, same && ad);
      if (d_ok) add_if(od, same && as);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
removal_decide_kernel(const int* __restrict__ stats3,
                      const int* __restrict__ core, int* __restrict__ new_core,
                      uint8_t* __restrict__ drop, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n;
       v += stride) {
    const int c = core[v];
    const bool dr = stats3[v * 3] < c && c > 0;
    drop[v] = dr;
    new_core[v] = c - (int)dr;
  }
}

__global__ void __launch_bounds__(kThreads)
promotion_decide_kernel(const int* __restrict__ stats2,
                        const int* __restrict__ core,
                        uint8_t* __restrict__ viol, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n;
       v += stride) {
    viol[v] = stats2[v * 2] + stats2[v * 2 + 1] > core[v];
  }
}

// A thread's kSlots consecutive slots [e0, e0 + kSlots) of an int32
// column: one 128-bit load when the column's base is 16-byte aligned
// (`vec`) and the group lies inside the window, else one scalar load a
// slot; a slot past the window reads 0.
__device__ __forceinline__ void load_slots(const int* __restrict__ p,
                                           long long e0, long long E,
                                           bool vec, int (&x)[kSlots]) {
  if (vec && e0 + kSlots <= E) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p + e0));
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) x[j] = e0 + j < E ? p[e0 + j] : 0;
  }
}

// The same for the valid bytes: one 32-bit word when aligned; a slot past
// the window is dead.
__device__ __forceinline__ void load_slots(const uint8_t* __restrict__ p,
                                           long long e0, long long E,
                                           bool vec, bool (&x)[kSlots]) {
  if (vec && e0 + kSlots <= E) {
    const unsigned q = __ldg(reinterpret_cast<const unsigned*>(p + e0));
#pragma unroll
    for (int j = 0; j < kSlots; ++j) x[j] = ((q >> (8 * j)) & 0xffu) != 0;
  } else {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) x[j] = e0 + j < E && p[e0 + j] != 0;
  }
}

// One run's column sums into out[key, :], one atomic per nonzero column;
// a key outside [0, n) is dropped.
template <int C>
__device__ __forceinline__ void add_run(int* __restrict__ out, int key,
                                        const int (&v)[C], long long n) {
  if (key < 0 || (long long)key >= n) return;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (v[c] != 0) atomicAdd(out + (long long)key * C + c, v[c]);
}

// Adds val[j][c] into out[key[j] * C + c] for a warp's 32 x kSlots
// consecutive slots, one atomic per nonzero column per maximal run of
// equal keys (keys outside [0, n) dropped). Every lane of the warp calls
// it with its own kSlots consecutive slots, lane i after lane i - 1.
//   1. A lane folds its own slots: its first run (head) and its last run
//      (tail) may continue into the neighbouring lanes; a run between them
//      is complete and is added at once.
//   2. Lane i's tail continues lane i-1's when lane i is one run whose key
//      is lane i-1's tail key (chain). The joined tail sums carry_i =
//      tail_i + (chain_i ? carry_{i-1} : 0) are an inclusive scan of the
//      affine maps (tail_i, chain_i), five shuffle steps.
//   3. A lane of more than one run adds its head, joined with the carry of
//      lane i-1 when the keys link; a lane adds its joined tail unless
//      lane i+1 links to it.
template <int C>
__device__ __forceinline__ void warp_segmented_add(
    const int (&key)[kSlots], const int (&val)[kSlots][C],
    int* __restrict__ out, long long n) {
  const int lane = threadIdx.x & (kWarp - 1);
  int head[C], tail[C];
  bool single = true;
#pragma unroll
  for (int c = 0; c < C; ++c) head[c] = tail[c] = val[0][c];
#pragma unroll
  for (int j = 1; j < kSlots; ++j) {
    if (key[j] != key[j - 1]) {
      if (single) {
#pragma unroll
        for (int c = 0; c < C; ++c) head[c] = tail[c];
      } else {
        add_run<C>(out, key[j - 1], tail, n);
      }
      single = false;
#pragma unroll
      for (int c = 0; c < C; ++c) tail[c] = val[j][c];
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) tail[c] += val[j][c];
    }
  }
  const int first = key[0], last = key[kSlots - 1];
  const int prev_last = __shfl_up_sync(kFullMask, last, 1);
  const bool link = lane > 0 && first == prev_last;
  const bool next_link =
      __shfl_down_sync(kFullMask, (int)link, 1) != 0 && lane < kWarp - 1;
  int carry[C];
#pragma unroll
  for (int c = 0; c < C; ++c) carry[c] = tail[c];
  bool chain = single && link;
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    int up[C];
#pragma unroll
    for (int c = 0; c < C; ++c) up[c] = __shfl_up_sync(kFullMask, carry[c], d);
    const bool up_chain = __shfl_up_sync(kFullMask, (int)chain, d) != 0;
    if (lane >= d) {
      if (chain) {
#pragma unroll
        for (int c = 0; c < C; ++c) carry[c] += up[c];
      }
      chain = chain && up_chain;
    }
  }
  int before[C];
#pragma unroll
  for (int c = 0; c < C; ++c) before[c] = __shfl_up_sync(kFullMask, carry[c], 1);
  if (!single) {
    if (link) {
#pragma unroll
      for (int c = 0; c < C; ++c) head[c] += before[c];
    }
    add_run<C>(out, first, head, n);
  }
  if (!next_link) add_run<C>(out, last, carry, n);
}

// The warp tiles of the run-folding kernels: a warp takes 32 x kSlots
// consecutive slots at a time, grid-strided. The tile's first slot is the
// same for every lane of a warp, so all 32 stay in the loop together and
// reach the shuffles.
__device__ __forceinline__ long long warp_tile_start() {
  return ((long long)blockIdx.x * kThreads + (threadIdx.x & ~(kWarp - 1))) *
         kSlots;
}

__device__ __forceinline__ long long warp_tile_stride() {
  return (long long)gridDim.x * kThreads * kSlots;
}

__device__ __forceinline__ long long lane_slot() {
  return (long long)(threadIdx.x & (kWarp - 1)) * kSlots;
}

__global__ void __launch_bounds__(kThreads)
wsum_kernel(const int* __restrict__ src, const int* __restrict__ dst,
            const uint8_t* __restrict__ valid, const int* __restrict__ w,
            const int* __restrict__ core, const int* __restrict__ thresh,
            int* __restrict__ out, long long E, long long n, bool vec) {
  for (long long t = warp_tile_start(); t < E; t += warp_tile_stride()) {
    const long long e0 = t + lane_slot();
    int s[kSlots], d[kSlots], wt[kSlots];
    bool live[kSlots];
    load_slots(src, e0, E, vec, s);
    load_slots(dst, e0, E, vec, d);
    load_slots(w, e0, E, vec, wt);
    load_slots(valid, e0, E, vec, live);
    int to_src[kSlots][1];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      to_src[j][0] = 0;
      if (!live[j] || wt[j] == 0) continue;  // adds 0: no atomic
      const long long sg = wrap(s[j], n);
      const long long dg = wrap(d[j], n);
      if (take0(core, dg, n) >= take0(thresh, sg, n)) to_src[j][0] = wt[j];
      if (d[j] >= 0 && (long long)d[j] < n &&
          take0(core, sg, n) >= take0(thresh, dg, n))
        atomicAdd(out + d[j], wt[j]);
    }
    warp_segmented_add<1>(s, to_src, out, n);
  }
}

// fused_removal_round's edge pass: stat_kernel<MCD_HI_DOUT>'s predicates
// with the src-side columns folded by runs.
__global__ void __launch_bounds__(kThreads)
removal_round_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                     const uint8_t* __restrict__ valid,
                     const int* __restrict__ core,
                     const long long* __restrict__ label,
                     int* __restrict__ out, long long E, long long n,
                     bool vec) {
  for (long long t = warp_tile_start(); t < E; t += warp_tile_stride()) {
    const long long e0 = t + lane_slot();
    int s[kSlots], d[kSlots];
    bool live[kSlots];
    load_slots(src, e0, E, vec, s);
    load_slots(dst, e0, E, vec, d);
    load_slots(valid, e0, E, vec, live);
    int to_src[kSlots][3];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      to_src[j][0] = to_src[j][1] = to_src[j][2] = 0;
      if (!live[j]) continue;
      const long long sg = wrap(s[j], n);
      const long long dg = wrap(d[j], n);
      const int cs = take0(core, sg, n);
      const int cd = take0(core, dg, n);
      const long long ls = take0(label, sg, n);
      const long long ld = take0(label, dg, n);
      const bool same = cs == cd;
      to_src[j][0] = cd >= cs;
      to_src[j][1] = cd > cs;
      to_src[j][2] = same && ld > ls;
      if (d[j] >= 0 && (long long)d[j] < n) {
        int* od = out + (long long)d[j] * 3;
        add_if(od + 0, cs >= cd);
        add_if(od + 1, cs > cd);
        add_if(od + 2, same && ls > ld);
      }
    }
    warp_segmented_add<3>(s, to_src, out, n);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

// blocks of kThreads threads for `work` threads' worth, at most kMaxBlocks
// (the kernels loop over the rest)
unsigned blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return (unsigned)(b < 1 ? 1 : b);
}

template <int STAT>
void launch_stat(const int* src, const int* dst, const uint8_t* valid,
                 const int* core, const long long* label, const uint8_t* aux,
                 int* out, long long E, long long n, cudaStream_t stream) {
  stat_kernel<STAT><<<blocks_for(E), kThreads, 0, stream>>>(
      src, dst, valid, core, label, aux, out, E, n);
}

}  // namespace

extern "C" {

// out must be zeroed [n, C] int32; label may be null for mcd and same_in,
// aux may be null unless stat is din or same_in.
int coremaint_stat(const void* src, const void* dst, const void* valid,
                   const void* core, const void* label, const void* aux,
                   void* out, long long E, long long n, int stat,
                   void* stream) {
  auto s = (const int*)src;
  auto d = (const int*)dst;
  auto v = (const uint8_t*)valid;
  auto c = (const int*)core;
  auto l = (const long long*)label;
  auto a = (const uint8_t*)aux;
  auto o = (int*)out;
  auto st = (cudaStream_t)stream;
  switch (stat) {
    case MCD_HI_DOUT: launch_stat<MCD_HI_DOUT>(s, d, v, c, l, a, o, E, n, st); break;
    case HI_DOUT: launch_stat<HI_DOUT>(s, d, v, c, l, a, o, E, n, st); break;
    case MCD: launch_stat<MCD>(s, d, v, c, l, a, o, E, n, st); break;
    case DIN: launch_stat<DIN>(s, d, v, c, l, a, o, E, n, st); break;
    case SAME_IN: launch_stat<SAME_IN>(s, d, v, c, l, a, o, E, n, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out must be zeroed [n] int32; every pointer is required.
int coremaint_wsum(const void* src, const void* dst, const void* valid,
                   const void* w, const void* core, const void* thresh,
                   void* out, long long E, long long n, void* stream) {
  const bool vec = aligned(src, 16) && aligned(dst, 16) && aligned(w, 16) &&
                   aligned(valid, 4);
  wsum_kernel<<<blocks_for((E + kSlots - 1) / kSlots), kThreads, 0,
                (cudaStream_t)stream>>>(
      (const int*)src, (const int*)dst, (const uint8_t*)valid, (const int*)w,
      (const int*)core, (const int*)thresh, (int*)out, E, n, vec);
  return (int)cudaGetLastError();
}

// fused_removal_round's edge pass: out must be zeroed [n, 3] int32 (mcd,
// hi, dout_same); every pointer is required.
int coremaint_removal_stats(const void* src, const void* dst,
                            const void* valid, const void* core,
                            const void* label, void* out, long long E,
                            long long n, void* stream) {
  const bool vec = aligned(src, 16) && aligned(dst, 16) && aligned(valid, 4);
  removal_round_kernel<<<blocks_for((E + kSlots - 1) / kSlots), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int*)src, (const int*)dst, (const uint8_t*)valid,
      (const int*)core, (const long long*)label, (int*)out, E, n, vec);
  return (int)cudaGetLastError();
}

int coremaint_removal_decide(const void* stats3, const void* core,
                             void* new_core, void* drop, long long n,
                             void* stream) {
  removal_decide_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)stats3, (const int*)core, (int*)new_core, (uint8_t*)drop, n);
  return (int)cudaGetLastError();
}

int coremaint_promotion_decide(const void* stats2, const void* core,
                               void* viol, long long n, void* stream) {
  promotion_decide_kernel<<<blocks_for(n), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const int*)stats2, (const int*)core, (uint8_t*)viol, n);
  return (int)cudaGetLastError();
}

}  // extern "C"

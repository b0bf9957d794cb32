// Hopper (sm_90a) kernels for the core-maintenance round statistics.
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/coremaint.py:
//   coo_stat (_stat_kernel)                     -> unit_stat_kernel<STAT>
//                                                  (din, same_in: after
//                                                  pack_mask_kernel;
//                                                  mcd_hi_dout:
//                                                  removal_round_kernel)
//   fused_removal_round (_removal_kernel)       -> removal_round_kernel
//                                                  + removal_decide_kernel
//   fused_promotion_stats (_promotion_kernel)   -> unit_stat_kernel<HI_DOUT>
//                                                  + promotion_decide_kernel
//   coo_stat(stat="wsum") (_wsum_kernel)        -> wsum_kernel
//
// The work is edge-parallel: every edge pass reads the COO window's src,
// dst and valid columns, gathers endpoint state (core, label, aux or the
// wsum threshold; random reads), evaluates the same predicates as the
// Pallas kernel's _edge_columns, and adds each nonzero indicator into the
// packed int32 output out[n, C] with atomicAdd. Integer sums are exact in
// any order, so the result is bit-identical to the reference. The TPU's
// one-hot matmuls and its (n/BN, E/BE) grid with whole vertex vectors in
// VMEM are not carried over: Hopper has no use for a dense one-hot and no
// in-order grid.
//
// Run folding (every edge pass). from_graph lays the slots out in CSR
// order, sorted by src, so a high-degree vertex owns a long run of
// consecutive slots with one src. One atomicAdd a slot on the src side
// sends a whole run to one address, where the atomics serialise at L2. So
// each thread takes kSlots consecutive slots, loaded as one 128-bit word
// per int32 column and one 32-bit word of valid bytes (scalar loads for
// the window's ragged tail and for a base pointer that is not aligned),
// folds its own slots that share a src, and a segmented scan over the
// warp's lanes by shuffles, keyed by the raw src, joins the runs across
// lanes (warp_segmented_add): a run costs one atomic per nonzero column
// per warp it touches instead of one per slot. The dst side stays one
// atomic per slot and nonzero column: within a run dst ascends, so those
// atomics spread over the vertex range. Any grouping of equal keys gives
// the same integer sums, so the results stay bit for bit those of the
// plain version on any slot order; sortedness decides only the speed.
//
// Lazy gathers (unit_stat_kernel). With the src side folded, what is left
// is the random L2 operations of each live slot: its dst-side gathers and
// atomics. The unit stats read only what their predicates need, the
// cheapest test first. din and same_in are gated by a per-vertex mask
// (rp, the candidate mask): they read the mask bit of s and of d first,
// and a slot with neither endpoint in the mask adds nothing, so it reads
// no core and no label. The mask is packed first into a bit vector of
// n / 8 bytes (pack_mask_kernel, one ballot a warp, a second launch a
// call), which stays in cache where the n-byte mask did not: on the main
// path's masks the packed gathers took 18-21% off both stats (paired, on
// one H100 SXM). Every stat reads the labels only for a same-core slot,
// and mcd none. The src endpoint's state is read once along a thread's
// run of one src. A warp whose slots all add nothing on the src side
// skips the scan.
//
// The fused decision. The TPU kernels decide on the last edge block,
// which works only because the TPU grid runs in order. Here blocks finish
// in any order, so the per-vertex decision runs as a second tiny launch
// on the same stream, after every edge has contributed.
//
// Bound. Bytes: each slot's src, dst (4 B each) and valid (1 B), the
// vertex state read once and the output written once. In practice the
// random endpoint gathers and the dst-side atomics over the vertex range
// limit it: all seven edge passes fit one rate of random L2 operations.
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

// packed output columns of a unit stat (mcd_hi_dout, 3, is
// removal_round_kernel's)
template <int STAT>
struct Cols {
  static constexpr int value = STAT == HI_DOUT ? 2 : 1;
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

// bit i of a mask packed 32 vertices a word; an index outside [0, n)
// reads 0
__device__ __forceinline__ bool take_bit(const unsigned* __restrict__ bits,
                                         long long i, long long n) {
  return (i >= 0 && i < n) && ((__ldg(bits + (i >> 5)) >> (i & 31)) & 1u);
}

__device__ __forceinline__ void add_if(int* p, bool c) {
  if (c) atomicAdd(p, 1);
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

// fused_removal_round's edge pass, and coo_stat's mcd_hi_dout: the three
// columns of the Pallas _edge_columns, the src side folded by runs.
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

// The src endpoint's state along a thread's run of one src: each field is
// gathered on first use and kept until the src changes.
struct SrcState {
  int key;
  long long g;  // the wrapped gather index
  bool has_core, has_label, has_aux;
  int core;
  long long label;
  bool aux;

  __device__ __forceinline__ void at(int s, long long n) {
    key = s;
    g = wrap(s, n);
    has_core = has_label = has_aux = false;
  }
  __device__ __forceinline__ int get_core(const int* __restrict__ x,
                                          long long n) {
    if (!has_core) core = take0(x, g, n);
    has_core = true;
    return core;
  }
  __device__ __forceinline__ long long get_label(
      const long long* __restrict__ x, long long n) {
    if (!has_label) label = take0(x, g, n);
    has_label = true;
    return label;
  }
  __device__ __forceinline__ bool get_aux(const unsigned* __restrict__ x,
                                          long long n) {
    if (!has_aux) aux = take_bit(x, g, n);
    has_aux = true;
    return aux;
  }
};

// coo_stat's unit stats hi_dout, mcd, din and same_in (and
// fused_promotion_stats' edge pass, hi_dout): removal_round_kernel's warp
// tiles and run folding, with the endpoint state gathered lazily, the
// cheapest test first (see the top of this file). The predicates are the
// Pallas _edge_columns':
//   hi_dout  to_src (cd > cs, same && ld > ls), to_dst (cs > cd, same && ls > ld)
//   mcd      to_src cd >= cs,                   to_dst cs >= cd
//   din      to_src same && ld < ls && aux[d],  to_dst same && ls < ld && aux[s]
//   same_in  to_src same && aux[d],             to_dst same && aux[s]
// with same = cs == cd, every column gated by valid.
template <int STAT>
__global__ void __launch_bounds__(kThreads)
unit_stat_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                 const uint8_t* __restrict__ valid,
                 const int* __restrict__ core,
                 const long long* __restrict__ label,
                 const unsigned* __restrict__ aux, int* __restrict__ out,
                 long long E, long long n, bool vec) {
  constexpr int C = Cols<STAT>::value;
  static_assert(STAT != MCD_HI_DOUT, "mcd_hi_dout is removal_round_kernel");
  for (long long t = warp_tile_start(); t < E; t += warp_tile_stride()) {
    const long long e0 = t + lane_slot();
    int s[kSlots], d[kSlots];
    bool live[kSlots];
    load_slots(src, e0, E, vec, s);
    load_slots(dst, e0, E, vec, d);
    load_slots(valid, e0, E, vec, live);
    int to_src[kSlots][C];
    bool adds_src = false;  // any nonzero src-side column in this thread
    SrcState sv;
    sv.at(s[0], n);
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
#pragma unroll
      for (int c = 0; c < C; ++c) to_src[j][c] = 0;
      if (!live[j]) continue;
      if (s[j] != sv.key) sv.at(s[j], n);
      const long long dg = wrap(d[j], n);
      int to_dst[C];
#pragma unroll
      for (int c = 0; c < C; ++c) to_dst[c] = 0;
      if (STAT == DIN || STAT == SAME_IN) {
        const bool ad = take_bit(aux, dg, n);
        const bool as = sv.get_aux(aux, n);
        if (!as && !ad) continue;  // neither column can be set
        if (sv.get_core(core, n) != take0(core, dg, n)) continue;
        if (STAT == SAME_IN) {
          to_src[j][0] = ad;
          to_dst[0] = as;
        } else {
          const long long ls = sv.get_label(label, n);
          const long long ld = take0(label, dg, n);
          to_src[j][0] = ad && ld < ls;
          to_dst[0] = as && ls < ld;
        }
      } else {
        const int cs = sv.get_core(core, n);
        const int cd = take0(core, dg, n);
        if (STAT == MCD) {
          to_src[j][0] = cd >= cs;
          to_dst[0] = cs >= cd;
        } else {  // HI_DOUT
          to_src[j][0] = cd > cs;
          to_dst[0] = cs > cd;
          if (cs == cd) {
            const long long ls = sv.get_label(label, n);
            const long long ld = take0(label, dg, n);
            to_src[j][1] = ld > ls;
            to_dst[1] = ls > ld;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) adds_src = adds_src || to_src[j][c] != 0;
      if (d[j] >= 0 && (long long)d[j] < n) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          add_if(out + (long long)d[j] * C + c, to_dst[c] != 0);
      }
    }
    // warp-uniform: every lane of the warp takes the scan or none does
    if (__any_sync(kFullMask, adds_src)) warp_segmented_add<C>(s, to_src, out, n);
  }
}

// mask bytes -> bits, 32 vertices a word, one ballot a warp; the loop
// bound is a multiple of the warp, so every lane reaches the ballot
__global__ void __launch_bounds__(kThreads)
pack_mask_kernel(const uint8_t* __restrict__ mask, unsigned* __restrict__ bits,
                 long long n) {
  const long long n32 = (n + kWarp - 1) / kWarp * kWarp;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n32;
       i += stride) {
    const unsigned w = __ballot_sync(kFullMask, i < n && mask[i] != 0);
    if ((threadIdx.x & (kWarp - 1)) == 0) bits[i >> 5] = w;
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

// blocks for an edge pass over E slots, kSlots a thread
unsigned slot_blocks(long long E) {
  return blocks_for((E + kSlots - 1) / kSlots);
}

template <int STAT>
void launch_unit_stat(const int* src, const int* dst, const uint8_t* valid,
                      const int* core, const long long* label,
                      const unsigned* aux, int* out, long long E, long long n,
                      bool vec, cudaStream_t stream) {
  unit_stat_kernel<STAT><<<slot_blocks(E), kThreads, 0, stream>>>(
      src, dst, valid, core, label, aux, out, E, n, vec);
}

}  // namespace

extern "C" {

// out must be zeroed [n, C] int32; label may be null for mcd and same_in,
// aux and bits ((n + 31) / 32 words of scratch) may be null unless stat is
// din or same_in, which pack aux into bits first. mcd_hi_dout (C = 3) is
// fused_removal_round's edge pass, removal_round_kernel.
int coremaint_stat(const void* src, const void* dst, const void* valid,
                   const void* core, const void* label, const void* aux,
                   void* bits, void* out, long long E, long long n, int stat,
                   void* stream) {
  auto s = (const int*)src;
  auto d = (const int*)dst;
  auto v = (const uint8_t*)valid;
  auto c = (const int*)core;
  auto l = (const long long*)label;
  auto a = (const unsigned*)bits;
  auto o = (int*)out;
  auto st = (cudaStream_t)stream;
  const bool vec = aligned(src, 16) && aligned(dst, 16) && aligned(valid, 4);
  if (stat == DIN || stat == SAME_IN)
    pack_mask_kernel<<<blocks_for(n), kThreads, 0, st>>>(
        (const uint8_t*)aux, (unsigned*)bits, n);
  switch (stat) {
    case MCD_HI_DOUT:
      removal_round_kernel<<<slot_blocks(E), kThreads, 0, st>>>(s, d, v, c, l, o, E, n, vec);
      break;
    case HI_DOUT: launch_unit_stat<HI_DOUT>(s, d, v, c, l, a, o, E, n, vec, st); break;
    case MCD: launch_unit_stat<MCD>(s, d, v, c, l, a, o, E, n, vec, st); break;
    case DIN: launch_unit_stat<DIN>(s, d, v, c, l, a, o, E, n, vec, st); break;
    case SAME_IN: launch_unit_stat<SAME_IN>(s, d, v, c, l, a, o, E, n, vec, st); break;
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
  wsum_kernel<<<slot_blocks(E), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)src, (const int*)dst, (const uint8_t*)valid, (const int*)w,
      (const int*)core, (const int*)thresh, (int*)out, E, n, vec);
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

// Hopper (sm_90a) kernels for the core-maintenance round statistics.
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/coremaint.py:
//   coo_stat (_stat_kernel)                     -> stat_kernel<STAT>
//   fused_removal_round (_removal_kernel)       -> stat_kernel<MCD_HI_DOUT>
//                                                  + removal_decide_kernel
//   fused_promotion_stats (_promotion_kernel)   -> stat_kernel<HI_DOUT>
//                                                  + promotion_decide_kernel
//   coo_stat(stat="wsum") (_wsum_kernel)        -> wsum_kernel
//
// Design. The work is edge-parallel: one thread per slot of the COO window
// reads src, dst and valid (coalesced), gathers core/label/aux of both
// endpoints (random reads), evaluates the same predicates as the Pallas
// kernel's _edge_columns, and adds each nonzero indicator into the packed
// int32 output out[n, C] with atomicAdd. Integer sums are exact in any
// order, so the result is bit-identical to the reference. The TPU's
// one-hot matmuls and its (n/BN, E/BE) grid with whole vertex vectors in
// VMEM are not carried over: Hopper has no use for a dense one-hot and no
// in-order grid.
//
// The fused decision. The TPU kernels decide on the last edge block,
// which works only because the TPU grid runs in order. Here blocks finish
// in any order, so the per-vertex decision runs as a second tiny launch
// on the same stream, after every edge has contributed.
//
// Bound. Bytes: each slot's src, dst (4 B each) and valid (1 B), the
// vertex state read once and the output written once. In practice the
// random endpoint gathers and the atomics on high-degree (hub) vertices
// of power-law graphs limit it; making that fast is later work.
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
// the scatter to an endpoint outside [0, n) is dropped.
//
// C interface for ctypes: every function returns cudaGetLastError() of
// its launch(es); the caller raises when it is not 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Stat { MCD_HI_DOUT = 0, HI_DOUT = 1, MCD = 2, DIN = 3, SAME_IN = 4 };

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 64;

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

__global__ void __launch_bounds__(kThreads)
wsum_kernel(const int* __restrict__ src, const int* __restrict__ dst,
            const uint8_t* __restrict__ valid, const int* __restrict__ w,
            const int* __restrict__ core, const int* __restrict__ thresh,
            int* __restrict__ out, long long E, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < E;
       e += stride) {
    if (!valid[e]) continue;
    const int wt = w[e];
    if (wt == 0) continue;  // a zero contribution issues no atomic
    const int s = src[e];
    const int d = dst[e];
    const long long sg = wrap(s, n);
    const long long dg = wrap(d, n);
    if (s >= 0 && (long long)s < n &&
        take0(core, dg, n) >= take0(thresh, sg, n))
      atomicAdd(out + s, wt);
    if (d >= 0 && (long long)d < n &&
        take0(core, sg, n) >= take0(thresh, dg, n))
      atomicAdd(out + d, wt);
  }
}

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
  wsum_kernel<<<blocks_for(E), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)src, (const int*)dst, (const uint8_t*)valid, (const int*)w,
      (const int*)core, (const int*)thresh, (int*)out, E, n);
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

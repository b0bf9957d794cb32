// Hopper (sm_90a) kernels for label placement's level reductions
// (core/order.py place_block, through kernels/order.py place_levels).
//
// Replaces no Pallas kernel: the reference computes these reductions with
// jnp's segment_min / segment_max and a segment sum, which the port's plain
// path runs as three scatter_reduce_ and one index_add_ over all n vertices
// into n_levels = n + 2 bins. Only kmax + 1 bins are ever hit (771 on the
// benchmark's RMAT graph, 13 on its ER graph), so millions of atomics pile
// onto a few addresses and each call takes milliseconds.
//
// What place_block needs a level for: the least and the greatest label of
// its non-moving members (a member that moves reads as +-2^62, which the
// caller reads as 0), its number of movers, and the rank of its first
// mover in the (level, round_key, label) order of the movers. That order
// puts every mover before every non-mover and the movers level by level,
// so the first rank of a level is the number of movers on the levels below
// it: an exclusive prefix sum of the counts. Min, max and sums of integers
// do not depend on the order they are taken in, so the labels are those of
// the plain path bit for bit, on every run.
//
// Three launches on one stream:
//   level_init_kernel   the global level table to its identities;
//   level_pass_kernel   one read of core, moving and (non-movers only) label:
//                       one block an SM, each with a table of L levels in
//                       dynamic shared memory (20 B a level: min and max
//                       label, mover count; L the most that fit, about 11k,
//                       and never more than n_levels). The lanes of a warp
//                       that share a level fold together first
//                       (__match_any_sync, then redux.sync on each 32-bit
//                       half of the labels), so one lane a level a warp
//                       touches shared memory. Each block then merges its
//                       non-empty levels into the global table with one
//                       native 64-bit atomicMin / atomicMax and one
//                       atomicAdd each. A vertex whose level is L or more
//                       (the spill path) sends its warp's fold straight to
//                       the global table, and is counted in a device-side
//                       tally (order_spill_count), once per block. The last
//                       block to finish turns the counts of levels 0 ..
//                       kmax_movers into their exclusive prefix sum in place;
//   level_assign_kernel one pass over n: a mover takes base_min - GAP *
//                       (count - pos) or base_max + GAP * (pos + 1), with pos
//                       its rank minus its level's first rank; every other
//                       vertex keeps its label. Each label is written once.
//
// No contended global atomics: the global table takes at most one atomic
// per block and level. A level outside [0, n_levels) is dropped, as the
// plain path's spare row drops it; a mover on such a level keeps its label
// (the plain path raises there).
//
// Bound. Bytes: core (4 B), moving (1 B) and label (8 B) read by the level
// pass, moving, label and the output (8 B) by the assign pass (core and rank
// of the movers only), and the level table (20 B a level) written once by
// the init.
//
// C interface for ctypes: each function returns cudaGetLastError() of its
// launches (checked after each one); the caller raises when it is not 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevelThreads = 1024;  // one block an SM: the table fills it
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 64;
constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr long long kGap = 1LL << 20;      // core/order.py LABEL_GAP
constexpr long long kPos = 1LL << 62;      // _POS: every member moves
constexpr long long kNeg = -(1LL << 62);   // _NEG
constexpr long long kI64Max = 0x7fffffffffffffffLL;  // segment_min identity
constexpr long long kI64Min = -kI64Max - 1;          // segment_max identity
constexpr unsigned long long kSign = 1ULL << 63;
constexpr int kLevelBytes = 2 * 8 + 4;     // min, max, count

constexpr int kMaxDevices = 64;
int g_levels_max[kMaxDevices];  // L for an unbounded n_levels; 0: unset
int g_sms[kMaxDevices];

__device__ unsigned long long order_spill_count;

long long blocks_for(long long n, int threads) {
  long long b = (n + threads - 1) / threads;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

__global__ void __launch_bounds__(kThreads)
level_init_kernel(long long* __restrict__ lo, long long* __restrict__ hi,
                  int* __restrict__ cnt, long long n_levels) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       l < n_levels; l += stride) {
    lo[l] = kI64Max;
    hi[l] = kI64Min;
    cnt[l] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    cnt[n_levels] = 0;       // the prefix sum's total
    cnt[n_levels + 1] = -1;  // the highest level holding a mover
    cnt[n_levels + 2] = 0;   // the blocks that finished the level pass
  }
}

// 64-bit min / max over the lanes of ``peers`` (each lane passes its own
// group's mask): redux.sync on the high halves of the order-preserving
// unsigned images, then on the low halves of the lanes that hold the
// extreme high half
__device__ __forceinline__ long long group_min(unsigned peers, long long v) {
  const unsigned long long u = (unsigned long long)v ^ kSign;
  const unsigned h = (unsigned)(u >> 32), l = (unsigned)u;
  const unsigned mh = __reduce_min_sync(peers, h);
  const unsigned ml = __reduce_min_sync(peers, h == mh ? l : 0xffffffffu);
  return (long long)((((unsigned long long)mh << 32) | ml) ^ kSign);
}

__device__ __forceinline__ long long group_max(unsigned peers, long long v) {
  const unsigned long long u = (unsigned long long)v ^ kSign;
  const unsigned h = (unsigned)(u >> 32), l = (unsigned)u;
  const unsigned mh = __reduce_max_sync(peers, h);
  const unsigned ml = __reduce_max_sync(peers, h == mh ? l : 0u);
  return (long long)((((unsigned long long)mh << 32) | ml) ^ kSign);
}

struct Table {
  long long* lo;
  long long* hi;
  int* cnt;
};

// One warp's 32 vertices (``key`` the level, -1 for a dropped lane): fold
// the lanes of each level, then one lane a level updates the block's
// shared table, or the global one on the spill path
__device__ __forceinline__ void fold(int key, bool mv, long long lab,
                                     int lane, Table s, Table g, int L,
                                     int& top, int& mtop, unsigned& spill) {
  const unsigned peers = __match_any_sync(kFullMask, key);
  const unsigned movers = __ballot_sync(kFullMask, mv);
  if (key < 0) return;
  const long long lo = group_min(peers, mv ? kPos : lab);
  const long long hi = group_max(peers, mv ? kNeg : lab);
  if (lane != __ffs(peers) - 1) return;
  const int c = __popc(movers & peers);
  if (c) mtop = max(mtop, key);
  if (key < L) {
    // most folds change nothing: read before the atomic
    if (lo < s.lo[key]) atomicMin(s.lo + key, lo);
    if (hi > s.hi[key]) atomicMax(s.hi + key, hi);
    if (c) atomicAdd(s.cnt + key, c);
    top = max(top, key);
  } else {
    atomicMin(g.lo + key, lo);
    atomicMax(g.hi + key, hi);
    if (c) atomicAdd(g.cnt + key, c);
    spill += __popc(peers);
  }
}

__device__ __forceinline__ void load(const int* __restrict__ core,
                                     const uint8_t* __restrict__ moving,
                                     const long long* __restrict__ label,
                                     long long i, long long n,
                                     long long n_levels, int& key, bool& mv,
                                     long long& lab) {
  key = -1;
  mv = false;
  lab = 0;
  if (i < n) {
    const int lvl = core[i];
    if (lvl >= 0 && lvl < n_levels) {
      key = lvl;
      mv = moving[i] != 0;
      if (!mv) lab = label[i];
    }
  }
}

__global__ void __launch_bounds__(kLevelThreads)
level_pass_kernel(const int* __restrict__ core,
                  const uint8_t* __restrict__ moving,
                  const long long* __restrict__ label, Table g,
                  long long n, long long n_levels, int L) {
  extern __shared__ long long smem[];
  __shared__ int s_top, s_mtop, s_last;
  __shared__ unsigned s_spill;
  __shared__ int s_warp[kLevelThreads / kWarp];
  const Table s{smem, smem + L, (int*)(smem + 2 * L)};
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), warp = tid / kWarp;
  const int warps = blockDim.x / kWarp;
  for (int l = tid; l < L; l += blockDim.x) {
    s.lo[l] = kI64Max;
    s.hi[l] = kI64Min;
    s.cnt[l] = 0;
  }
  if (tid == 0) {
    s_top = -1;
    s_mtop = -1;
    s_spill = 0;
  }
  __syncthreads();

  int top = -1, mtop = -1;
  unsigned spill = 0;
  // each warp takes 32 consecutive vertices, two chunks in flight
  const long long stride = (long long)gridDim.x * warps * kWarp;
  for (long long base = ((long long)blockIdx.x * warps + warp) * kWarp;
       base < n; base += 2 * stride) {
    int ka, kb;
    bool ma, mb;
    long long la, lb;
    load(core, moving, label, base + lane, n, n_levels, ka, ma, la);
    load(core, moving, label, base + stride + lane, n, n_levels, kb, mb, lb);
    fold(ka, ma, la, lane, s, g, L, top, mtop, spill);
    fold(kb, mb, lb, lane, s, g, L, top, mtop, spill);
  }
  top = __reduce_max_sync(kFullMask, top);
  mtop = __reduce_max_sync(kFullMask, mtop);
  spill = __reduce_add_sync(kFullMask, spill);
  if (lane == 0) {
    atomicMax(&s_top, top);
    atomicMax(&s_mtop, mtop);
    if (spill) atomicAdd(&s_spill, spill);
  }
  __syncthreads();

  // merge the block's non-empty levels into the global table
  const int lim = min(s_top + 1, L);
  for (int l = tid; l < lim; l += blockDim.x) {
    const int c = s.cnt[l];
    const long long lo = s.lo[l], hi = s.hi[l];
    if (c) atomicAdd(g.cnt + l, c);
    if (lo != kI64Max) atomicMin(g.lo + l, lo);
    if (hi != kI64Min) atomicMax(g.hi + l, hi);
  }
  int* const mtop_g = g.cnt + n_levels + 1;
  if (tid == 0) {
    if (s_mtop >= 0) atomicMax(mtop_g, s_mtop);
    if (s_spill) atomicAdd(&order_spill_count, (unsigned long long)s_spill);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned done = atomicAdd((unsigned*)(g.cnt + n_levels + 2), 1u);
    s_last = done == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // the last block: counts of levels 0 .. m-1 to their exclusive prefix
  // sum in place, the total at m (m - 1: the highest level with a mover)
  __threadfence();
  const int m = __ldcg(mtop_g) + 1;
  int carry = 0;
  for (int b = 0; b < m; b += blockDim.x) {
    const int l = b + tid;
    const int v = l < m ? __ldcg(g.cnt + l) : 0;
    int x = v;
    for (int d = 1; d < kWarp; d <<= 1) {
      const int y = __shfl_up_sync(kFullMask, x, d);
      if (lane >= d) x += y;
    }
    if (lane == kWarp - 1) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = lane < warps ? s_warp[lane] : 0;
      for (int d = 1; d < kWarp; d <<= 1) {
        const int y = __shfl_up_sync(kFullMask, w, d);
        if (lane >= d) w += y;
      }
      if (lane < warps) s_warp[lane] = w;
    }
    __syncthreads();
    if (l < m) g.cnt[l] = carry + (warp ? s_warp[warp - 1] : 0) + x - v;
    carry += s_warp[warps - 1];
    __syncthreads();
  }
  if (tid == 0) g.cnt[m] = carry;
}

__global__ void __launch_bounds__(kThreads)
level_assign_kernel(const int* __restrict__ core,
                    const uint8_t* __restrict__ moving,
                    const long long* __restrict__ label,
                    const int* __restrict__ rank,
                    const long long* __restrict__ lo,
                    const long long* __restrict__ hi,
                    const int* __restrict__ first, long long* __restrict__ out,
                    long long n, long long n_levels, int at_head) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    long long lab = label[i];
    if (moving[i]) {
      const int lvl = core[i];
      if (lvl >= 0 && lvl < n_levels) {
        const int f = first[lvl];
        const int pos = rank[i] - f;
        // two's complement arithmetic, as torch's int64 ops wrap
        if (at_head) {
          const long long b = lo[lvl];
          const int c = first[lvl + 1] - f;
          lab = (long long)((unsigned long long)(b == kPos ? 0 : b) -
                            (unsigned long long)kGap *
                                (unsigned long long)(long long)(c - pos));
        } else {
          const long long b = hi[lvl];
          lab = (long long)((unsigned long long)(b == kNeg ? 0 : b) +
                            (unsigned long long)kGap *
                                (unsigned long long)(long long)(pos + 1));
        }
      }
    }
    out[i] = lab;
  }
}

// the card's shared memory and SM count, and the level pass's opt-in to
// its dynamic shared memory, once a device
cudaError_t configure(int* levels_max, int* sms) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_levels_max[dev] == 0) {
    int optin, count;
    cudaFuncAttributes attr;
    if ((e = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
        (e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                    dev)) ||
        (e = cudaFuncGetAttributes(&attr, level_pass_kernel)))
      return e;
    const int levels = (optin - (int)attr.sharedSizeBytes) / kLevelBytes;
    if ((e = cudaFuncSetAttribute(level_pass_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  levels * kLevelBytes)))
      return e;
    g_sms[dev] = count;
    g_levels_max[dev] = levels;
  }
  *levels_max = g_levels_max[dev];
  *sms = g_sms[dev];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The levels the level pass keeps in shared memory for ``n_levels`` on the
// current device: min(n_levels, the most that fit). Negative: a CUDA error.
long long order_shared_levels(long long n_levels) {
  int levels_max, sms;
  const cudaError_t e = configure(&levels_max, &sms);
  if (e != cudaSuccess) return -(long long)e;
  return n_levels < levels_max ? n_levels : levels_max;
}

// place_block's level reductions and label assignment. core int32, label
// int64, moving bytes, rank int32 (each vertex's rank in the (level,
// round_key, label) order of the movers, every non-mover after them), all
// [n], n >= 1. Scratch: lo, hi int64 [n_levels], cnt int32 [n_levels + 3].
// out int64 [n].
int order_place(const void* core, const void* label, const void* moving,
                const void* rank, void* lo, void* hi, void* cnt, void* out,
                long long n, long long n_levels, int at_head, void* stream) {
  auto st = (cudaStream_t)stream;
  int levels_max, sms;
  cudaError_t e = configure(&levels_max, &sms);
  if (e != cudaSuccess) return e;
  const int L = (int)(n_levels < levels_max ? n_levels : levels_max);
  const Table g{(long long*)lo, (long long*)hi, (int*)cnt};
  level_init_kernel<<<blocks_for(n_levels, kThreads), kThreads, 0, st>>>(
      g.lo, g.hi, g.cnt, n_levels);
  if ((e = cudaGetLastError())) return e;
  long long grid = blocks_for(n, kLevelThreads);
  if (grid > sms) grid = sms;
  level_pass_kernel<<<grid, kLevelThreads, (size_t)L * kLevelBytes, st>>>(
      (const int*)core, (const uint8_t*)moving, (const long long*)label, g, n,
      n_levels, L);
  if ((e = cudaGetLastError())) return e;
  level_assign_kernel<<<blocks_for(n, kThreads), kThreads, 0, st>>>(
      (const int*)core, (const uint8_t*)moving, (const long long*)label,
      (const int*)rank, g.lo, g.hi, g.cnt, (long long*)out, n, n_levels,
      at_head);
  return cudaGetLastError();
}

// The spill tally: vertices that took the spill path since the last reset
// (synchronous; never called on the batch path).
int order_spill_read(long long* out) {
  unsigned long long v = 0;
  const cudaError_t e =
      cudaMemcpyFromSymbol(&v, order_spill_count, sizeof v);
  *out = (long long)v;
  return e;
}

int order_spill_reset() {
  const unsigned long long z = 0;
  return cudaMemcpyToSymbol(order_spill_count, &z, sizeof z);
}

}  // extern "C"

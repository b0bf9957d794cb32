// Hopper (sm_90a) kernel for the DeepFM second-order interaction
//   out[b] = 0.5 * sum_d ((sum_f emb[b,f,d])^2 - sum_f emb[b,f,d]^2)
// over emb [B, F, D] in float32 or bfloat16, accumulated in float32, out [B]
// in emb's type.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/fm_interaction.py
// (fm_interaction, _fm_kernel, pallas_call at line 35), which holds a
// [1024, F, D] batch block in VMEM and reduces it there.
//
// Bound. Pure bandwidth: every element of emb is read once and each row
// writes one value, with 2 operations an element (an add and a
// multiply-add). At the serving shape [262144, 39, 10] float32 that is
// 0.41 GB, about 0.12 ms at 3.35 TB/s.
//
// Design. A persistent grid (two CTAs an SM) walks spans of R whole rows
// (R * F * D contiguous elements). Each CTA keeps a ring of kStages
// shared-memory stages: one thread fills them with 1-D bulk copies
// (cp.async.bulk global -> shared, completing on the stage's mbarrier),
// so while the CTA reduces one span the next kStages - 1 are in flight.
// The span is reduced from shared memory as it came (bfloat16 stays
// bfloat16 and converts on read): a group of G lanes (the power of two
// >= D, at most 32) takes a row, lane d walks the F fields of columns d,
// d + G, ... for the two sums, and the group adds its D terms with xor
// shuffles; a warp takes 32 / G rows at once. A bulk copy moves a multiple
// of 16 bytes from a 16-byte aligned address, so R is a multiple of
// 16 / gcd(row bytes, 16) and every span but the last starts and ends on
// 16 bytes; the last span, when its size is not a multiple of 16, is read
// from device memory directly, as is everything when emb's base is not
// 16-byte aligned or a row is wider than a stage (kStageBytes). R is also
// at most one span an SM for a small batch (4 rows at B = 512), so the
// batch spreads over the SMs. Measured (NVIDIA H100 80GB HBM3, 700.00 W,
// scripts/time_kernel_api.py): 0.14 ms at [262144, 39, 10] float32, 0.87
// of the bound, where staging a block's span, then reducing it, took
// 0.36 ms; 0.003 ms at [512, 39, 10] from a CUDA graph.
//
// C interface for ctypes: returns cudaGetLastError() of the launch; the
// caller raises when it is not 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { F32 = 2, BF16 = 3 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;
constexpr long long kStageBytes = 32 * 1024;  // the most a stage holds
constexpr int kCtasPerSm = 2;
constexpr int kBarBytes = 128;  // the ring's mbarriers, before the stages

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity. A wait
// that never ends (a lost arrival) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1u << 24)) __trap();
  }
}

// 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// out[r] for the span's rows 0..rows-1 at p (shared or device memory): a
// group of G = 1 << g_log2 lanes a row, 32 / G rows a warp
template <typename T>
__device__ __forceinline__ void reduce_rows(const T* p, int rows, int F,
                                            int D, int g_log2, T* out) {
  const int FD = F * D;
  const int lane = threadIdx.x & 31;
  const int sub = lane & ((1 << g_log2) - 1);
  const int rpw = 32 >> g_log2;
  // warp-uniform bound: every lane reaches the shuffles
  for (int r0 = (threadIdx.x >> 5) * rpw; r0 < rows; r0 += kWarps * rpw) {
    const int r = r0 + (lane >> g_log2);
    float term = 0.f;
    if (r < rows) {
      const T* q = p + (long long)r * FD;
      for (int d = sub; d < D; d += 1 << g_log2) {
        float s = 0.f, s2 = 0.f;
        for (int f = 0; f < F; ++f) {
          const float x = to_f(q[f * D + d]);
          s += x;
          s2 += x * x;
        }
        term += s * s - s2;
      }
    }
    for (int o = (1 << g_log2) >> 1; o > 0; o >>= 1)
      term += __shfl_xor_sync(0xffffffffu, term, o);
    if (sub == 0 && r < rows) out[r] = from_f<T>(0.5f * term);
  }
}

template <typename T, bool STAGE>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
fm_kernel(const T* __restrict__ emb, T* __restrict__ out, long long B, int F,
          int D, int R, int g_log2, int stage_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long FD = (long long)F * D;
  const long long row_bytes = FD * (long long)sizeof(T);
  const long long tiles = (B + R - 1) / R;
  // the i-th span of this CTA, its rows, and whether a bulk copy moves it
  auto span = [&](long long i, long long& b0, int& rows) {
    b0 = ((long long)blockIdx.x + i * gridDim.x) * R;
    rows = b0 < B ? (int)min((long long)R, B - b0) : 0;
    return rows > 0 && (rows * row_bytes) % 16 == 0;
  };
  const uint32_t bars = smem_u32(smem);
  unsigned char* stages = smem + kBarBytes;
  // one thread fills stage i % kStages with span i, or arrives without
  // bytes for a span read from device memory
  auto fill = [&](long long i) {
    long long b0;
    int rows;
    const bool bulk = span(i, b0, rows);
    if (rows == 0) return;
    const uint32_t bar = bars + 8 * (uint32_t)(i % kStages);
    if (bulk) {
      const uint32_t bytes = (uint32_t)(rows * row_bytes);
      mbar_expect_tx(bar, bytes);
      bulk_load(smem_u32(stages + (i % kStages) * stage_bytes),
                emb + b0 * FD, bytes, bar);
    } else {
      mbar_arrive(bar);
    }
  };
  if (STAGE) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int i = 0; i < kStages; ++i) fill(i);
  }
  for (long long i = 0; (long long)blockIdx.x + i * gridDim.x < tiles; ++i) {
    long long b0;
    int rows;
    const bool bulk = span(i, b0, rows);
    if (STAGE) {
      mbar_wait(bars + 8 * (uint32_t)(i % kStages), (uint32_t)(i / kStages) & 1);
      if (bulk)
        reduce_rows((const T*)(stages + (i % kStages) * stage_bytes), rows,
                    F, D, g_log2, out + b0);
      else
        reduce_rows(emb + b0 * FD, rows, F, D, g_log2, out + b0);
      __syncthreads();  // every thread is done with the stage
      if (threadIdx.x == 0) fill(i + kStages);
    } else {
      reduce_rows(emb + b0 * FD, rows, F, D, g_log2, out + b0);
    }
  }
}

long long gcd(long long a, long long b) { return b == 0 ? a : gcd(b, a % b); }

template <typename T>
int launch(const void* emb, void* out, long long B, int F, int D,
           cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return (int)rc;
  const long long row_bytes = (long long)F * D * sizeof(T);
  int g_log2 = 0;
  while ((1 << g_log2) < D && g_log2 < 5) ++g_log2;
  const long long pass = kWarps * (32 >> g_log2);  // rows a CTA takes at once
  // spans are a multiple of q rows, so each starts on 16 bytes
  const long long q = 16 / gcd(row_bytes, 16);
  const long long fit = kStageBytes / row_bytes / q * q;
  const bool stage = (uintptr_t)emb % 16 == 0 && fit > 0;
  long long R = pass;
  if (stage) {
    const long long unit = q > pass ? q : pass;
    R = fit >= unit ? fit / unit * unit : fit;
  }
  // a small batch: at most one span an SM
  const long long per_sm = (B + sms - 1) / sms;
  const long long spread = stage ? (per_sm + q - 1) / q * q : per_sm;
  if (spread < R) R = spread;
  const long long tiles = (B + R - 1) / R;
  const long long grid = tiles < (long long)kCtasPerSm * sms ? tiles
                                                              : (long long)kCtasPerSm * sms;
  const int stage_bytes = stage ? (int)((R * row_bytes + 127) / 128 * 128) : 0;
  const size_t smem = stage ? kBarBytes + (size_t)kStages * stage_bytes : 0;
  if (stage) {
    if (smem > 48 * 1024) {
      rc = cudaFuncSetAttribute(fm_kernel<T, true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
      if (rc != cudaSuccess) return (int)rc;
    }
    fm_kernel<T, true><<<(unsigned)grid, kThreads, smem, st>>>(
        (const T*)emb, (T*)out, B, F, D, (int)R, g_log2, stage_bytes);
  } else {
    fm_kernel<T, false><<<(unsigned)grid, kThreads, 0, st>>>(
        (const T*)emb, (T*)out, B, F, D, (int)R, g_log2, 0);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// emb [B, F, D] contiguous, out [B]; B, F, D > 0. dtype: F32 or BF16.
int fm_interaction(const void* emb, void* out, long long B, int F, int D,
                   int dtype, void* stream) {
  auto st = (cudaStream_t)stream;
  switch (dtype) {
    case F32: return launch<float>(emb, out, B, F, D, st);
    case BF16: return launch<__nv_bfloat16>(emb, out, B, F, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

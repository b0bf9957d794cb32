// Hopper (sm_90a) kernel for the DeepFM second-order interaction
//   out[b] = 0.5 * sum_d ((sum_f emb[b,f,d])^2 - sum_f emb[b,f,d]^2)
// over emb [B, F, D] in float32 or bfloat16, accumulated in float32, out [B]
// in emb's type.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/fm_interaction.py
// (fm_interaction, _fm_kernel, pallas_call at line 35), which holds a
// [1024, F, D] batch block in VMEM and reduces it there.
//
// Design. A block takes R whole rows at a time (R * F * D elements, a
// contiguous span of emb): its threads copy the span into shared memory as
// float32 with coalesced loads, then thread (r, d) walks the F fields of
// its column for the two sums and leaves s^2 - s2 in shared memory, and
// thread r adds its row's D terms. R is the most rows whose span and terms
// fit in 48 KB. A row too wide to stage (F * D > 12,288) is read from
// device memory directly.
//
// Bound. Pure bandwidth: every element of emb is read once and each row
// writes one value, with 2 operations an element (an add and a
// multiply-add). At the serving shape [262144, 39, 10] float32 that is
// 0.41 GB, about 0.12 ms at 3.35 TB/s.
//
// C interface for ctypes: returns cudaGetLastError() of the launch; the
// caller raises when it is not 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { F32 = 2, BF16 = 3 };

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;
constexpr long long kSmemFloats = 48 * 1024 / 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, bool STAGE>
__global__ void __launch_bounds__(kThreads)
fm_kernel(const T* __restrict__ emb, T* __restrict__ out, long long B, int F,
          int D, int R) {
  extern __shared__ float sm[];
  const long long FD = (long long)F * D;
  float* term = sm + (STAGE ? R * FD : 0);
  for (long long b0 = (long long)blockIdx.x * R; b0 < B;
       b0 += (long long)gridDim.x * R) {
    const int rows = (int)min((long long)R, B - b0);
    const T* base = emb + b0 * FD;
    if (STAGE) {
      for (long long i = threadIdx.x; i < rows * FD; i += blockDim.x)
        sm[i] = to_f(base[i]);
      __syncthreads();
    }
    for (int t = threadIdx.x; t < rows * D; t += blockDim.x) {
      const int r = t / D, d = t % D;
      float s = 0.f, s2 = 0.f;
      for (int f = 0; f < F; ++f) {
        const long long i = r * FD + (long long)f * D + d;
        const float x = STAGE ? sm[i] : to_f(base[i]);
        s += x;
        s2 += x * x;
      }
      term[t] = s * s - s2;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc += term[r * D + d];
      out[b0 + r] = from_f<T>(0.5f * acc);
    }
    __syncthreads();  // the next span reuses the shared memory
  }
}

template <typename T>
int launch(const void* emb, void* out, long long B, int F, int D,
           cudaStream_t st) {
  const long long FD = (long long)F * D;
  const bool stage = FD + D <= kSmemFloats;
  long long R = stage ? kSmemFloats / (FD + D) : kSmemFloats / D;
  if (R > 256) R = 256;
  if (R < 1) return (int)cudaErrorInvalidValue;  // D > 12,288
  long long blocks = (B + R - 1) / R;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const size_t smem = (size_t)((stage ? R * FD : 0) + R * D) * sizeof(float);
  if (stage)
    fm_kernel<T, true><<<(unsigned)blocks, kThreads, smem, st>>>(
        (const T*)emb, (T*)out, B, F, D, (int)R);
  else
    fm_kernel<T, false><<<(unsigned)blocks, kThreads, smem, st>>>(
        (const T*)emb, (T*)out, B, F, D, (int)R);
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

// Hopper (sm_90a) kernel for blockwise (flash) attention, forward only,
// causal or not, with grouped-query heads.
//   q [B, H, Sq, D], k and v [B, Hkv, Sk, D], H % Hkv == 0; the kv head of
//   q head h is h / (H / Hkv). out [B, H, Sq, D] in q's type. float32 or
//   bfloat16 inputs, D in {64, 128}, all arithmetic in float32.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py
// (flash_attention, _flash_kernel, pallas_call at line 85): one program per
// (b, h, q block) that streams the K/V blocks with the running max and
// normaliser, so the [Sq, Sk] scores never reach device memory.
//
// Design. One block per (b, h, tile of BQ query rows). G = D / 32 threads
// share a query row; each holds 32 of its dimensions (float4 chunks
// interleaved across the G threads, so that their shared-memory reads fall
// in distinct banks) of q * scale and of the output accumulator. K and V
// tiles of 32 keys are copied into shared memory as float32; for each key
// the G threads form the dot product and combine it with warp shuffles,
// then the tile's scores update the running max m and normaliser l as in
// the Pallas kernel:
//   m' = max(m, max_j s_j); a = exp(m - m'); l = a l + sum_j exp(s_j - m');
//   acc = a acc + sum_j exp(s_j - m') v_j;  out = acc / max(l, 1e-30).
// The causal mask is top-left aligned (query i sees key j when i >= j,
// both counted from 0, also when Sq != Sk) with the reference's -1e30 for
// masked scores; tiles wholly past a block's last query are skipped. The
// kv head is read in place (no repeat in memory). The arithmetic is scalar
// float32 on the CUDA cores; the tensor cores (mma / wgmma) are later work.
//
// Bound. Operations: 4 * Sq * Sk * D per (b, h) (two products, halved when
// causal) against 989 TFLOP/s bf16 or 67 TFLOP/s float32; bytes: q, k, v
// and out once. At long sequences it is bound by operations, and this
// scalar kernel runs far from that bound.
//
// C interface for ctypes: returns cudaGetLastError() of the launch; the
// caller raises when it is not 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { F32 = 2, BF16 = 3 };

constexpr int kThreads = 256;
constexpr int kBK = 32;  // keys per K/V tile
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int H, int Hkv,
             long long Sq, long long Sk, float scale, bool causal) {
  constexpr int G = D / 32;          // threads a query row
  constexpr int BQ = kThreads / G;   // query rows a block
  constexpr int C = 32 / 4;          // float4 chunks a thread holds
  __shared__ __align__(16) float Ks[kBK * D];
  __shared__ __align__(16) float Vs[kBK * D];

  const int tid = threadIdx.x;
  const int g = tid % G;
  const long long q0 = (long long)blockIdx.x * BQ;
  const long long qi = q0 + tid / G;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const bool active = qi < Sq;

  const T* qrow = q + ((b * H + h) * Sq + (active ? qi : 0)) * D;
  const T* kh = k + (b * Hkv + kvh) * Sk * D;
  const T* vh = v + (b * Hkv + kvh) * Sk * D;

  float4 qv[C], acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int d0 = (c * G + g) * 4;
    qv[c] = make_float4(to_f(qrow[d0]) * scale, to_f(qrow[d0 + 1]) * scale,
                        to_f(qrow[d0 + 2]) * scale, to_f(qrow[d0 + 3]) * scale);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNeg, l = 0.f;

  long long kv_end = Sk;
  if (causal && q0 + BQ < kv_end) kv_end = q0 + BQ;
  for (long long k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const long long key = k0 + i / D;
      const bool in = key < Sk;
      Ks[i] = in ? to_f(kh[key * D + i % D]) : 0.f;
      Vs[i] = in ? to_f(vh[key * D + i % D]) : 0.f;
    }
    __syncthreads();

    float s[kBK];
    float m_tile = kNeg;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(Ks + j * D);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 kk = kr[c * G + g];
        dot = fmaf(qv[c].x, kk.x, dot);
        dot = fmaf(qv[c].y, kk.y, dot);
        dot = fmaf(qv[c].z, kk.z, dot);
        dot = fmaf(qv[c].w, kk.w, dot);
      }
#pragma unroll
      for (int o = 1; o < G; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const long long key = k0 + j;
      const bool ok = key < Sk && (!causal || qi >= key);
      s[j] = ok ? dot : kNeg;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[c].x *= alpha; acc[c].y *= alpha; acc[c].z *= alpha; acc[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      // keys past Sk are not attention keys at all: they add nothing
      const float p = (k0 + j < Sk) ? expf(s[j] - m_new) : 0.f;
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(Vs + j * D);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 vv = vr[c * G + g];
        acc[c].x = fmaf(p, vv.x, acc[c].x);
        acc[c].y = fmaf(p, vv.y, acc[c].y);
        acc[c].z = fmaf(p, vv.z, acc[c].z);
        acc[c].w = fmaf(p, vv.w, acc[c].w);
      }
    }
    m = m_new;
  }

  if (!active) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* orow = out + ((b * H + h) * Sq + qi) * D;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int d0 = (c * G + g) * 4;
    orow[d0] = from_f<T>(acc[c].x * inv);
    orow[d0 + 1] = from_f<T>(acc[c].y * inv);
    orow[d0 + 2] = from_f<T>(acc[c].z * inv);
    orow[d0 + 3] = from_f<T>(acc[c].w * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Hkv, long long Sq, long long Sk, float scale,
           bool causal, cudaStream_t st) {
  constexpr int BQ = kThreads / (D / 32);
  dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  flash_kernel<T, D><<<grid, kThreads, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, Hkv, Sq, Sk, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, H, Sq, D], k/v [B, Hkv, Sk, D], out like q, all contiguous;
// H % Hkv == 0, Sq, Sk > 0, D in {64, 128}. dtype: F32 or BF16.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int H, int Hkv, long long Sq, long long Sk, int D,
                    float scale, int causal, int dtype, void* stream) {
  auto st = (cudaStream_t)stream;
  const bool c = causal != 0;
  if (dtype == F32 && D == 64)
    return launch<float, 64>(q, k, v, out, B, H, Hkv, Sq, Sk, scale, c, st);
  if (dtype == F32 && D == 128)
    return launch<float, 128>(q, k, v, out, B, H, Hkv, Sq, Sk, scale, c, st);
  if (dtype == BF16 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, B, H, Hkv, Sq, Sk, scale, c, st);
  if (dtype == BF16 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, B, H, Hkv, Sq, Sk, scale, c, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

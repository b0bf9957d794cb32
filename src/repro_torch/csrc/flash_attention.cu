// Hopper (sm_90a) kernels for blockwise (flash) attention, forward only,
// causal or not, with grouped-query heads.
//   q [B, H, Sq, D], k and v [B, Hkv, Sk, D], H % Hkv == 0; the kv head of
//   q head h is h / (H / Hkv), read in place. out [B, H, Sq, D] in q's
//   type. float32 or bfloat16 inputs, D in {64, 128}.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py
// (flash_attention, _flash_kernel, pallas_call at line 85): one program per
// (b, h, q block) that streams the K/V blocks with the running max m and
// normaliser l, so the [Sq, Sk] scores never reach device memory:
//   m' = max(m, max_j s_j); a = exp(m - m'); l = a l + sum_j exp(s_j - m');
//   acc = a acc + sum_j exp(s_j - m') v_j;  out = acc / max(l, 1e-30).
// The causal mask is top-left aligned (query i sees key j when i >= j, both
// counted from 0, also when Sq != Sk) with the reference's -1e30; key tiles
// wholly past a block's last query are skipped, as the Pallas kernel's
// `upper` does, and keys past Sk add nothing to l. Scores are scaled by
// scale * log2(e) before the mask and the max (so any scale, zero or
// negative too, gives the reference's answer), and exponentials are exp2.
//
// Bound. Operations: 4 Sq Sk D per (b, h) (two products, about halved when
// causal) against 989 TFLOP/s bfloat16 on the tensor cores or 67 TFLOP/s
// float32 on the CUDA cores; bytes: q, k, v and out once. Both instances
// are bound by operations at the sequence lengths of a prefill.
//
// Two designs, dispatched by dtype:
//
// bfloat16: flash_wgmma_kernel, tensor cores fed by TMA. One block of 384
// threads per (b, h, tile of 128 queries): two consumer warpgroups of 64
// query rows each and one producer warpgroup, of which one thread issues
// the TMA loads and the rest exit; setmaxnreg moves registers from the
// producer to the consumers. Q's tile is loaded once; K and V tiles of 128
// keys go through a two-stage ring in dynamic shared memory with a "full"
// and an "empty" mbarrier a stage, so the next tile's copy overlaps this
// tile's math. The TMA maps are 3-D, [B H or B Hkv, S, D], so a tile past
// Sq or Sk reads zeros and never the next head's rows, and use the 128-byte
// swizzle: a box is 64 columns (128 bytes) wide, so a D = 128 tile is two
// boxes, [2][rows][64], each row of a box XOR-swizzled in 16-byte chunks
// by its row index mod 8. S = Q K^T is wgmma m64n128k16 with A = Q and
// B = K from shared memory, both K-major: the descriptor of k-step kk
// starts 32 * (kk % 4) bytes into the rows of box kk / 4, with 1,024 bytes
// (8 rows of 128 bytes) between 8-row groups. The online softmax runs on
// the accumulator fragments (a row's values lie in the 4 threads of a
// quad: two shuffles). P is rounded to bfloat16 in registers, where the
// accumulator's layout is already wgmma's A fragment, and O += P V is
// wgmma m64nDk16 with A from registers and B = V's tile, MN-major (the
// transpose flag, so V is never transposed in memory): 2,048 bytes per
// 16-key step, 1,024 between 8-key groups, and the tile's row length
// (BK * 128 bytes) between the two 64-column boxes. Rounding P is the one
// difference from the float32 plain version (bf16 products are exact in
// the float32 accumulator). Blocks are ordered heaviest q tile first (the
// causal tiles differ in cost by up to Sq / 128), and the q heads that
// share a kv head are adjacent, so K/V tiles are reused from L2.
//
// float32: flash_ffma_kernel, register-tiled FFMA on the CUDA cores (TF32
// would change the precision). One block of 256 threads per (b, h, tile of
// 64 queries), key tiles of 64. Q, K and V tiles are copied with cp.async
// (16 bytes a thread, zero-filled past Sq / Sk), K and V double-buffered,
// rows padded by 4 floats so that the 16 threads reading 16 K rows hit
// distinct banks. Each thread computes a 4 x 4 micro-tile of S (its 4
// query rows against keys tx + 16 b) from float4 loads: 64 FMAs for 8
// 16-byte loads. A row's 64 scores lie in 16 threads of one warp (four
// shuffles for its max and sum). P goes through shared memory, and each
// thread accumulates a 4 x D/16 micro-tile of O (its rows, 4 columns per
// 64): 128 FMAs for 12 loads per 4 keys at D = 128.
//
// C interface for ctypes: returns cudaGetLastError() of the launch (or
// cudaErrorNotSupported / cudaErrorInvalidValue when the CUDA driver's
// cuTensorMapEncodeTiled is missing or refuses a map); the caller raises
// when it is not 0. cuTensorMapEncodeTiled is reached through the runtime's
// CUDA driver entry point, so the library needs no -lcuda.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { F32 = 2, BF16 = 3 };

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier, TMA and wgmma helpers (bfloat16 kernel)

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
    if (spins > (1u << 30)) __trap();
  }
}

// 3-D TMA load of one box into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving accesses of a wgmma accumulator across the
// asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(b)                                                         \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),           \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d (64 x 128, float32) (+)= A B^T, A and B bfloat16 in shared memory,
// both K-major with the 128-byte swizzle; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24),
        ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, float32) += A B, A bfloat16 in registers (the m64k16
// fragment), B bfloat16 in shared memory, MN-major (transposed) with the
// 128-byte swizzle
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (64 x 128, float32) += A B, A bfloat16 in registers (the m64k16
// fragment), B bfloat16 in shared memory, MN-major (transposed) with the
// 128-byte swizzle
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24),
        ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}


__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// The block's tile: q tiles heaviest first when causal, and the q heads of
// one kv head adjacent (h fastest).
struct Tile {
  int bh, kvh, q0, n_kv;
};

__device__ __forceinline__ Tile tile_of(int bq, int bk, int H, int Hkv,
                                        int Sk, int n_qt, int n_bh,
                                        bool causal) {
  Tile t;
  const int rev = blockIdx.x / n_bh;
  t.bh = blockIdx.x % n_bh;
  const int qt = causal ? n_qt - 1 - rev : rev;
  const int b = t.bh / H, h = t.bh % H;
  t.kvh = b * Hkv + h / (H / Hkv);
  t.q0 = qt * bq;
  const int kv_end = causal ? min(Sk, t.q0 + bq) : Sk;
  t.n_kv = (kv_end + bk - 1) / bk;
  return t;
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA

constexpr int kWgBQ = 128;  // queries a block: two consumer warpgroups
constexpr int kWgBK = 128;  // keys a K/V tile
constexpr int kStages = 2;  // K/V ring depth
constexpr int kWgThreads = 384;

template <int D>
constexpr int wg_smem_bytes() {
  // Q, the ring's K and V tiles, 5 mbarriers, and slack to align to 1,024
  return kWgBQ * D * 2 + kStages * 2 * kWgBK * D * 2 + 64 + 1024;
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, int H, int Hkv, int Sq,
                   int Sk, int n_qt, int n_bh, float scale_log2, int causal) {
  constexpr int NH = D / 64;                   // 64-column boxes a row
  constexpr int Q_BYTES = kWgBQ * D * 2;
  constexpr int KV_BYTES = kWgBK * D * 2;      // one K or V tile
  constexpr int Q_BOX = kWgBQ * 128;           // one 64-column box of Q
  constexpr int KV_BOX = kWgBK * 128;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: align every tile to it
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + Q_BYTES;        // stage s: K, then V
  const uint32_t bar = kv_s + kStages * 2 * KV_BYTES;
  const uint32_t q_bar = bar + 8 * 2 * kStages;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (kStages + s); };

  const bool is_causal = causal != 0;
  const Tile t = tile_of(kWgBQ, kWgBK, H, Hkv, Sk, n_qt, n_bh, is_causal);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);  // every consumer thread arrives
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load --------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_bar, Q_BYTES);
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
        tma_load_3d(q_s + hh * Q_BOX, &tq, 64 * hh, t.q0, t.bh, q_bar);
      for (int i = 0; i < t.n_kv; ++i) {
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * KV_BYTES);
        const uint32_t k_s = kv_s + s * 2 * KV_BYTES;
#pragma unroll
        for (int hh = 0; hh < NH; ++hh) {
          tma_load_3d(k_s + hh * KV_BOX, &tk, 64 * hh, i * kWgBK, t.kvh,
                      full(s));
          tma_load_3d(k_s + KV_BYTES + hh * KV_BOX, &tv, 64 * hh, i * kWgBK,
                      t.kvh, full(s));
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup --------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    // this thread's rows of the block (r, r + 8) and first column pair
    const int r = 64 * wg + 16 * warp + lane / 4;
    const int c = 2 * (lane % 4);
    const int row0 = t.q0 + r, row1 = row0 + 8;
    float s[kWgBK / 2];  // S fragment: [4j + e] row0, [4j + 2 + e] row1,
                         // column 8 j + c + e
    float o[D / 2];      // O fragment, the same layout over D columns
#pragma unroll
    for (int i = 0; i < kWgBK / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
    const uint32_t qa = q_s + wg * 64 * 128;
    // rows that can see every key of a tile that ends at or before them
    const int wg_row_min = t.q0 + 64 * wg;

    mbar_wait(q_bar, 0);
    for (int i = 0; i < t.n_kv; ++i) {
      const int st = i % kStages;
      const uint32_t k_s = kv_s + st * 2 * KV_BYTES;
      const uint32_t v_s = k_s + KV_BYTES;
      mbar_wait(full(st), (i / kStages) & 1);

      // S = Q K^T
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // k-step within a box
        wgmma_ss_n128(s, sw128_desc(qa + (kk / 4) * Q_BOX + off, 16, 1024),
                      sw128_desc(k_s + (kk / 4) * KV_BOX + off, 16, 1024),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      // scaled scores in the log2 domain, before the mask and the max, so
      // that any scale (zero or negative too) gives the reference's answer
#pragma unroll
      for (int j = 0; j < kWgBK / 2; ++j) s[j] *= scale_log2;

      // mask: keys past Sk, and past the row when causal
      const int k0 = i * kWgBK;
      if (k0 + kWgBK > Sk || (is_causal && k0 + kWgBK - 1 > wg_row_min)) {
#pragma unroll
        for (int j = 0; j < kWgBK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * j + c + e;
            const bool out_k = key >= Sk;
            if (out_k || (is_causal && key > row0)) s[4 * j + e] = kNeg;
            if (out_k || (is_causal && key > row1)) s[4 * j + 2 + e] = kNeg;
          }
        }
      }

      // online softmax on the fragments
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < kWgBK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      const float a0 = fast_exp2(m0 - mx0);
      const float a1 = fast_exp2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < kWgBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * j + e] = fast_exp2(s[4 * j + e] - mx0);
          s[4 * j + 2 + e] = fast_exp2(s[4 * j + 2 + e] - mx1);
          ps0 += s[4 * j + e];
          ps1 += s[4 * j + 2 + e];
        }
      }
      l0 = l0 * a0 + ps0;
      l1 = l1 * a1 + ps1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }
      // P in bf16: the S fragment of keys 16 kk .. 16 kk + 15 is the A
      // fragment of k-step kk
      uint32_t pa[kWgBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P V, V MN-major: 16 keys a step, the two boxes LBO apart
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
        wgmma_rs(o, pa[kk], sw128_desc(v_s + kk * 16 * 128, KV_BOX, 1024));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
      mbar_arrive(empty(st));
    }

    // epilogue: out = O / max(l, 1e-30), rows < Sq
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, x);
      l1 += __shfl_xor_sync(0xffffffffu, l1, x);
    }
    const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
    __nv_bfloat16* ob = out + (long long)t.bh * Sq * D + c;
    if (row0 < Sq) {
      uint32_t* p = reinterpret_cast<uint32_t*>(ob + (long long)row0 * D);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        p[4 * j] = pack_bf16(o[4 * j] * i0, o[4 * j + 1] * i0);
    }
    if (row1 < Sq) {
      uint32_t* p = reinterpret_cast<uint32_t*>(ob + (long long)row1 * D);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        p[4 * j] = pack_bf16(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: register-tiled FFMA

constexpr int kFBQ = 64;  // queries a block
constexpr int kFBK = 64;  // keys a K/V tile
constexpr int kFThreads = 256;

template <int D>
constexpr int ffma_smem_bytes() {
  // Q [64][D + 4], K [2][64][D + 4], V [2][64][D], P [64][64 + 4]
  return 4 * (kFBQ * (D + 4) + 2 * kFBK * (D + 4) + 2 * kFBK * D +
              kFBQ * (kFBK + 4));
}

// 16-byte cp.async; copies zeros (reads nothing) when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows [r0, r0 + 64) of a [S, D] head into a [64][ld] tile
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* head, int r0, int S) {
  constexpr int C = D / 4;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < 64 * C; i += kFThreads) {
    const int row = i / C, ch = i % C;
    const bool in = r0 + row < S;
    cp_async16(dst + row * ld + 4 * ch,
               head + (long long)(in ? r0 + row : 0) * D + 4 * ch, in);
  }
}

template <int D>
__global__ void __launch_bounds__(kFThreads)
flash_ffma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out, int H,
                  int Hkv, int Sq, int Sk, int n_qt, int n_bh,
                  float scale_log2, int causal) {
  constexpr int LD = D + 4, PLD = kFBK + 4, NC = D / 64;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                     // [64][LD]
  float* Ks = Qs + kFBQ * LD;          // [2][64][LD]
  float* Vs = Ks + 2 * kFBK * LD;      // [2][64][D]
  float* Ps = Vs + 2 * kFBK * D;       // [64][PLD]

  const bool is_causal = causal != 0;
  const Tile t = tile_of(kFBQ, kFBK, H, Hkv, Sk, n_qt, n_bh, is_causal);
  const float* qh = q + (long long)t.bh * Sq * D;
  const float* kh = k + (long long)t.kvh * Sk * D;
  const float* vh = v + (long long)t.kvh * Sk * D;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  // this thread: query rows 4 ty + a; S keys tx + 16 b; O columns
  // 4 tx + 64 c .. + 3

  stage_rows<D>(Qs, LD, qh, t.q0, Sq);
  stage_rows<D>(Ks, LD, kh, 0, Sk);
  stage_rows<D>(Vs, D, vh, 0, Sk);
  cp_async_commit();

  float o[4][NC][4];
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNeg;
    l[a] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[a][cc][e] = 0.f;
  }

  for (int i = 0; i < t.n_kv; ++i) {
    const int buf = i & 1;
    if (i + 1 < t.n_kv) {
      const int nb = buf ^ 1;
      stage_rows<D>(Ks + nb * kFBK * LD, LD, kh, (i + 1) * kFBK, Sk);
      stage_rows<D>(Vs + nb * kFBK * D, D, vh, (i + 1) * kFBK, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S micro-tile: 4 rows x 4 keys
    const float* Kb = Ks + buf * kFBK * LD;
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qa[a] = *reinterpret_cast<const float4*>(Qs + (4 * ty + a) * LD + d);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        kb[b] = *reinterpret_cast<const float4*>(Kb + (tx + 16 * b) * LD + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          s[a][b] = fmaf(qa[a].x, kb[b].x, s[a][b]);
          s[a][b] = fmaf(qa[a].y, kb[b].y, s[a][b]);
          s[a][b] = fmaf(qa[a].z, kb[b].z, s[a][b]);
          s[a][b] = fmaf(qa[a].w, kb[b].w, s[a][b]);
        }
    }

    // mask, online softmax (a row's 64 keys lie in 16 threads of a warp)
    const int k0 = i * kFBK;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = t.q0 + 4 * ty + a;
      float mx = m[a];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        // scaled (log2 domain) before the mask and the max: any scale
        const int key = k0 + tx + 16 * b;
        s[a][b] = (key >= Sk || (is_causal && key > row))
                      ? kNeg : s[a][b] * scale_log2;
        mx = fmaxf(mx, s[a][b]);
      }
#pragma unroll
      for (int x = 1; x < 16; x <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float alpha = fast_exp2(m[a] - mx);
      m[a] = mx;
      float ps = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = fast_exp2(s[a][b] - mx);
        ps += p;
        Ps[(4 * ty + a) * PLD + tx + 16 * b] = p;
      }
      l[a] = l[a] * alpha + ps;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[a][cc][e] *= alpha;
    }
    __syncthreads();

    // O micro-tile += P V
    const float* Vb = Vs + buf * kFBK * D;
#pragma unroll 2
    for (int j = 0; j < kFBK; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pa[a] = *reinterpret_cast<const float4*>(Ps + (4 * ty + a) * PLD + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vb + (j + e) * D + 4 * tx + 64 * cc);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float p = e == 0 ? pa[a].x
                            : e == 1 ? pa[a].y
                            : e == 2 ? pa[a].z
                                     : pa[a].w;
            o[a][cc][0] = fmaf(p, vv.x, o[a][cc][0]);
            o[a][cc][1] = fmaf(p, vv.y, o[a][cc][1]);
            o[a][cc][2] = fmaf(p, vv.z, o[a][cc][2]);
            o[a][cc][3] = fmaf(p, vv.w, o[a][cc][3]);
          }
        }
      }
    }
    __syncthreads();  // this buffer and P are free for the next tile
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float la = l[a];
#pragma unroll
    for (int x = 1; x < 16; x <<= 1)
      la += __shfl_xor_sync(0xffffffffu, la, x);
    const int row = t.q0 + 4 * ty + a;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(la, 1e-30f);
    float* orow = out + ((long long)t.bh * Sq + row) * D;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
      *reinterpret_cast<float4*>(orow + 4 * tx + 64 * cc) =
          make_float4(o[a][cc][0] * inv, o[a][cc][1] * inv,
                      o[a][cc][2] * inv, o[a][cc][3] * inv);
  }
}

// ---------------------------------------------------------------------------
// host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the CUDA driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                             cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [heads, S, D] bfloat16 as a 3-D map of boxes [1, rows, 64], 128-byte
// swizzle; reads past S (or past the heads) give zeros
bool bf16_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int D,
              long long S, long long heads, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B,
                int H, int Hkv, int Sq, int Sk, float scale, bool causal,
                cudaStream_t st) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!bf16_map(enc, &tq, q, D, Sq, (long long)B * H, kWgBQ) ||
      !bf16_map(enc, &tk, k, D, Sk, (long long)B * Hkv, kWgBK) ||
      !bf16_map(enc, &tv, v, D, Sk, (long long)B * Hkv, kWgBK))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = wg_smem_bytes<D>();
  cudaError_t rc = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const int n_qt = (Sq + kWgBQ - 1) / kWgBQ, n_bh = B * H;
  flash_wgmma_kernel<D><<<(unsigned)n_qt * n_bh, kWgThreads, smem, st>>>(
      tq, tk, tv, (__nv_bfloat16*)out, H, Hkv, Sq, Sk, n_qt, n_bh,
      scale * kLog2e, causal ? 1 : 0);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int H, int Hkv, int Sq, int Sk, float scale, bool causal,
               cudaStream_t st) {
  constexpr int smem = ffma_smem_bytes<D>();
  cudaError_t rc = cudaFuncSetAttribute(
      flash_ffma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const int n_qt = (Sq + kFBQ - 1) / kFBQ, n_bh = B * H;
  flash_ffma_kernel<D><<<(unsigned)n_qt * n_bh, kFThreads, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, H, Hkv,
      Sq, Sk, n_qt, n_bh, scale * kLog2e, causal ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, H, Sq, D], k/v [B, Hkv, Sk, D], out like q, all contiguous and
// 16-byte aligned; H % Hkv == 0, 0 < Sq, Sk < 2^31, D in {64, 128}.
// dtype: F32 or BF16.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int H, int Hkv, long long Sq, long long Sk, int D,
                    float scale, int causal, int dtype, void* stream) {
  auto st = (cudaStream_t)stream;
  const bool c = causal != 0;
  if (Sq <= 0 || Sk <= 0 || Sq > 0x7fffffffLL || Sk > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int sq = (int)Sq, sk = (int)Sk;
  if (dtype == F32 && D == 64)
    return launch_f32<64>(q, k, v, out, B, H, Hkv, sq, sk, scale, c, st);
  if (dtype == F32 && D == 128)
    return launch_f32<128>(q, k, v, out, B, H, Hkv, sq, sk, scale, c, st);
  if (dtype == BF16 && D == 64)
    return launch_bf16<64>(q, k, v, out, B, H, Hkv, sq, sk, scale, c, st);
  if (dtype == BF16 && D == 128)
    return launch_bf16<128>(q, k, v, out, B, H, Hkv, sq, sk, scale, c, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

// K5: the routed FFN's experts on the kept assignments only, as grouped
// bf16 products over expert-packed rows (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves dispatch, experts and
// combine of nn/moe.py to XLA, and until this kernel the port ran them as a
// capacity-padded (E, C, D) buffer through a torch.baddbmm pair, which
// multiplies every slot whether an assignment filled it or not (at the
// benchmark's 52 % kept assignments, 41.5 % of the slots hold a row).  Here
// the caller packs the kept assignments by expert (rows off[e] ..
// off[e + 1] - 1 belong to expert e, in queue order) and K5 runs each expert
// on its own rows alone:
//
//   * K5a (moe_expert_gemm<144, true>): H = silu(X.W1ᵀ + b1) * (X.W2ᵀ + b2), X
//     the packed (rows, D) tokens, W1 / W2 the halves of the expert's w12.
//     A tile is 128 rows x 144 columns of H; it holds the matching 144 rows
//     of both halves (2736 = 19 x 144: no ragged edge at h = 2736), so the
//     SwiGLU is its epilogue: the two fp32 accumulators, + bias, silu(x1).x2
//     in fp32 and one rounding to bf16.
//   * K5b (moe_expert_gemm<256, false>): O = H.W3ᵀ + b3, a tile 128 rows x
//     256 columns, K = h (the ragged last 64-deep step is zero-filled by the
//     TMA unit).
//
// The epilogue writes through shared memory as whole 128-byte rows, and
// both kernels are entered through moe_experts (which: K5a, K5b or both).
//
// What bounds it on this card: operations, 6.D.h a kept row (2 x 6.4 GFLOP at
// the benchmark's 34 k rows a call, 1.04 ms at 989 TFLOP/s), against 0.2 GB
// of operands (0.06 ms).  So the design is the one of a tensor-core GEMM: a
// persistent block on each SM walks the tiles (expert, 128-row M tile, N
// tile; N fastest, so the blocks in flight share an expert's weights and a
// few row tiles in L2); one thread of a producer warpgroup keeps a
// four-stage ring of 64-deep stages full by TMA (128-byte swizzle, the
// layout the wgmma descriptors of attention_mma.cuh read); two consumer
// warpgroups of 64 rows each run wgmma out of the ring, fp32 accumulators
// in registers, and release a stage through an mbarrier once its products
// are done.  K5a's two 64 x 144 accumulators take 144 registers a thread:
// the producer warpgroup hands its registers to the consumers (setmaxnreg,
// 40 and 232 of the 168 a thread of 384 gets at launch).  The tile
// table is built on the device from off[], so the host never learns how many
// rows there are: a tile past an expert's count does not exist, rows past it
// in a tile are computed and not stored.  No atomics and no split of K: every
// run gives the same bits.
//
// Beside K5 stand the packed path's other passes: moe_dispatch (a one-block
// count of each expert's rows into off[] by shared-memory integer atomics,
// then a warp an assignment: its row
// off[e] + pos, and its token copied there) and moe_combine (y[t] = sum_j
// g[t, j] . O[row(t, j)] in fp32, one rounding; a dropped assignment has row
// -1 and adds nothing; a warp a token).
//
// Layout: bf16, contiguous, 16-byte aligned; X (rows, D), w12 (E, 2h, D),
// b12 (E, 2h), H (rows, h), w3 (E, D, h), b3 (E, D), O (rows, D); off int32
// (E + 1); D and h multiples of 8 (the TMA unit's 16-byte row strides); at
// most 128 experts (SDAR-30B-A3B's count).  Experts without biases pass null
// b12 and b3: the epilogue then adds nothing and loads nothing.  h need not
// be a multiple of K5a's 144 columns (768 = 5 1/3 tiles): the last column
// tile reads the rows past h of its half of w12 (the other half's, the next
// expert's, or the TMA unit's zeros past the tensor), computes them and
// stores nothing past h.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"  // swizzled tiles, wgmma descriptors and fences

namespace {

using attn::smem_u32;

constexpr int BM = 128;                   // rows of a tile: two warpgroups of 64
constexpr int BK = 64;                    // depth of a stage: one 128-byte swizzle atom
constexpr int STAGES = 4;                 // ring depth
constexpr int CONSUMERS = 256;            // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup (one thread of it copies)
// registers a thread after setmaxnreg: 2 x 128 x 232 + 128 x 40 <= 65536
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;
constexpr int MAX_EXPERTS = 128;
constexpr int W12_BN = 144;               // K5a: columns of H a tile
constexpr int W3_BN = 256;                // K5b: columns of O a tile
constexpr int STAGE_TILE_BYTES = 16 * 128;  // a consumer warp's 16 x 64 epilogue tile

// --- mbarriers and the TMA unit -------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// The producer's arrival, announcing the bytes its copies will complete.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits until the phase of parity `parity` has completed (a barrier starts in
// phase 0; waiting on parity 1 then returns at once).
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// A box of a 2-D tensor map (columns c0.., rows c1..) into shared memory;
// completion counted on `bar`.  Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// --- wgmma with both operands in shared memory ---------------------------------
//
// Accumulator layout as in attention_mma.cuh: warp w of the warpgroup owns
// rows 16 w .. 16 w + 15; lane 4 g + t holds d[j][0..1] at (g, 8 j + 2 t ..
// + 1) and d[j][2..3] at (g + 8, the same columns).

// d (64 x 144, this thread's 72 values) = A (64 x 16) . B (144 x 16)ᵀ (+ d if
// accumulate), both K-major 16-deep slices of swizzled shared-memory tiles.
__device__ __forceinline__ void wgmma_m64n144k16(float (&d)[18][4], uint64_t desc_a,
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),
        "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]),
        "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]),
        "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]),
        "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]),
        "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]),
        "+f"(d[17][2]), "+f"(d[17][3])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 256, this thread's 128 values) = A (64 x 16) . B (256 x 16)ᵀ (+ d if
// accumulate), both K-major 16-deep slices of swizzled shared-memory tiles.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[32][4], uint64_t desc_a,
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),
        "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]),
        "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]),
        "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]),
        "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]),
        "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]),
        "+f"(d[17][2]), "+f"(d[17][3]), "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]),
        "+f"(d[18][3]), "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]), "+f"(d[21][0]),
        "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]), "+f"(d[22][0]), "+f"(d[22][1]),
        "+f"(d[22][2]), "+f"(d[22][3]), "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]),
        "+f"(d[23][3]), "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]), "+f"(d[26][0]),
        "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]), "+f"(d[27][0]), "+f"(d[27][1]),
        "+f"(d[27][2]), "+f"(d[27][3]), "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]),
        "+f"(d[28][3]), "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]), "+f"(d[31][0]),
        "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}


template <int BN>
struct Mma;
template <>
struct Mma<W12_BN> {
  static __device__ __forceinline__ void run(float (&d)[W12_BN / 8][4], uint64_t a,
                                             uint64_t b, int acc) {
    wgmma_m64n144k16(d, a, b, acc);
  }
};
template <>
struct Mma<W3_BN> {
  static __device__ __forceinline__ void run(float (&d)[W3_BN / 8][4], uint64_t a,
                                             uint64_t b, int acc) {
    wgmma_m64n256k16(d, a, b, acc);
  }
};

// x . sigmoid(x) with the special-function unit's exponent and reciprocal
// (the epilogue's cost is its share of a tile's time); 0 for x -> -inf.
__device__ __forceinline__ float silu(float x) {
  return __fdividef(x, 1.f + __expf(-x));
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// --- the grouped product -------------------------------------------------------
//
// SWIGLU (K5a): B is w12 as (E * 2h, D); expert e's gate rows start at
// e * 2h, its value rows at e * 2h + h; n_out = h.  Otherwise (K5b): B is w3
// as (E * D, h), expert e's rows at e * D; n_out = D.  A is (rows, K).
template <int BN, bool SWIGLU>
__global__ void __launch_bounds__(THREADS, 1)
    moe_expert_gemm(const __grid_constant__ CUtensorMap tm_a,
                    const __grid_constant__ CUtensorMap tm_b, const int* __restrict__ off,
                    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                    int experts, int k_dim, int n_out) {
  constexpr int NB = SWIGLU ? 2 : 1;                 // B boxes a stage
  constexpr int A_BYTES = BM * BK * 2;
  constexpr int B_BYTES = BN * BK * 2;
  constexpr int STAGE_BYTES = A_BYTES + NB * B_BYTES;
  static_assert(B_BYTES % 1024 == 0 && A_BYTES % 1024 == 0, "swizzle atoms stay aligned");
  const int b_rows = SWIGLU ? 2 * n_out : n_out;     // B rows of one expert

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  __shared__ int tile_start[MAX_EXPERTS + 1];        // first tile of each expert
  __shared__ int row_off[MAX_EXPERTS + 1];
  // the ring at a multiple of 1024 bytes: the swizzle pattern follows address bits
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;

  const int n_tiles = (n_out + BN - 1) / BN;
  if (threadIdx.x == 0) {
    int tiles = 0;
    for (int e = 0; e <= experts; ++e) {
      row_off[e] = off[e];
      tile_start[e] = tiles;
      if (e < experts) tiles += (off[e + 1] - off[e] + BM - 1) / BM * n_tiles;
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int total = tile_start[experts];
  const int k_tiles = (k_dim + BK - 1) / BK;

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x != CONSUMERS) return;
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      int e = 0;
      while (tile >= tile_start[e + 1]) ++e;
      const int local = tile - tile_start[e];
      const int row0 = row_off[e] + local / n_tiles * BM;
      const int n0 = local % n_tiles * BN;
      for (int kt = 0; kt < k_tiles; ++kt) {
        const uint32_t bar = smem_u32(&full_bar[stage]);
        mbar_wait(smem_u32(&empty_bar[stage]), phase ^ 1);
        mbar_expect_tx(bar, STAGE_BYTES);
        const uint32_t dst = ring + stage * STAGE_BYTES;
        tma_load(dst, &tm_a, bar, kt * BK, row0);
        tma_load(dst + A_BYTES, &tm_b, bar, kt * BK, e * b_rows + n0);
        if (SWIGLU) tma_load(dst + A_BYTES + B_BYTES, &tm_b, bar, kt * BK, e * b_rows + n_out + n0);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  float acc[BN / 8][4];
  float acc2[SWIGLU ? BN / 8 : 1][4];
  attn::zero_acc(acc);  // read by no product (each tile's first one has scale-d 0)
  attn::zero_acc(acc2);
  int stage = 0, phase = 0;
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    int e = 0;
    while (tile >= tile_start[e + 1]) ++e;
    const int local = tile - tile_start[e];
    const int row0 = row_off[e] + local / n_tiles * BM;
    const int row_end = row_off[e + 1];
    const int n0 = local % n_tiles * BN;

    int prev = 0;
    for (int kt = 0; kt < k_tiles; ++kt) {
      mbar_wait(smem_u32(&full_bar[stage]), phase);
      const uint32_t base = ring + stage * STAGE_BYTES;
      const uint64_t da = attn::wgmma_desc(base + wg * 64 * 128);
      const uint64_t db = attn::wgmma_desc(base + A_BYTES);
      attn::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const int accumulate = kt > 0 || kk > 0;
        Mma<BN>::run(acc, da + kk * attn::WGMMA_K_STEP, db + kk * attn::WGMMA_K_STEP,
                     accumulate);
        if constexpr (SWIGLU)
          Mma<BN>::run(acc2, da + kk * attn::WGMMA_K_STEP,
                       db + (B_BYTES >> 4) + kk * attn::WGMMA_K_STEP, accumulate);
      }
      attn::wgmma_commit();
      // the previous stage's products are done: hand its buffers back
      attn::wgmma_wait<1>();
      if (kt > 0 && tid == 0) mbar_arrive(smem_u32(&empty_bar[prev]));
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    // the tile's bias, loaded while the last products run (loads that wait
    // one after another inside the epilogue cost a third of its time): this
    // thread's columns 8 j + 2 t and + 1, clamped into the row (what lies
    // past n_out is not stored)
    const __nv_bfloat16* bp = bias + (long long)e * b_rows + n0;
    const int last = n_out - n0 - 2;
    uint32_t bias1[BN / 8];
    uint32_t bias2[SWIGLU ? BN / 8 : 1];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = min(8 * j + 2 * t, last);
      bias1[j] = bias == nullptr ? 0u : __ldg(reinterpret_cast<const unsigned int*>(bp + col));
      if constexpr (SWIGLU)
        bias2[j] = bias == nullptr
                       ? 0u
                       : __ldg(reinterpret_cast<const unsigned int*>(bp + n_out + col));
    }
    attn::wgmma_wait<0>();
    attn::wgmma_pin(acc);
    if constexpr (SWIGLU) attn::wgmma_pin(acc2);
    if (tid == 0) mbar_arrive(smem_u32(&empty_bar[prev]));

#ifdef K5_NO_EPILOGUE  // timing only (ops/kernel_times.py --define): no stores
    if (n0 < 0) out[row_end] = __float2bfloat16(acc[0][0] + acc2[0][0]);
    continue;
#endif
    // epilogue: + bias (and the SwiGLU), one rounding, then out through the
    // warp's 16 x 64 staging tile in 64-column chunks, so that each store
    // writes whole 128-byte rows (the accumulator layout would write 16
    // bytes of 8 rows a store: 8x the memory transactions, a third of the
    // kernel's time).  Rows past the expert's and columns past n_out or the
    // tile are not stored.
    unsigned char* staging = smem_raw + (ring - smem_u32(smem_raw)) + STAGES * STAGE_BYTES +
                             (wg * 4 + warp) * STAGE_TILE_BYTES;
    const int lane = tid & 31;
    const int r0 = row0 + wg * 64 + warp * 16;  // the warp's first row
#pragma unroll
    for (int c = 0; c < (BN + 63) / 64; ++c) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * c + jj;
        if (j >= BN / 8) break;
        const float2 b1 = unpack_bf16x2(bias1[j]);
        float v0 = acc[j][0] + b1.x, v1 = acc[j][1] + b1.y;
        float v2 = acc[j][2] + b1.x, v3 = acc[j][3] + b1.y;
        if constexpr (SWIGLU) {
          const float2 b2 = unpack_bf16x2(bias2[j]);
          v0 = silu(v0) * (acc2[j][0] + b2.x);
          v1 = silu(v1) * (acc2[j][1] + b2.y);
          v2 = silu(v2) * (acc2[j][2] + b2.x);
          v3 = silu(v3) * (acc2[j][3] + b2.y);
        }
        *reinterpret_cast<uint32_t*>(staging + attn::tile_off(g, jj) + 4 * t) =
            attn::pack_bf16(v0, v1);
        *reinterpret_cast<uint32_t*>(staging + attn::tile_off(g + 8, jj) + 4 * t) =
            attn::pack_bf16(v2, v3);
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // 16 rows of 8 chunks: 4 rows a round
        const int row = (lane >> 3) + 4 * q;
        const int chunk = lane & 7;
        const int col = 64 * c + 8 * chunk;  // within the tile
        if (col < BN && n0 + col < n_out && r0 + row < row_end)
          *reinterpret_cast<int4*>(out + (long long)(r0 + row) * n_out + n0 + col) =
              *reinterpret_cast<const int4*>(staging + attn::tile_off(row, chunk));
      }
      __syncwarp();
    }
  }
}

template <int BN, bool SWIGLU>
constexpr int SMEM_BYTES = STAGES * (BM * BK * 2 + (SWIGLU ? 2 : 1) * BN * BK * 2) +
                           CONSUMERS / 32 * STAGE_TILE_BYTES + 1024;

// --- the memory passes -----------------------------------------------------------

constexpr int PASS_THREADS = 256;  // eight warps, one row each
constexpr int PACK_THREADS = 1024;

// off[] (E + 1) from each expert's assignment count, capped at cap: one
// block; each thread adds its assignments to the experts' counts in shared
// memory (integer atomics: exact, so every run gives the same offsets), then
// one warp sums the capped counts in expert order, MAX_EXPERTS / 32 experts a
// lane.  idx (tokens, k) int64 with element strides i0, i1.
__global__ void __launch_bounds__(PACK_THREADS)
    moe_count_kernel(const long long* __restrict__ idx, long long i0, long long i1, int tokens,
                     int k, int experts, int cap, int* __restrict__ off) {
  constexpr int PER_LANE = MAX_EXPERTS / 32;
  __shared__ int count[MAX_EXPERTS];
  for (int e = threadIdx.x; e < MAX_EXPERTS; e += PACK_THREADS) count[e] = 0;
  __syncthreads();
  const int n = tokens * k;
  for (int a = threadIdx.x; a < n; a += PACK_THREADS) {
    const int t = a / k;
    atomicAdd(&count[(int)idx[t * i0 + (a - t * k) * i1]], 1);
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int rows[PER_LANE];
    int mine = 0;  // this lane's experts PER_LANE * lane .. + PER_LANE - 1
#pragma unroll
    for (int s = 0; s < PER_LANE; ++s) {
      const int e = PER_LANE * lane + s;
      rows[s] = e < experts ? min(count[e], cap) : 0;
      mine += rows[s];
    }
    int before = mine;  // inclusive scan of the lanes' sums
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, before, d);
      if (lane >= d) before += up;
    }
    before -= mine;
#pragma unroll
    for (int s = 0; s < PER_LANE; ++s) {
      const int e = PER_LANE * lane + s;
      if (e < experts) off[e] = before;
      before += rows[s];
    }
    if (lane == 31) off[experts] = before;
  }
}

// Each assignment's row off[e] + pos into row (-1 where not kept) and, for a
// queued one (pos < cap), its token copied to that row of xp: a warp an
// assignment.  Rows of xp at and past off[E] are not written.  idx, pos
// (int64) and keep (bool) are (tokens, k) with the element strides given:
// the routing's are transposed views.
__global__ void __launch_bounds__(PASS_THREADS)
    moe_dispatch_kernel(const int4* __restrict__ x, const long long* __restrict__ idx,
                        const long long* __restrict__ pos, const bool* __restrict__ keep,
                        long long i0, long long i1, long long p0, long long p1, long long q0,
                        long long q1, const int* __restrict__ off, int tokens, int k, int cap,
                        int chunks, int* __restrict__ row, int4* __restrict__ xp) {
  const int lane = threadIdx.x & 31;
  const int n = tokens * k;
  for (int a = blockIdx.x * (PASS_THREADS / 32) + (threadIdx.x >> 5); a < n;
       a += gridDim.x * (PASS_THREADS / 32)) {
    const int t = a / k;
    const int j = a - t * k;
    const long long p = pos[t * p0 + j * p1];
    const int r = off[(int)idx[t * i0 + j * i1]] + (int)p;
    if (lane == 0) row[a] = keep[t * q0 + j * q1] ? r : -1;
    if (p < cap) {
      const int4* src = x + (long long)t * chunks;
      int4* dst = xp + (long long)r * chunks;
#pragma unroll 1
      for (int c = lane; c < chunks; c += 32) dst[c] = src[c];
    }
  }
}

// y[t] = sum_j g[t, j] . O[row[t, j]] over the k assignments of token t, in
// order, fp32, one rounding; row -1 (dropped) adds nothing.
__global__ void __launch_bounds__(PASS_THREADS)
    moe_combine_kernel(const int4* __restrict__ o, const int* __restrict__ row,
                       const __nv_bfloat16* __restrict__ gate, int4* __restrict__ y, int tokens,
                       int k, int chunks) {
  const int lane = threadIdx.x & 31;
  for (int tk = blockIdx.x * (PASS_THREADS / 32) + (threadIdx.x >> 5); tk < tokens;
       tk += gridDim.x * (PASS_THREADS / 32)) {
    for (int c = lane; c < chunks; c += 32) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < k; ++j) {
        const int r = row[(long long)tk * k + j];
        if (r < 0) continue;
        const float gj = __bfloat162float(gate[(long long)tk * k + j]);
        const int4 v = o[(long long)r * chunks + c];
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(h[i]);
          acc[2 * i] = fmaf(gj, f.x, acc[2 * i]);
          acc[2 * i + 1] = fmaf(gj, f.y, acc[2 * i + 1]);
        }
      }
      int4 packed;
      uint32_t* p = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = attn::pack_bf16(acc[2 * i], acc[2 * i + 1]);
      y[(long long)tk * chunks + c] = packed;
    }
  }
}

// --- host side -------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found once through the runtime (no link
// against libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, cols) bf16 row-major tensor read in boxes of 64 columns x box_rows
// rows, 128-byte swizzled.  0 or the cudaError_t to return.
int tensor_map(CUtensorMap* map, const void* ptr, long long rows, long long cols,
               int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {BK, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BN, bool SWIGLU>
int launch_gemm(const void* a, long long a_rows, const void* b, long long b_rows,
                const int* off, const void* bias, void* out, int experts, int k_dim, int n_out,
                int sms, cudaStream_t st) {
  CUtensorMap ma, mb;
  int err = tensor_map(&ma, a, a_rows, k_dim, BM);
  if (err == 0) err = tensor_map(&mb, b, b_rows, k_dim, BN);
  if (err != 0) return err;
  constexpr int smem = SMEM_BYTES<BN, SWIGLU>;
  const cudaError_t attr = cudaFuncSetAttribute(
      moe_expert_gemm<BN, SWIGLU>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  // at most one tile per 128 rows and per expert boundary, each n_out / BN wide
  const long long tiles = ((a_rows + BM - 1) / BM + experts) * ((n_out + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  moe_expert_gemm<BN, SWIGLU><<<grid, THREADS, smem, st>>>(
      ma, mb, off, static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out),
      experts, k_dim, n_out);
  return (int)cudaGetLastError();
}

int pass_grid(long long rows, int sms) {
  const long long blocks = (rows + PASS_THREADS / 32 - 1) / (PASS_THREADS / 32);
  return (int)(blocks < 8LL * sms ? blocks : 8LL * sms);
}

}  // namespace

// K5a then K5b on each expert's packed rows: H (rows, hidden) = silu(X.W1ᵀ +
// b1) * (X.W2ᵀ + b2), O (rows, d) = H.W3ᵀ + b3; x (rows, d), w12 (E, 2 hidden,
// d), b12 (E, 2 hidden) or null, w3 (E, d, hidden), b3 (E, d) or null, off
// (E + 1) int32.
// which: 3 both, 1 K5a alone, 2 K5b alone (timing).  sms: the card's SM count
// (one persistent block each).  Returns the cudaError_t.
extern "C" int moe_experts(const void* x, const void* w12, const void* b12, const void* w3,
                           const void* b3, const int* off, void* h, void* o, int rows, int d,
                           int hidden, int experts, int which, int sms, void* stream) {
  if (rows <= 0 || d <= 0 || hidden <= 0 || d % 8 || hidden % 8 || experts <= 0 ||
      experts > MAX_EXPERTS || sms <= 0 || which < 1 || which > 3)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (which & 1)
    err = launch_gemm<W12_BN, true>(x, rows, w12, 2LL * hidden * experts, off, b12, h, experts,
                                    d, hidden, sms, st);
  if (err == 0 && (which & 2))
    err = launch_gemm<W3_BN, false>(h, rows, w3, (long long)d * experts, off, b3, o, experts,
                                    hidden, d, sms, st);
  return err;
}

// The packed layout of a routing and the packed tokens: off (E + 1), row
// (tokens, k) int32 and xp (at least off[E] rows of d) from x (tokens, d)
// bf16 and the routing's idx, pos (int64), keep (bool), strides in elements.
extern "C" int moe_dispatch(const void* x, const void* idx, const void* pos, const void* keep,
                            long long i0, long long i1, long long p0, long long p1,
                            long long q0, long long q1, int tokens, int k, int experts, int cap,
                            int d, int sms, int* off, int* row, void* xp, void* stream) {
  if (tokens <= 0 || k <= 0 || experts <= 0 || experts > MAX_EXPERTS || cap <= 0 || d <= 0 ||
      d % 8 || sms <= 0 || (long long)tokens * k > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* ip = static_cast<const long long*>(idx);
  moe_count_kernel<<<1, PACK_THREADS, 0, st>>>(ip, i0, i1, tokens, k, experts, cap, off);
  moe_dispatch_kernel<<<pass_grid((long long)tokens * k, sms), PASS_THREADS, 0, st>>>(
      static_cast<const int4*>(x), ip, static_cast<const long long*>(pos),
      static_cast<const bool*>(keep), i0, i1, p0, p1, q0, q1, off, tokens, k, cap, d / 8, row,
      static_cast<int4*>(xp));
  return (int)cudaGetLastError();
}

// y (tokens, d) = the gated sum of each token's k rows of o; row (tokens, k)
// int32, -1 where dropped; gate (tokens, k) bf16.
extern "C" int moe_combine(const void* o, const int* row, const void* gate, void* y, int tokens,
                           int k, int d, int sms, void* stream) {
  if (tokens <= 0 || k <= 0 || d <= 0 || d % 8 || sms <= 0) return (int)cudaErrorInvalidValue;
  moe_combine_kernel<<<pass_grid(tokens, sms), PASS_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(o), row, static_cast<const __nv_bfloat16*>(gate),
      static_cast<int4*>(y), tokens, k, d / 8);
  return (int)cudaGetLastError();
}

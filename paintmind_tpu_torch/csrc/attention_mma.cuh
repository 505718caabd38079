// Building blocks of the bf16 tensor-core attention kernels (sm_90a), shared
// by flash_attention.cu (forward) and flash_attention_bwd.cu (backward).
//
// Both stream 64-row tiles of (rows, H, D) bf16 operands through shared
// memory with cp.async, multiply them with wgmma (one warpgroup of 4 warps
// owns 64 rows) and keep every score tile in registers.  The kernels are
// compiled for D = 64 and D = 128; the wrapper zero-pads other head dims up to
// the next of the two (zero columns add nothing to q.k^T, and the padded
// columns of the outputs are sliced off).
//
// Shared-memory sub-tile: 64 rows of 128 bytes (64 bf16), each row cut into
// eight 16-byte chunks; chunk c of row r lies at chunk c ^ (r & 7).  With the
// sub-tile at a multiple of 1024 bytes this is the 128-byte swizzle of a wgmma
// descriptor; the 8 chunks of a row that cp.async writes, and the 8 rows of a
// column of chunks that the tensor cores read, fall on 8 different bank
// groups, where unswizzled 128-byte rows would put all 8 rows on the same
// banks.  A 64-row tile of D columns is D / 64 such sub-tiles, one after the
// other: sub-tile j holds columns 64 j .. 64 j + 63 (one swizzle atom is 128
// bytes wide, so a 256-byte row of D = 128 is two atoms).  A product that runs
// along D (S = Q.K^T) takes its 16-deep k-steps from sub-tile kk / 4; a
// product whose output is D wide (O = P.V) is one m64n64 product per sub-tile.
//
// wgmma.m64nNk16 registers: warp w of the warpgroup owns rows 16 w .. 16 w +
// 15, and within the warp, lane = 4 * g + t (g = lane / 4, t = lane % 4):
//   A (16 x 16, bf16 pairs):  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   D (16 x 8 per tile j, fp32):  d[j][0] (g, 8j+2t)  d[j][1] (g, 8j+2t+1)
//                                 d[j][2] (g+8, 8j+2t)  d[j][3] (g+8, 8j+2t+1)
// Two neighbouring D tiles (columns 16 kk .. 16 kk + 15) are therefore, thread
// for thread, the A fragment of k-block kk once rounded to bf16: P and dS go
// from one product into the next without touching shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr int SUB = 64;                       // columns of a sub-tile
constexpr int TILE = 64;                      // rows of a shared-memory tile
constexpr int ROW_BYTES = SUB * 2;            // one bf16 row of a sub-tile
constexpr int TILE_BYTES = TILE * ROW_BYTES;  // one sub-tile, 8 KB
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a swizzled tile.
__device__ __forceinline__ int tile_off(int row, int chunk) {
  return row * ROW_BYTES + ((chunk ^ (row & 7)) << 4);
}

// 16-byte asynchronous copy global -> shared.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(__cvta_generic_to_global(src)) : "memory");
}

// The same; zeros when !valid (src is not read).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(__cvta_generic_to_global(src)), "r"(n) : "memory");
}

// 4-byte asynchronous copy global -> shared; zero when !valid.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(__cvta_generic_to_global(src)), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One thread's share of the copies that bring 64-row tiles of a (rows, H, D)
// bf16 operand of one (batch, head) into swizzled shared-memory tiles (D / 64
// sub-tiles each): eight neighbouring threads copy one 128-byte row of a
// sub-tile, and a thread's copies lie THREADS / 8 rows apart, a multiple of 8,
// so they share one swizzled chunk position.  What does not change from tile
// to tile is worked out once, here: the copies of a tile are then an address
// step each.
template <int THREADS, int D>
struct TileCopier {
  static constexpr int NSUB = D / SUB;                // sub-tiles per tile
  static constexpr int COPIES = TILE * 8 / THREADS;  // per sub-tile and thread
  static constexpr int ROW_STEP = THREADS / 8;       // rows between them
  static_assert(D % SUB == 0, "D is a multiple of 64");
  static_assert((TILE * 8) % THREADS == 0 && ROW_STEP % 8 == 0, "whole, aligned rounds");

  const __nv_bfloat16* base;  // row 0 of the operand, at this thread's chunk
  long long tok;              // elements between consecutive rows
  int n_rows;                 // rows of the operand: rows at or past it are zeros
  int row;                    // this thread's first row of a tile
  int off;                    // and its byte offset in the tile

  __device__ __forceinline__ TileCopier(const __nv_bfloat16* operand, long long tok_,
                                        int n_rows_, int tid)
      : base(operand + (tid & 7) * 8), tok(tok_), n_rows(n_rows_), row(tid >> 3),
        off(tile_off(tid >> 3, tid & 7)) {}

  // Rows r0 .. r0 + 63 of the operand into the tile at shared address `tile`.
  __device__ __forceinline__ void operator()(uint32_t tile, int r0) const {
    const __nv_bfloat16* src = base + (long long)(r0 + row) * tok;
    if (r0 + TILE <= n_rows) {
#pragma unroll
      for (int j = 0; j < NSUB; ++j)
#pragma unroll
        for (int c = 0; c < COPIES; ++c)
          cp_async_16(tile + j * TILE_BYTES + off + c * ROW_STEP * ROW_BYTES,
                      src + j * SUB + c * ROW_STEP * tok);
    } else {  // the ragged edge: zero-fill, and read nothing past the operand
#pragma unroll
      for (int c = 0; c < COPIES; ++c) {
        const bool ok = r0 + row + c * ROW_STEP < n_rows;
#pragma unroll
        for (int j = 0; j < NSUB; ++j)
          cp_async_16(tile + j * TILE_BYTES + off + c * ROW_STEP * ROW_BYTES,
                      ok ? src + j * SUB + c * ROW_STEP * tok : base, ok);
      }
    }
  }
};

// Two fp32 values rounded to bf16, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// 2^x on the special-function unit; 2^-inf = +0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Reductions over the four lanes (t = 0..3) that share an accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// Accumulator tiles, rounded to bf16, as A fragments: tiles 2 kk and 2 kk + 1
// are k-block kk.
template <int NT>
__device__ __forceinline__ void pack_a_frags(uint32_t (&a)[NT / 2][4], const float (&p)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    a[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
}

// --- wgmma -----------------------------------------------------------------
//
// wgmma.m64n64k16 reads B (and A, unless it is given in registers) straight
// from a shared-memory tile through a 64-bit descriptor and runs
// asynchronously.  In the swizzled tile above, groups of 8 rows lie 1024 bytes
// apart (the descriptor's stride byte offset).  As "K-major" operand (the
// product runs along a row: S = Q.K^T) a step of 16 along k moves the start by
// 32 bytes; as "MN-major" B (the product runs over the rows: O = P.V,
// transpose bit set) it moves it by 16 rows.

__device__ __forceinline__ uint64_t wgmma_desc(uint32_t tile) {
  return (uint64_t)((tile & 0x3FFFF) >> 4)   // start address, 16-byte units
         | ((uint64_t)1 << 16)               // leading byte offset: one swizzle atom, unused
         | ((uint64_t)(1024 >> 4) << 32)     // stride byte offset between 8-row groups
         | ((uint64_t)1 << 62);              // 128-byte swizzle
}
constexpr uint64_t WGMMA_K_STEP = 32 >> 4;                // K-major: 16 elements along a row
constexpr uint64_t WGMMA_ROW_STEP = 16 * ROW_BYTES >> 4;  // MN-major: 16 rows
constexpr uint64_t WGMMA_SUB_STEP = TILE_BYTES >> 4;      // the next sub-tile

// Descriptor offset of k-step kk (16 columns) of a K-major tile of D / 64
// sub-tiles: four k-steps a sub-tile.
__device__ __forceinline__ uint64_t k_step(int kk) {
  return (kk >> 2) * WGMMA_SUB_STEP + (kk & 3) * WGMMA_K_STEP;
}

// Orders register writes (accumulators, A fragments) before the wgmmas that follow.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Makes shared-memory writes of the generic proxy (cp.async, st.shared)
// visible to the async proxy through which wgmma reads its descriptors' tiles.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The compiler sees a wgmma as done when its asm statement ends, but the
// tensor cores go on reading its A registers and writing its accumulators
// until the wait.  Naming the registers as read and written here, after the
// wait, keeps every use of an accumulator behind the wait and every A
// register alive (not handed to another value) up to it.
template <int R, int C>
__device__ __forceinline__ void wgmma_pin(float (&x)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+f"(x[i][j]) :: "memory");
}
template <int R, int C>
__device__ __forceinline__ void wgmma_pin(uint32_t (&x)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(x[i][j]) :: "memory");
}

// d (64 x 64, this thread's 32 values) = a (64 x 16, registers) . B (+ d if
// accumulate), B a 16-deep slice of a shared-memory tile; TRANS_B = 1 for an
// MN-major B.  For A fragments that are formed anew before each product (P,
// dS).  Fragments loaded once and kept across the iterations of a loop (Q)
// were handed to other values inside the loop by ptxas (CUDA 12.8), although
// the PTX kept them live: such operands go through shared memory instead.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(TRANS_B));
}

// d (64 x 64) = A (64 x 16) . B (+ d if accumulate), both 16-deep slices of
// shared-memory tiles, A K-major; TRANS_B = 1 for an MN-major B.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4], uint64_t desc_a,
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

// The warp's 16 x 64 accumulator, rounded to bf16, goes to rows row0 ..
// row0 + 15 of a staging sub-tile and from there to global rows g0 + row0 ..
// as 16-byte stores (8 lanes write one 128-byte row); rows at or past n_rows
// are not stored.  Only this warp touches these tile rows.  For D = 128 the
// caller stores each 64-column half of its output through its own sub-tile,
// with `base` moved by 64 columns.
__device__ __forceinline__ void store_rows(unsigned char* tile, int row0,
                                           const float (&acc)[8][4], __nv_bfloat16* base,
                                           long long tok, int g0, int n_rows, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(tile + tile_off(row0 + g, j) + 4 * t) =
        pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(tile + tile_off(row0 + g + 8, j) + 4 * t) =
        pack_bf16(acc[j][2], acc[j][3]);
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int i = lane + 32 * c;
    const int row = row0 + (i >> 3);
    const int chunk = i & 7;
    if (g0 + row < n_rows)
      *reinterpret_cast<int4*>(base + (long long)(g0 + row) * tok + chunk * 8) =
          *reinterpret_cast<const int4*>(tile + tile_off(row, chunk));
  }
}

}  // namespace attn

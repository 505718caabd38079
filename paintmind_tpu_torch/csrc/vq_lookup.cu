// Fused codebook nearest-neighbour lookup for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paintmind_tpu/ops/vq_lookup.py::
// _fused_nearest_codes (kernel _lookup_kernel): argmax_j z.e_j over
// l2-normalised rows, ties to the lowest index, without writing the
// (T, C) score matrix to device memory.
//
// Bound on this card: the 2*T*C*dim fp32 operations (the operands are ~2 MB
// at dim 32).
// They stay on the fp32 CUDA cores: the result must equal fp32 argmax except
// at score gaps under 1e-5, which one tensor-core pass (three decimal digits)
// cannot give.  What limits FFMA on the CUDA cores is the shared-memory loads
// beside them, so the design is a register-tiled product:
//
//   * A block owns BT = 64 tokens and walks the codebook in tiles of BC = 128
//     codes.  A thread holds 4 x 8 scores in registers: per 16-byte step in d
//     it loads 4 + 8 float4 and issues 128 FFMA (1 : 10.7, where one token
//     against one code at a time is 1 : 4).
//   * Both tiles are row-major in shared memory with rows padded to DZ + 4
//     floats (36 at DZ = 32; DZ + 4 is 4 times an odd number): row r starts at
//     bank 4r mod 32 (times that odd number), so the eight lanes of a warp that read
//     eight consecutive code rows in one LDS.128 phase touch every bank once,
//     and lanes that share a token or a code read one address (broadcast).  A
//     thread's codes are cl, cl + 16, ... (cl its code lane): ascending.
//   * Codebook tiles come in by 16-byte cp.async into a two-stage ring while
//     the previous tile is multiplied; rows past C are zero-filled and their
//     scores are skipped by index.
//   * Each thread folds its scores into a running (best, index) per token
//     under a strict '>' in ascending code order, so equal scores keep the
//     lower index within a thread.  Across the lanes of a warp that share a
//     token (shuffles), across the two warps that split a tile's codes (shared
//     memory) and across blocks the rule is explicit: greater value, or equal
//     value and lower index.
//   * T / 64 blocks do not fill 132 SMs below T of some 8000, so the codebook
//     is also split over gridDim.y (the caller chooses the number of splits
//     from T and the SM count).  Each split's best goes through a 64-bit
//     atomicMax on (order-preserving bits of the score << 32) |
//     (0xFFFFFFFF - index) into scratch that the caller zeroed, and a second
//     small kernel unpacks the index.  A maximum does not depend on the order
//     of the atomics, so the result is the same bits on every run and ties
//     still go to the lower index.  With one split there is no scratch and no
//     second kernel: the block writes the index itself.
//   * The code dim is compiled for DZ = 8, 16 and 32 (the wrapper zero-pads
//     other dims up to the next: zero columns change no score).  Above 32 the
//     wrapper pads to a multiple of 64 and the kernel walks each codebook
//     tile in chunks of DZ = 64 dims, its 4 x 8 sums carried from chunk to
//     chunk; the block's token chunk then rides in the ring with the code
//     chunk, so any code dim fits a fixed amount of shared memory.
//
// Layout: z (T, dim) fp32, e (C, dim) fp32, out (T,) int32, contiguous, 16-byte
// aligned; dim is 8, 16, 32 or a multiple of 64.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"  // cp.async wrappers

namespace {

using attn::cp_async_16;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::smem_u32;

constexpr int BT = 64;        // tokens per block
constexpr int BC = 128;       // codes per tile
constexpr int TM = 4;         // tokens per thread
constexpr int TN = 8;         // codes per thread
constexpr int CODE_LANES = BC / TN;   // 16: two warps of 8 code lanes
constexpr int TOKEN_LANES = BT / TM;  // 16: eight warps of 4 token lanes, in pairs
constexpr int THREADS = TOKEN_LANES * CODE_LANES;
constexpr unsigned FULL = 0xffffffffu;

// Dynamic shared memory of one variant: the two ring stages of a code tile,
// and the token tile (one, or one per stage when chunked); rows padded to
// DZ + 4 floats.
template <int DZ, bool CHUNKED>
constexpr int SMEM_BYTES = (2 * BC + (CHUNKED ? 2 : 1) * BT) * (DZ + 4) * 4;

// (value, index) a before (value, index) b: argmax's order, first index on a tie
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Bits that order as the floats do (negative, zero, positive; -0 is made +0
// first so that equal scores give equal bits), over the complement of the
// index: the maximum key is the greatest score at its lowest index.
__device__ __forceinline__ unsigned long long pack_key(float v, int i) {
  uint32_t u = __float_as_uint(__fadd_rn(v, 0.f));
  u ^= (u >> 31) ? 0xFFFFFFFFu : 0x80000000u;
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (uint32_t)i);
}

// DZ: dims in shared memory at a time; CHUNKED: dim is a multiple of DZ and
// each codebook tile is walked in dim / DZ chunks (else dim == DZ).
template <int DZ, bool CHUNKED>
__global__ void __launch_bounds__(THREADS, CHUNKED ? 1 : 2)  // two blocks an SM: see codebook_splits
vq_lookup(const float* __restrict__ z, const float* __restrict__ e, int* __restrict__ out,
          unsigned long long* __restrict__ keys, int T, int C, int dim, int tiles_per_split) {
  constexpr int ROW = DZ + 4;   // padded shared-memory row, floats
  constexpr int CH = DZ / 4;    // 16-byte chunks of a row
  extern __shared__ __align__(16) float smem[];
  float* const es = smem;                // [2][BC * ROW]
  float* const zs = smem + 2 * BC * ROW;  // [CHUNKED ? 2 : 1][BT * ROW]
  __shared__ float red_v[BT];
  __shared__ int red_i[BT];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cl = (warp & 1) * 8 + (lane & 7);    // code lane, 0..15
  const int tl = (warp >> 1) * 4 + (lane >> 3);  // token lane, 0..15
  const int t0 = blockIdx.x * BT;
  const int n_tiles = (C + BC - 1) / BC;
  const int tile_begin = blockIdx.y * tiles_per_split;
  const int tile_end = min(n_tiles, tile_begin + tiles_per_split);
  const int n_chunks = CHUNKED ? dim / DZ : 1;
  const int n_steps = (tile_end - tile_begin) * n_chunks;

  // A code tile's chunk is BC rows of DZ floats: thread i copies the 16-byte
  // pieces i, i + THREADS, ... to row (piece / CH), column piece % CH.
  constexpr int COPIES = BC * CH / THREADS;
  constexpr int COPY_ROWS = THREADS / CH;  // rows between a thread's copies
  const int crow = tid / CH;
  const uint32_t tile_dst = (crow * ROW + (tid % CH) * 4) * 4;
  auto copy_codes = [&](int stage, int tile, int chunk) {
    const uint32_t dst = smem_u32(es + stage * BC * ROW) + tile_dst;
    const float* src = e + (long long)(tile * BC + crow) * dim + chunk * DZ + (tid % CH) * 4;
    if (tile * BC + BC <= C) {
#pragma unroll
      for (int j = 0; j < COPIES; ++j)
        cp_async_16(dst + j * COPY_ROWS * ROW * 4, src + (long long)j * COPY_ROWS * dim);
    } else {  // the ragged last tile: zero-fill, and read nothing past e
#pragma unroll
      for (int j = 0; j < COPIES; ++j) {
        const bool ok = tile * BC + crow + j * COPY_ROWS < C;
        cp_async_16(dst + j * COPY_ROWS * ROW * 4, ok ? src + (long long)j * COPY_ROWS * dim : e,
                    ok);
      }
    }
  };
  auto copy_tokens = [&](float* tile, int chunk) {
    const uint32_t dst = smem_u32(tile);
    for (int i = tid; i < BT * CH; i += THREADS) {
      const int row = i / CH, col = i % CH;
      const bool ok = t0 + row < T;
      cp_async_16(dst + (row * ROW + col * 4) * 4,
                  ok ? z + (long long)(t0 + row) * dim + chunk * DZ + col * 4 : z, ok);
    }
  };
  // step s: codebook tile tile_begin + s / n_chunks, dims chunk s % n_chunks
  auto copy_step = [&](int s) {
    const int stage = s & 1;
    copy_codes(stage, tile_begin + s / n_chunks, s % n_chunks);
    if (CHUNKED) copy_tokens(zs + stage * BT * ROW, s % n_chunks);
  };

  if (!CHUNKED) copy_tokens(zs, 0);
  copy_step(0);
  cp_async_commit();

  float best[TM];
  int arg[TM];
#pragma unroll
  for (int t = 0; t < TM; ++t) {
    best[t] = -INFINITY;
    arg[t] = tile_begin * BC;
  }

  float acc[TM][TN];
  for (int s = 0; s < n_steps; ++s) {
    const int stage = s & 1;
    const int tile = tile_begin + s / n_chunks;
    const int chunk = s % n_chunks;
    cp_async_wait<0>();
    __syncthreads();  // the step has landed; every thread is done with the other stage
    if (s + 1 < n_steps) copy_step(s + 1);
    cp_async_commit();

    if (chunk == 0) {
#pragma unroll
      for (int t = 0; t < TM; ++t)
#pragma unroll
        for (int i = 0; i < TN; ++i) acc[t][i] = 0.f;
    }
    const float4* zp =
        reinterpret_cast<const float4*>(zs + (CHUNKED ? stage * BT * ROW : 0)) + tl * (ROW / 4);
    const float4* ep = reinterpret_cast<const float4*>(es + stage * BC * ROW) + cl * (ROW / 4);
#pragma unroll
    for (int d4 = 0; d4 < DZ / 4; ++d4) {
      float4 zv[TM];
#pragma unroll
      for (int t = 0; t < TM; ++t) zv[t] = zp[t * TOKEN_LANES * (ROW / 4) + d4];
#pragma unroll
      for (int i = 0; i < TN; ++i) {
        const float4 ev = ep[i * CODE_LANES * (ROW / 4) + d4];
#pragma unroll
        for (int t = 0; t < TM; ++t) {
          acc[t][i] = fmaf(zv[t].x, ev.x, acc[t][i]);
          acc[t][i] = fmaf(zv[t].y, ev.y, acc[t][i]);
          acc[t][i] = fmaf(zv[t].z, ev.z, acc[t][i]);
          acc[t][i] = fmaf(zv[t].w, ev.w, acc[t][i]);
        }
      }
    }
    if (chunk != n_chunks - 1) continue;  // the tile's scores are not complete yet

    // Fold the tile into the running best in ascending code order: a strict
    // '>' keeps the lower index on equal scores.  (The tile's maximum first and
    // its index only when it wins was slower: with 128 running bests a warp,
    // some lane wins in nearly every tile.)
    const int c0 = tile * BC + cl;
    const bool whole = tile * BC + BC <= C;
#pragma unroll
    for (int i = 0; i < TN; ++i) {
      const int code = c0 + i * CODE_LANES;
      if (whole || code < C) {  // codes past C cannot win
#pragma unroll
        for (int t = 0; t < TM; ++t) {
#ifdef K2_NO_FOLD  // timing experiment only (kernel_times.py): no compare, no select
          best[t] += acc[t][i];
#else
          if (acc[t][i] > best[t]) {
            best[t] = acc[t][i];
            arg[t] = code;
          }
#endif
        }
      }
    }
  }
  // across the eight code lanes of the warp
#pragma unroll
  for (int t = 0; t < TM; ++t) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      const float ov = __shfl_xor_sync(FULL, best[t], off);
      const int oi = __shfl_xor_sync(FULL, arg[t], off);
      if (before(ov, oi, best[t], arg[t])) {
        best[t] = ov;
        arg[t] = oi;
      }
    }
  }
  // across the two warps that split the tile's codes
  if ((warp & 1) == 1 && (lane & 7) == 0) {
#pragma unroll
    for (int t = 0; t < TM; ++t) {
      red_v[tl + t * TOKEN_LANES] = best[t];
      red_i[tl + t * TOKEN_LANES] = arg[t];
    }
  }
  __syncthreads();
  if ((warp & 1) == 0 && (lane & 7) == 0) {
#pragma unroll
    for (int t = 0; t < TM; ++t) {
      const int row = tl + t * TOKEN_LANES;
      if (before(red_v[row], red_i[row], best[t], arg[t])) {
        best[t] = red_v[row];
        arg[t] = red_i[row];
      }
      if (t0 + row < T) {
        if (keys == nullptr)
          out[t0 + row] = arg[t];
        else
          atomicMax(keys + t0 + row, pack_key(best[t], arg[t]));
      }
    }
  }
}

__global__ void unpack_keys(const unsigned long long* __restrict__ keys, int* __restrict__ out,
                            int T) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < T) out[t] = (int)(0xFFFFFFFFu - (uint32_t)keys[t]);
}


template <int DZ, bool CHUNKED>
int launch(const void* z, const void* e, void* out, unsigned long long* kp, int T, int C,
           int dim, int tiles_per_split, dim3 grid, cudaStream_t st) {
  // above the 48 KB a kernel gets unasked for the wider variants; the
  // attribute is per device, so it is set at every launch
  const cudaError_t attr = cudaFuncSetAttribute(
      vq_lookup<DZ, CHUNKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES<DZ, CHUNKED>);
  if (attr != cudaSuccess) return (int)attr;
  vq_lookup<DZ, CHUNKED><<<grid, THREADS, SMEM_BYTES<DZ, CHUNKED>, st>>>(
      static_cast<const float*>(z), static_cast<const float*>(e), static_cast<int*>(out), kp, T,
      C, dim, tiles_per_split);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch.  dim: 8, 16, 32 or a multiple of 64.
// splits == 1: keys is unused.  splits > 1: the codebook's tiles are divided
// over `splits` blocks per token tile, and keys is (T,) 64-bit scratch that
// the caller has set to zero.
extern "C" int vq_lookup_fwd(const void* z, const void* e, void* out, void* keys, int T, int C,
                             int dim, int splits, void* stream) {
  const int n_tiles = (C + BC - 1) / BC;
  if (T <= 0 || C <= 0 || dim <= 0 || splits < 1 || splits > n_tiles ||
      (splits > 1 && keys == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  const dim3 grid((T + BT - 1) / BT, (n_tiles + tiles_per_split - 1) / tiles_per_split);
  unsigned long long* kp = splits > 1 ? static_cast<unsigned long long*>(keys) : nullptr;
  int err;
  if (dim == 8)
    err = launch<8, false>(z, e, out, kp, T, C, dim, tiles_per_split, grid, st);
  else if (dim == 16)
    err = launch<16, false>(z, e, out, kp, T, C, dim, tiles_per_split, grid, st);
  else if (dim == 32)
    err = launch<32, false>(z, e, out, kp, T, C, dim, tiles_per_split, grid, st);
  else if (dim % 64 == 0)
    err = launch<64, true>(z, e, out, kp, T, C, dim, tiles_per_split, grid, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err == 0 && kp != nullptr) {
    unpack_keys<<<(T + 255) / 256, 256, 0, st>>>(kp, static_cast<int*>(out), T);
    err = (int)cudaGetLastError();
  }
  return err;
}

// Non-causal flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paintmind_tpu/ops/flash_attention.py::
// _flash_forward (kernel _attn_kernel).  That kernel keeps all of one
// (batch, head)'s K/V in VMEM; a block on this card has at most 227 KB of
// shared memory and far fewer registers than that, so a block owns a tile of
// queries of one (batch, head) and streams K/V through shared memory in tiles
// of keys, carrying an online-softmax running max and sum in fp32.
//
// Layout: q (B, N, H, D) and o (B, N, H, D) contiguous; k and v (B, M, Hkv, D)
// with their own batch and row strides (in elements, multiples of 8) and
// their heads and dims contiguous, so that a KV cache's first M rows are read
// in place.  Grouped-query attention: Hkv divides H, and query head h reads
// KV head h / (H / Hkv); nothing is repeated (each block loads its KV head's
// tiles itself, the H / Hkv blocks of a group from L2).  bf16 K/V that are
// contiguous with q's heads take attn_fwd_wgmma, the others attn_fwd_wgmma_kv:
// one body, the first with the strides the compiler knows.
// D is 64 or 128 (the wrapper zero-pads smaller head dims to the next; the
// JAX package sends head dims up to 128 to its kernel); fp32 or bf16 in,
// fp32 accumulation and softmax, output in the input type.  When a gradient is
// wanted the caller passes lse, a (B, H, N) fp32 buffer that receives each
// row's natural-log log-sum-exp of the scaled scores (max + log of the
// running sum): the backward kernels (flash_attention_bwd.cu) rebuild P from
// it tile by tile.
//
// Bound on this card: 4*B*H*N*M*D operations.  Two kernels, chosen by type:
//
//   attn_fwd_wgmma (bf16)  runs both products on the tensor cores with
//     wgmma.m64n64k16 (building blocks in attention_mma.cuh).  A block is one
//     warpgroup that owns 64 queries; its Q tile stays in shared memory.  K/V
//     tiles of 64 keys stream through a ring of swizzled bf16 tiles by
//     cp.async, so the next tile loads while this one multiplies.
//     S = Q.K^T reads both operands from shared memory through descriptors
//     (K's [key][d] tile as it lies); the online softmax works in base 2
//     (scale * log2 e folded into the exponent) on the fp32 accumulators, the
//     running sum is taken from the fp32 p; P is rounded to bf16 in registers,
//     where two accumulator tiles are one A fragment, and O += P.V takes it
//     from there, with V's tile read as a transposed B.  The scores never
//     touch shared memory.  At D = 128 a tile is two 64-column sub-tiles:
//     S = Q.K^T runs its eight k-steps over both, and O is two 64 x 64
//     accumulators, one P.V product per half (64 more registers a thread).  Ragged M (77 text tokens): missing rows of the
//     last tile are zero-filled by the copy and their scores set to -inf;
//     every tile holds at least one key, so no row max is -inf.  Ragged N:
//     rows past N load zeros, take part in the products and store nothing.
//   attn_fwd_f32 (fp32)  one query per thread (two at D = 128, each holding
//     64 of the dims, their dot products joined by one shuffle) on the fp32
//     CUDA cores, K/V in tiles of 32 keys, looping over the valid keys only:
//     fp32 operands must not be rounded to TF32 (the stage-1 reconstruction
//     is held to 1e-4).

#include "attention_mma.cuh"

namespace {

using namespace attn;

// Element strides of k and v: between batch rows and between tokens.
struct KVStrides {
  long long k_batch, k_row, v_batch, v_row;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int FWD_THREADS = 128;  // one warpgroup
// ring stages: tile t + STAGES - 1 loads while tile t multiplies (3 and 4 were
// slower on an H100 at N = M = 1024: fewer blocks fit an SM)
constexpr int STAGES = 2;
// the Q tile, the ring stages of a K and a V tile, room to start at a multiple
// of 1024; a tile is D / 64 sub-tiles
template <int D>
constexpr int FWD_SMEM = (1 + 2 * STAGES) * (D / SUB) * TILE_BYTES + 1024;

// One block's work.  CACHE: k and v grouped and strided as `kv` and `group`
// say; otherwise contiguous with q's heads, their row stride the same H * D as
// q's (a constant the compiler folds into the copies' addresses: the general
// strides cost the MaskGIT calls 3-5 %).
template <int D, bool CACHE>
__device__ __forceinline__ void attn_fwd_tile(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
    int N, int M, int H, int group, KVStrides kv, float scale) {
  constexpr int NSUB = D / SUB;                   // sub-tiles of a tile
  constexpr int OP_BYTES = NSUB * TILE_BYTES;     // one operand's tile
  constexpr int STAGE_BYTES = 2 * OP_BYTES;
  // the block's Q tile, then the ring: stage s has its K tile at s * STAGE_BYTES
  // and its V tile after it; the descriptors' swizzle wants tiles that start at
  // multiples of 1024 bytes
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (1024 - (smem_u32(smem_raw) & 1023)) % 1024;
  const uint32_t qs = smem_u32(smem);
  const uint32_t ring = qs + OP_BYTES;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * TILE;
  const long long tok = (long long)H * D;  // elements between consecutive tokens
  const __nv_bfloat16* qb = q + (long long)b * N * tok + (long long)h * D;
  const long long hk = (long long)(h / group) * D;  // this head's KV head
  const __nv_bfloat16* kb = CACHE ? k + b * kv.k_batch + hk : k + (long long)b * M * tok + (long long)h * D;
  const __nv_bfloat16* vb = CACHE ? v + b * kv.v_batch + hk : v + (long long)b * M * tok + (long long)h * D;

  const TileCopier<FWD_THREADS, D> copy_k(kb, CACHE ? kv.k_row : tok, M, tid),
      copy_v(vb, CACHE ? kv.v_row : tok, M, tid);
  const int n_tiles = (M + TILE - 1) / TILE;
  // tile t into stage t % STAGES, as one group (an empty one past the last tile:
  // the count of groups in flight stays the same)
  auto load_stage = [&](int t) {
    if (t < n_tiles) {
      const uint32_t dst = ring + (t % STAGES) * STAGE_BYTES;
      copy_k(dst, t * TILE);
      copy_v(dst + OP_BYTES, t * TILE);
    }
    cp_async_commit();
  };

  TileCopier<FWD_THREADS, D>(qb, tok, N, tid)(qs, q0);  // lands with tile 0
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load_stage(t);
  const uint64_t qd = wgmma_desc(qs);

  float oacc[NSUB][8][4];  // the output's 64-column halves
#pragma unroll
  for (int j = 0; j < NSUB; ++j) zero_acc(oacc[j]);
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, base-2 scaled scores
  float l_run[2] = {0.f, 0.f};              // this lane's share of the row sums
  const float sl2 = scale * LOG2E;          // > 0: the row max is taken before scaling

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // this thread's share of tile t has landed
    fence_proxy_async();          // and is visible to wgmma
    __syncthreads();              // everyone's is, and everyone is done with tile t - 1,
    load_stage(t + STAGES - 1);   // whose stage the tile STAGES - 1 ahead now takes
    const uint32_t ks = ring + (t % STAGES) * STAGE_BYTES;
    const uint64_t kd = wgmma_desc(ks);
    const uint64_t vd = wgmma_desc(ks + OP_BYTES);

    float s[8][4];
    zero_acc(s);  // never added: the first wgmma below overwrites it
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16<0>(s, qd + k_step(kk), kd + k_step(kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin(s);

    const int valid = M - t * TILE;  // columns at or past it are no keys
    if (valid < TILE) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * (lane & 3) + (e & 1) >= valid) s[j][e] = -INFINITY;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      // finite: the tile has a key
      const float m_new = fmaxf(m_run[r], quad_max(mx) * sl2);
      const float corr = fast_exp2(m_run[r] - m_new);  // 0 on the first tile
      m_run[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = fast_exp2(fmaf(s[j][2 * r], sl2, -m_new));
        const float p1 = fast_exp2(fmaf(s[j][2 * r + 1], sl2, -m_new));
        s[j][2 * r] = p0;
        s[j][2 * r + 1] = p1;
        sum += p0 + p1;
      }
      l_run[r] = l_run[r] * corr + sum;
      if (corr != 1.f) {  // after the first tiles a row's max seldom moves
#pragma unroll
        for (int hh = 0; hh < NSUB; ++hh)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            oacc[hh][j][2 * r] *= corr;
            oacc[hh][j][2 * r + 1] *= corr;
          }
      }
    }

    uint32_t pf[4][4];
    pack_a_frags(pf, s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hh = 0; hh < NSUB; ++hh)
        wgmma_m64n64k16<1>(oacc[hh], pf[kk], vd + hh * WGMMA_SUB_STEP + kk * WGMMA_ROW_STEP, 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int hh = 0; hh < NSUB; ++hh) wgmma_pin(oacc[hh]);
    wgmma_pin(pf);
  }
  __syncthreads();  // every warp is done with the Q tile: it now stages the output

  const int g = lane >> 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    const float inv = 1.f / l;
#pragma unroll
    for (int hh = 0; hh < NSUB; ++hh)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        oacc[hh][j][2 * r] *= inv;
        oacc[hh][j][2 * r + 1] *= inv;
      }
    const int row = q0 + warp * 16 + g + 8 * r;
    if (lse != nullptr && (lane & 3) == 0 && row < N)
      lse[((long long)b * H + h) * N + row] = m_run[r] * LN2 + logf(l);
  }
#pragma unroll
  for (int hh = 0; hh < NSUB; ++hh)
    store_rows(smem + hh * TILE_BYTES, warp * 16, oacc[hh],
               o + (long long)b * N * tok + (long long)h * D + hh * SUB, tok, q0, N, lane);
}

// K and V contiguous, with q's heads: every MaskGIT call.
template <int D>
__global__ void __launch_bounds__(FWD_THREADS)
attn_fwd_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               float* __restrict__ lse, int N, int M, int H, float scale) {
  attn_fwd_tile<D, false>(q, k, v, o, lse, N, M, H, 1, KVStrides{}, scale);
}

// K and V grouped and read in place from a KV cache: sdar-30b-a3b's calls.
template <int D>
__global__ void __launch_bounds__(FWD_THREADS)
attn_fwd_wgmma_kv(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                  float* __restrict__ lse, int N, int M, int H, int group, KVStrides kv,
                  float scale) {
  attn_fwd_tile<D, true>(q, k, v, o, lse, N, M, H, group, kv, scale);
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ32 = 128;  // threads per block
constexpr int BK32 = 32;   // keys per shared-memory tile

// SPLIT = D / 64 threads share a query, each holding PART = 64 of its dims:
// local index l of a thread is dim 4 (SPLIT (l / 4) + part) + l % 4, so the
// threads of a query interleave 16-byte groups.
template <int D>
__global__ void __launch_bounds__(BQ32)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
             int N, int M, int H, int group, KVStrides kv, float scale) {
  constexpr int SPLIT = D / 64;
  constexpr int PART = D / SPLIT;
  constexpr int QB = BQ32 / SPLIT;  // queries per block
  __shared__ __align__(16) float ks[BK32][D];
  __shared__ __align__(16) float vs[BK32][D];
  __shared__ float ss[BK32][QB];  // this tile's scores, [key][query]: no bank conflicts

  const int tid = threadIdx.x;
  const int part = tid % SPLIT;
  const int ql = tid / SPLIT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qi = blockIdx.x * QB + ql;
  const bool active = qi < N;
  const long long tok = (long long)H * D;  // elements between consecutive tokens

  float qr[PART];
  float acc[PART];
  if (active) {
    const float* qp = q + ((long long)b * N + qi) * tok + (long long)h * D;
#pragma unroll
    for (int l = 0; l < PART; ++l) qr[l] = qp[4 * (SPLIT * (l >> 2) + part) + (l & 3)];
  } else {
#pragma unroll
    for (int l = 0; l < PART; ++l) qr[l] = 0.f;
  }
#pragma unroll
  for (int l = 0; l < PART; ++l) acc[l] = 0.f;
  float m_run = -INFINITY;
  float l_run = 0.f;

  const long long hk = (long long)(h / group) * D;  // this head's KV head
  const float* kb = k + b * kv.k_batch + hk;
  const float* vb = v + b * kv.v_batch + hk;

  for (int k0 = 0; k0 < M; k0 += BK32) {
    const int nk = min(BK32, M - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < BK32 * D; i += BQ32) {
      const int j = i / D;
      const int d = i % D;
      float kval = 0.f, vv = 0.f;
      if (j < nk) {
        kval = kb[(long long)(k0 + j) * kv.k_row + d];
        vv = vb[(long long)(k0 + j) * kv.v_row + d];
      }
      ks[j][d] = kval;
      vs[j][d] = vv;
    }
    __syncthreads();

    float tile_max = -INFINITY;
    for (int j = 0; j < nk; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks[j]) + part;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < PART / 4; ++d4) {
        const float4 kk = kr[SPLIT * d4];
        s0 = fmaf(qr[4 * d4 + 0], kk.x, s0);
        s1 = fmaf(qr[4 * d4 + 1], kk.y, s1);
        s2 = fmaf(qr[4 * d4 + 2], kk.z, s2);
        s3 = fmaf(qr[4 * d4 + 3], kk.w, s3);
      }
      float s = (s0 + s1) + (s2 + s3);
      if (SPLIT == 2) s += __shfl_xor_sync(FULL, s, 1);
      s *= scale;
      if (part == 0) ss[j][ql] = s;
      tile_max = fmaxf(tile_max, s);
    }
    __syncwarp();  // the query's scores are in ss for every thread that shares it

    const float m_new = fmaxf(m_run, tile_max);
    const float corr = __expf(m_run - m_new);  // 0 on the first tile
    l_run *= corr;
#pragma unroll
    for (int l = 0; l < PART; ++l) acc[l] *= corr;

    for (int j = 0; j < nk; ++j) {
      const float p = __expf(ss[j][ql] - m_new);
      l_run += p;
      const float4* vr = reinterpret_cast<const float4*>(vs[j]) + part;
#pragma unroll
      for (int d4 = 0; d4 < PART / 4; ++d4) {
        const float4 vv = vr[SPLIT * d4];
        acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
    m_run = m_new;
  }

  if (active) {
    float* op = o + ((long long)b * N + qi) * tok + (long long)h * D;
    const float inv = 1.f / l_run;
#pragma unroll
    for (int l = 0; l < PART; ++l) op[4 * (SPLIT * (l >> 2) + part) + (l & 3)] = acc[l] * inv;
    if (lse != nullptr && part == 0) lse[((long long)b * H + h) * N + qi] = m_run + logf(l_run);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lp, int B, int N,
           int M, int H, int group, KVStrides kv, float scale, int dtype, cudaStream_t st) {
  const long long tok = (long long)H * D;
  const bool cache = group != 1 || kv.k_row != tok || kv.v_row != tok ||
                     kv.k_batch != M * tok || kv.v_batch != M * tok;
  if (dtype == 0) {
    constexpr int QB = BQ32 / (D / 64);
    const dim3 grid((N + QB - 1) / QB, H, B);
    attn_fwd_f32<D><<<grid, BQ32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lp, N, M, H, group, kv, scale);
  } else if (dtype == 1) {
    // needed once the ring is above the 48 KB a kernel gets unasked; the
    // attribute is per device, so it is set at every launch
    const cudaError_t attr = cache ? cudaFuncSetAttribute(attn_fwd_wgmma_kv<D>,
                                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                          FWD_SMEM<D>)
                                   : cudaFuncSetAttribute(attn_fwd_wgmma<D>,
                                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                          FWD_SMEM<D>);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((N + TILE - 1) / TILE, H, B);
    const auto* qp = static_cast<const __nv_bfloat16*>(q);
    const auto* kp = static_cast<const __nv_bfloat16*>(k);
    const auto* vp = static_cast<const __nv_bfloat16*>(v);
    auto* op = static_cast<__nv_bfloat16*>(o);
    if (cache)
      attn_fwd_wgmma_kv<D><<<grid, FWD_THREADS, FWD_SMEM<D>, st>>>(qp, kp, vp, op, lp, N, M, H,
                                                                   group, kv, scale);
    else
      attn_fwd_wgmma<D><<<grid, FWD_THREADS, FWD_SMEM<D>, st>>>(qp, kp, vp, op, lp, N, M, H,
                                                                scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 64 or 128; lse may be null (no
// gradient wanted).  Hkv KV heads (dividing H); k_batch, k_row, v_batch, v_row
// the element strides of k and v between batch rows and tokens (multiples of
// 8).  bf16 operands must be 16-byte aligned.  Returns the cudaError_t of the
// launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int N, int M, int H, int Hkv,
                                   int head_dim, long long k_batch, long long k_row,
                                   long long v_batch, long long v_row, float scale, int dtype,
                                   void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || H <= 0 || H > 65535 || B > 65535 || !(scale > 0.f) ||
      Hkv <= 0 || H % Hkv || k_row % 8 || v_row % 8 || k_batch % 8 || v_batch % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  const KVStrides kv{k_batch, k_row, v_batch, v_row};
  const int group = H / Hkv;
  if (head_dim == 64) return launch<64>(q, k, v, o, lp, B, N, M, H, group, kv, scale, dtype, st);
  if (head_dim == 128)
    return launch<128>(q, k, v, o, lp, B, N, M, H, group, kv, scale, dtype, st);
  return (int)cudaErrorInvalidValue;
}

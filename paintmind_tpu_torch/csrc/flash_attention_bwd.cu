// Non-causal flash-attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paintmind_tpu/ops/flash_attention.py::
// _flash_backward (kernel _bwd_kernel): from q, k, v and the cotangent g of
// o = softmax(q k^T scale) v it gives
//
//   P  = softmax(q k^T scale)          dv = P^T g
//   dP = g v^T                         delta = rowsum(P * dP)
//   dS = P * (dP - delta) * scale      dq = dS k,   dk = dS^T q
//
// The TPU kernel walks the query blocks of one (batch, head) in order and
// carries dk/dv in scratch memory from one grid step to the next; it holds
// all M keys of a row at once, so it recomputes the row's max and sum inline.
// Blocks on this card run in no order and a block cannot hold a whole row of
// scores.  So the work is split by ownership into two kernels, and no sum
// ever crosses a block (no atomics: the gradients are the same bits on every
// run):
//
//   dq kernel    a block owns 64 queries and streams the K/V tiles twice:
//                once for each row's delta, once for dq; writes both;
//   dkdv kernel  a block owns 64 keys, streams q/g tiles with their
//                log-sum-exp and delta, writes dk and dv.
//
// P is rebuilt in both from the forward's per-row log-sum-exp, P = exp(s -
// lse), so no pass over the keys is needed to find a row's max and sum.
// delta is summed in fp32 as rowsum(P * dP) from the very P and dP that dS is
// then formed from.  rowsum(g * o) is the same number on paper and needs no
// pass, but o comes back rounded to the input type: in bf16 that error (2^-9
// of |g||o|) does not cancel over the keys as dP - delta does, and where
// attention is near uniform, as at initialisation, it drowned dq and dk
// (mean relative error 1.4 in the last layer's to_q gradient, against 0.13
// for bf16 rounding alone).
//
// Layout: q, g, dq (B, N, H, D); k, v, dk, dv (B, M, H, D); lse and delta
// (B, H, N) fp32; all contiguous.  D = 64.  Gradients are written in the
// input type.
//
// Bound on this card: 10*B*H*N*M*D operations (five products); s and dP are
// computed in both kernels and for delta, 18*B*H*N*M*D in all.  Two sets of
// kernels, chosen by type:
//
//   attn_bwd_dq_wgmma, attn_bwd_dkdv_wgmma (bf16)  run every product on the
//     tensor cores with wgmma.m64n64k16 (building blocks in
//     attention_mma.cuh).  A block is one warpgroup; the 64 rows it owns (q
//     and g, or k and v) stay in shared memory as two swizzled bf16 tiles, and
//     the streamed operands come in 64-row tiles through a cp.async ring.  S = q.k^T and dP = g.v^T (K.q^T and V.g^T in the dkdv kernel) read
//     both operands from shared memory through descriptors, the row-major
//     tiles as they lie; P = 2^(s scale log2 e - lse log2 e); delta and dS are
//     formed in fp32 on the accumulators, then P (for dv) and dS (for dq, dk)
//     are rounded to bf16 in registers, as the TPU kernel rounds them, where
//     two accumulator tiles are one A fragment, and the products that consume
//     them read k, g and q as transposed B.  In the dkdv kernel lse and delta
//     of the streamed queries ride along in shared memory and are indexed by
//     the accumulator's column.
//     Ragged M (77 text tokens): rows past M are zero-filled by the copy; in
//     the dq kernel their P is set to 0, in the dkdv kernel their rows are
//     computed with P = 0 and not stored.  Ragged N: rows past N load zeros
//     for q and g and 0 for lse and delta, so their P is 1, their dP and dS
//     are 0, they add nothing to dk/dv and store nothing.
//   attn_bwd_dq_f32, attn_bwd_dkdv_f32 (fp32)  the same split on the fp32
//     CUDA cores (fp32 operands must not be rounded to TF32: the gate is 1e-5
//     mean relative).  A row belongs to a pair of neighbouring threads; each
//     holds half of the row's 64 dims (the float4 groups of its parity) and
//     half of the accumulators, and the two halves of a dot product meet
//     through one __shfl_xor_sync.  P and dS stay in fp32.

#include "attention_mma.cuh"

namespace {

using namespace attn;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int THREADS = 128;  // one warpgroup
constexpr int ROWS = TILE;    // rows (queries or keys) owned by a block: one tile
// ring stages: tile t + STAGES - 1 loads while tile t multiplies (3 and 4 were
// slower on an H100 at N = M = 1024: fewer blocks fit an SM)
constexpr int STAGES = 2;
// the block's two own tiles, the ring stages of two tiles, the dkdv kernel's
// lse and delta of each stage, room to start at a multiple of 1024
constexpr int BWD_SMEM = (2 + 2 * STAGES) * TILE_BYTES + STAGES * 2 * TILE * 4 + 1024;

__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int N, int M, int H, float scale) {
  constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  // the block's q and g tiles, then the ring: stage s has its K tile at s *
  // STAGE_BYTES and its V tile after it; tiles start at multiples of 1024 bytes
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (1024 - (smem_u32(smem_raw) & 1023)) % 1024;
  const uint32_t qs = smem_u32(smem);
  const uint32_t gs = qs + TILE_BYTES;
  const uint32_t ring = gs + TILE_BYTES;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * ROWS;
  const long long tok = (long long)H * D;  // elements between consecutive tokens
  const long long qoff = (long long)b * N * tok + (long long)h * D;
  const __nv_bfloat16* kb = k + (long long)b * M * tok + (long long)h * D;
  const __nv_bfloat16* vb = v + (long long)b * M * tok + (long long)h * D;
  const long long stat = ((long long)b * H + h) * N;
  const int n_tiles = (M + TILE - 1) / TILE;
  const int n_iters = 2 * n_tiles;  // first pass: delta; second pass: dq

  const TileCopier<THREADS> copy_k(kb, tok, M, tid), copy_v(vb, tok, M, tid);
  // the tiles of iteration `it` into stage it % STAGES, as one group (an empty
  // one past the last iteration: the count of groups in flight stays the same)
  auto load_stage = [&](int it) {
    if (it < n_iters) {
      const uint32_t dst = ring + (it % STAGES) * STAGE_BYTES;
      const int r0 = (it % n_tiles) * TILE;
      copy_k(dst, r0);
      copy_v(dst + TILE_BYTES, r0);
    }
    cp_async_commit();
  };

  TileCopier<THREADS>(q + qoff, tok, N, tid)(qs, q0);  // land with the first stage
  TileCopier<THREADS>(g + qoff, tok, N, tid)(gs, q0);
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) load_stage(it);
  const uint64_t qd = wgmma_desc(qs);
  const uint64_t gd = wgmma_desc(gs);

  // rows g and g + 8 of the warp's 16; rows past N: lse 0, and q = g = 0
  int row[2];
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = q0 + warp * 16 + (lane >> 2) + 8 * r;
    lse2[r] = row[r] < N ? lse[stat + row[r]] * LOG2E : 0.f;
  }
  float dl[2] = {0.f, 0.f};
  float acc[8][4];
  zero_acc(acc);
  const float sl2 = scale * LOG2E;

  for (int it = 0; it < n_iters; ++it) {
    cp_async_wait<STAGES - 2>();  // this thread's share of this iteration's tiles has landed
    fence_proxy_async();          // and is visible to wgmma
    __syncthreads();              // everyone's is, and everyone is done with the iteration
    load_stage(it + STAGES - 1);  // before, whose stage the one STAGES - 1 ahead now takes
    const uint32_t ks = ring + (it % STAGES) * STAGE_BYTES;
    const uint64_t kd = wgmma_desc(ks);
    const uint64_t vd = wgmma_desc(ks + TILE_BYTES);
    const bool second = it >= n_tiles;
    const int valid = M - (it % n_tiles) * TILE;  // columns at or past it are no keys

    if (it == n_tiles) {
      // delta is complete: every lane of a row's quad gets the row's sum
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dl[r] = quad_sum(dl[r]);
        if ((lane & 3) == 0 && row[r] < N) delta[stat + row[r]] = dl[r];
      }
    }

    float s[8][4], dp[8][4];
    zero_acc(s);  // never added: the first wgmma of each product overwrites them
    zero_acc(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16<0>(s, qd + kk * WGMMA_K_STEP, kd + kk * WGMMA_K_STEP, kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16<0>(dp, gd + kk * WGMMA_K_STEP, vd + kk * WGMMA_K_STEP, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin(s);
    wgmma_pin(dp);

#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * (lane & 3) + (e & 1);
        s[j][e] = col < valid ? fast_exp2(fmaf(s[j][e], sl2, -lse2[e >> 1])) : 0.f;  // P
      }
    }
    if (!second) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dl[e >> 1] = fmaf(s[j][e], dp[j][e], dl[e >> 1]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = s[j][e] * (dp[j][e] - dl[e >> 1]) * scale;  // dS, fp32
      uint32_t dsf[4][4];
      pack_a_frags(dsf, s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dq += dS . k
        wgmma_m64n64k16<1>(acc, dsf[kk], kd + kk * WGMMA_ROW_STEP, 1);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_pin(acc);
      wgmma_pin(dsf);
    }
  }
  __syncthreads();  // every warp is done with the q tile: it now stages the output
  store_rows(smem, warp * 16, acc, dq + qoff, tok, q0, N, lane);
}

__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int N,
                    int M, int H, float scale) {
  constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  // the block's k and v tiles, then the ring: stage s has its q tile at s *
  // STAGE_BYTES and its g tile after it; then the queries' lse (stats[s][0])
  // and delta (stats[s][1]); tiles start at multiples of 1024 bytes
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (1024 - (smem_u32(smem_raw) & 1023)) % 1024;
  const uint32_t ks = smem_u32(smem);
  const uint32_t vs = ks + TILE_BYTES;
  const uint32_t ring = vs + TILE_BYTES;
  float (*stats)[2][TILE] =
      reinterpret_cast<float (*)[2][TILE]>(smem + (2 + 2 * STAGES) * TILE_BYTES);
  const uint32_t stats_base = ks + (2 + 2 * STAGES) * TILE_BYTES;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * ROWS;
  const long long tok = (long long)H * D;
  const long long koff = (long long)b * M * tok + (long long)h * D;
  const __nv_bfloat16* qb = q + (long long)b * N * tok + (long long)h * D;
  const __nv_bfloat16* gb = g + (long long)b * N * tok + (long long)h * D;
  const float* lb = lse + ((long long)b * H + h) * N;
  const float* db = delta + ((long long)b * H + h) * N;

  // one stage: a q tile, a g tile and the 64 queries' lse and delta (threads
  // 0..63 copy lse, 64..127 delta; zeros past N)
  const TileCopier<THREADS> copy_q(qb, tok, N, tid), copy_g(gb, tok, N, tid);
  const int n_tiles = (N + TILE - 1) / TILE;
  auto load_stage = [&](int t) {
    if (t < n_tiles) {
      const int stage = t % STAGES;
      const int r0 = t * TILE;
      const uint32_t tiles = ring + stage * STAGE_BYTES;
      copy_q(tiles, r0);
      copy_g(tiles + TILE_BYTES, r0);
      const int which = tid >> 6;
      const int i = tid & (TILE - 1);
      const bool ok = r0 + i < N;
      const float* src = (which == 0 ? lb : db) + (ok ? r0 + i : 0);
      cp_async_4(stats_base + ((stage * 2 + which) * TILE + i) * 4, src, ok);
    }
    cp_async_commit();  // an empty group past the last tile keeps the count in flight the same
  };

  TileCopier<THREADS>(k + koff, tok, M, tid)(ks, k0);  // land with the first stage
  TileCopier<THREADS>(v + koff, tok, M, tid)(vs, k0);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load_stage(t);
  const uint64_t kd = wgmma_desc(ks);
  const uint64_t vd = wgmma_desc(vs);

  bool own[2];  // rows g and g + 8 of the warp's 16 are keys
#pragma unroll
  for (int r = 0; r < 2; ++r) own[r] = k0 + warp * 16 + (lane >> 2) + 8 * r < M;
  float dk_acc[8][4], dv_acc[8][4];
  zero_acc(dk_acc);
  zero_acc(dv_acc);
  const float sl2 = scale * LOG2E;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // this thread's share of tile t has landed
    fence_proxy_async();          // and is visible to wgmma
    __syncthreads();              // everyone's is, and everyone is done with tile t - 1,
    load_stage(t + STAGES - 1);   // whose stage the tile STAGES - 1 ahead now takes
    const uint32_t qs = ring + (t % STAGES) * STAGE_BYTES;
    const uint64_t qd = wgmma_desc(qs);
    const uint64_t gd = wgmma_desc(qs + TILE_BYTES);
    const float* ls = stats[t % STAGES][0];
    const float* ds = stats[t % STAGES][1];

    float st[8][4], dpt[8][4];  // S^T and dP^T: rows are keys, columns queries
    zero_acc(st);  // never added: the first wgmma of each product overwrites them
    zero_acc(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16<0>(st, kd + kk * WGMMA_K_STEP, qd + kk * WGMMA_K_STEP, kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16<0>(dpt, vd + kk * WGMMA_K_STEP, gd + kk * WGMMA_K_STEP, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin(st);
    wgmma_pin(dpt);

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
      const float2 d2 = *reinterpret_cast<const float2*>(ds + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse2 = ((e & 1) ? l2.y : l2.x) * LOG2E;
        const float dl = (e & 1) ? d2.y : d2.x;
        const float p = own[e >> 1] ? fast_exp2(fmaf(st[j][e], sl2, -lse2)) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - dl) * scale;  // dS^T, fp32
      }
    }
    uint32_t pf[4][4], dsf[4][4];
    pack_a_frags(pf, st);
    pack_a_frags(dsf, dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // dv += P^T . g
      wgmma_m64n64k16<1>(dv_acc, pf[kk], gd + kk * WGMMA_ROW_STEP, 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // dk += dS^T . q
      wgmma_m64n64k16<1>(dk_acc, dsf[kk], qd + kk * WGMMA_ROW_STEP, 1);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin(dv_acc);
    wgmma_pin(dk_acc);
    wgmma_pin(pf);
    wgmma_pin(dsf);
  }
  __syncthreads();  // every warp is done with the k and v tiles: they now stage the output
  store_rows(smem, warp * 16, dk_acc, dk + koff, tok, k0, M, lane);
  store_rows(smem + TILE_BYTES, warp * 16, dv_acc, dv + koff, tok, k0, M, lane);
}

int launch_wgmma(const void* q, const void* k, const void* v, const void* g, const void* lse,
                 void* delta, void* dq, void* dk, void* dv, int B, int N, int M, int H,
                 float scale, cudaStream_t st) {
  using T = __nv_bfloat16;
  // above the 48 KB a kernel gets unasked; the attribute is per device, so it
  // is set at every launch
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      attn_bwd_dkdv_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((N + ROWS - 1) / ROWS, H, B);
  attn_bwd_dq_wgmma<<<grid_q, THREADS, BWD_SMEM, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<T*>(dq), N, M, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // reads the delta that the dq kernel wrote: same stream, so it runs after it
  const dim3 grid_k((M + ROWS - 1) / ROWS, H, B);
  attn_bwd_dkdv_wgmma<<<grid_k, THREADS, BWD_SMEM, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), N, M, H,
      scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int HALF = D / 2;        // dims held by one thread of a pair
constexpr int ROWS32 = 64;         // rows (queries or keys) owned by a block
constexpr int THREADS32 = 2 * ROWS32;
constexpr int TILE32 = 32;         // rows of the streamed operands per shared-memory tile

// Local index l of a thread's half row <-> dim of the row: float4 group
// 2*(l/4) + half, so the two threads of a pair interleave 16-byte groups.
__device__ __forceinline__ int dim_of(int l, int half) {
  return 8 * (l >> 2) + 4 * half + (l & 3);
}

__device__ __forceinline__ void load_half(float (&r)[HALF], const float* row, int half,
                                          bool active) {
#pragma unroll
  for (int l = 0; l < HALF; ++l) r[l] = active ? row[dim_of(l, half)] : 0.f;
}

__device__ __forceinline__ void store_half(float* row, const float (&r)[HALF], int half) {
#pragma unroll
  for (int l = 0; l < HALF; ++l) row[dim_of(l, half)] = r[l];
}

// Rows r0 .. r0+TILE32 of a (rows, H, D) operand of one (batch, head) into a
// [TILE32][D] fp32 tile, zeros past n_rows.  Neighbouring threads read
// neighbouring addresses.
__device__ __forceinline__ void load_tile32(float (*tile)[D], const float* base, long long tok,
                                            int r0, int n_rows, int tid) {
  for (int i = tid; i < TILE32 * D; i += THREADS32) {
    const int j = i / D;
    const int d = i % D;
    tile[j][d] = (r0 + j < n_rows) ? base[(long long)(r0 + j) * tok + d] : 0.f;
  }
}

// This thread's half of dot(r, row) where row is a [D] shared-memory row.
__device__ __forceinline__ float half_dot(const float (&r)[HALF], const float* row, int half) {
  const float4* p = reinterpret_cast<const float4*>(row) + half;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int m = 0; m < HALF / 4; ++m) {
    const float4 x = p[2 * m];
    s0 = fmaf(r[4 * m + 0], x.x, s0);
    s1 = fmaf(r[4 * m + 1], x.y, s1);
    s2 = fmaf(r[4 * m + 2], x.z, s2);
    s3 = fmaf(r[4 * m + 3], x.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// acc += c * row, on this thread's half of the dims.
__device__ __forceinline__ void half_axpy(float (&acc)[HALF], float c, const float* row,
                                          int half) {
  const float4* p = reinterpret_cast<const float4*>(row) + half;
#pragma unroll
  for (int m = 0; m < HALF / 4; ++m) {
    const float4 x = p[2 * m];
    acc[4 * m + 0] = fmaf(c, x.x, acc[4 * m + 0]);
    acc[4 * m + 1] = fmaf(c, x.y, acc[4 * m + 1]);
    acc[4 * m + 2] = fmaf(c, x.z, acc[4 * m + 2]);
    acc[4 * m + 3] = fmaf(c, x.w, acc[4 * m + 3]);
  }
}

__device__ __forceinline__ float pair_sum(float x) { return x + __shfl_xor_sync(FULL, x, 1); }

__global__ void __launch_bounds__(THREADS32)
attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ g,
                const float* __restrict__ lse, float* __restrict__ delta,
                float* __restrict__ dq, int N, int M, int H, float scale) {
  __shared__ __align__(16) float ks[TILE32][D];
  __shared__ __align__(16) float vs[TILE32][D];

  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qi = blockIdx.x * ROWS32 + (tid >> 1);
  const bool active = qi < N;
  const long long tok = (long long)H * D;  // elements between consecutive tokens
  const long long qoff = ((long long)b * N + (active ? qi : 0)) * tok + (long long)h * D;
  const long long stat = ((long long)b * H + h) * N + (active ? qi : 0);

  float qr[HALF], gr[HALF], acc[HALF];
  load_half(qr, q + qoff, half, active);
  load_half(gr, g + qoff, half, active);
#pragma unroll
  for (int l = 0; l < HALF; ++l) acc[l] = 0.f;
  const float row_lse = active ? lse[stat] : 0.f;

  const float* kb = k + (long long)b * M * tok + (long long)h * D;
  const float* vb = v + (long long)b * M * tok + (long long)h * D;

  // first pass over the keys: delta = rowsum(P * dP); both threads of a pair
  // hold the same s and dP, so both end with the same delta
  float dl = 0.f;
  for (int k0 = 0; k0 < M; k0 += TILE32) {
    const int nk = min(TILE32, M - k0);
    __syncthreads();
    load_tile32(ks, kb, tok, k0, M, tid);
    load_tile32(vs, vb, tok, k0, M, tid);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float s = pair_sum(half_dot(qr, ks[j], half)) * scale;
      const float dp = pair_sum(half_dot(gr, vs[j], half));
      dl = fmaf(__expf(s - row_lse), dp, dl);
    }
  }
  if (active && half == 0) delta[stat] = dl;

  // second pass: dq = sum_j dS_ij k_j
  for (int k0 = 0; k0 < M; k0 += TILE32) {
    const int nk = min(TILE32, M - k0);
    __syncthreads();  // every thread is done with the previous tile
    load_tile32(ks, kb, tok, k0, M, tid);
    load_tile32(vs, vb, tok, k0, M, tid);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float s = pair_sum(half_dot(qr, ks[j], half)) * scale;
      const float dp = pair_sum(half_dot(gr, vs[j], half));
      const float p = __expf(s - row_lse);
      half_axpy(acc, p * (dp - dl) * scale, ks[j], half);
    }
  }
  if (active) store_half(dq + qoff, acc, half);
}

__global__ void __launch_bounds__(THREADS32)
attn_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ g,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int N, int M, int H,
                  float scale) {
  __shared__ __align__(16) float qs[TILE32][D];
  __shared__ __align__(16) float gs[TILE32][D];
  __shared__ float ls[TILE32];
  __shared__ float ds[TILE32];

  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kj = blockIdx.x * ROWS32 + (tid >> 1);
  const bool active = kj < M;
  const long long tok = (long long)H * D;
  const long long koff = ((long long)b * M + (active ? kj : 0)) * tok + (long long)h * D;

  float kr[HALF], vr[HALF], dkr[HALF], dvr[HALF];
  load_half(kr, k + koff, half, active);
  load_half(vr, v + koff, half, active);
#pragma unroll
  for (int l = 0; l < HALF; ++l) { dkr[l] = 0.f; dvr[l] = 0.f; }

  const float* qb = q + (long long)b * N * tok + (long long)h * D;
  const float* gb = g + (long long)b * N * tok + (long long)h * D;
  const float* lb = lse + ((long long)b * H + h) * N;
  const float* db = delta + ((long long)b * H + h) * N;

  for (int q0 = 0; q0 < N; q0 += TILE32) {
    const int nq = min(TILE32, N - q0);
    __syncthreads();
    load_tile32(qs, qb, tok, q0, N, tid);
    load_tile32(gs, gb, tok, q0, N, tid);
    if (tid < TILE32) {
      const bool ok = q0 + tid < N;
      ls[tid] = ok ? lb[q0 + tid] : 0.f;
      ds[tid] = ok ? db[q0 + tid] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < nq; ++i) {
      const float s = pair_sum(half_dot(kr, qs[i], half)) * scale;
      const float dp = pair_sum(half_dot(vr, gs[i], half));
      const float p = active ? __expf(s - ls[i]) : 0.f;
      half_axpy(dvr, p, gs[i], half);
      half_axpy(dkr, p * (dp - ds[i]) * scale, qs[i], half);
    }
  }
  if (active) {
    store_half(dk + koff, dkr, half);
    store_half(dv + koff, dvr, half);
  }
}

int launch_f32(const void* q, const void* k, const void* v, const void* g, const void* lse,
               void* delta, void* dq, void* dk, void* dv, int B, int N, int M, int H,
               float scale, cudaStream_t st) {
  using T = float;
  const dim3 grid_q((N + ROWS32 - 1) / ROWS32, H, B);
  attn_bwd_dq_f32<<<grid_q, THREADS32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<T*>(dq), N, M, H, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // reads the delta that the dq kernel wrote: same stream, so it runs after it
  const dim3 grid_k((M + ROWS32 - 1) / ROWS32, H, B);
  attn_bwd_dkdv_f32<<<grid_k, THREADS32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), N, M, H,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  lse is the forward's log-sum-exp; delta
// is (B, H, N) fp32 scratch.  bf16 operands must be 16-byte aligned.  Returns
// the cudaError_t of the first launch that failed, or 0.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                   const void* lse, void* delta, void* dq, void* dk, void* dv,
                                   int B, int N, int M, int H, int head_dim, float scale,
                                   int dtype, void* stream) {
  if (head_dim != D || B <= 0 || N <= 0 || M <= 0 || H <= 0 || H > 65535 || B > 65535 ||
      !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(q, k, v, g, lse, delta, dq, dk, dv, B, N, M, H, scale, st);
  if (dtype == 1) return launch_wgmma(q, k, v, g, lse, delta, dq, dk, dv, B, N, M, H, scale, st);
  return (int)cudaErrorInvalidValue;
}

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
//                log-sum-exp and delta, writes dk and dv.  At D = 128 its two
//                64 x 128 accumulators would take 128 registers a thread
//                beside S^T, dP^T and their fragments, so it is split once
//                more by ownership: one launch writes dk, a second writes dv
//                (which needs P but not dP), each rebuilding P.
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
// (B, H, N) fp32; all contiguous.  D = 64 or 128 (the wrapper zero-pads
// smaller head dims: zero columns of q, k, v and g change no score and give
// zero gradient columns, which it slices off).  Gradients are written in the
// input type.
//
// Bound on this card: 10*B*H*N*M*D operations (five products); s and dP are
// computed in both kernels and for delta, 18*B*H*N*M*D in all.  Two sets of
// kernels, chosen by type:
//
//   attn_bwd_dq_wgmma, attn_bwd_dkdv_wgmma (bf16)  run every product on the
//     tensor cores with wgmma.m64n64k16 (building blocks in
//     attention_mma.cuh; at D = 128 a tile is two 64-column sub-tiles, the
//     products along D take eight k-steps over both and a D-wide gradient is
//     two 64 x 64 accumulators).  A block is one warpgroup; the 64 rows it owns (q
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
//     mean relative).  A row belongs to D / 32 neighbouring threads (a pair at
//     D = 64, four at D = 128); each holds 32 of the row's dims (every
//     (D / 32)-th float4 group) and as many of the accumulators, and the parts
//     of a dot product meet through __shfl_xor_sync.  P and dS stay in fp32.

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
// lse and delta of each stage, room to start at a multiple of 1024; a tile is
// D / 64 sub-tiles
template <int D>
constexpr int BWD_SMEM =
    (2 + 2 * STAGES) * (D / SUB) * TILE_BYTES + STAGES * 2 * TILE * 4 + 1024;

// what a dkdv launch writes
constexpr int DK_DV = 0, DK_ONLY = 1, DV_ONLY = 2;

template <int D>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int N, int M, int H, float scale) {
  constexpr int NSUB = D / SUB;
  constexpr int OP_BYTES = NSUB * TILE_BYTES;
  constexpr int STAGE_BYTES = 2 * OP_BYTES;
  // the block's q and g tiles, then the ring: stage s has its K tile at s *
  // STAGE_BYTES and its V tile after it; tiles start at multiples of 1024 bytes
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (1024 - (smem_u32(smem_raw) & 1023)) % 1024;
  const uint32_t qs = smem_u32(smem);
  const uint32_t gs = qs + OP_BYTES;
  const uint32_t ring = gs + OP_BYTES;

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

  const TileCopier<THREADS, D> copy_k(kb, tok, M, tid), copy_v(vb, tok, M, tid);
  // the tiles of iteration `it` into stage it % STAGES, as one group (an empty
  // one past the last iteration: the count of groups in flight stays the same)
  auto load_stage = [&](int it) {
    if (it < n_iters) {
      const uint32_t dst = ring + (it % STAGES) * STAGE_BYTES;
      const int r0 = (it % n_tiles) * TILE;
      copy_k(dst, r0);
      copy_v(dst + OP_BYTES, r0);
    }
    cp_async_commit();
  };

  TileCopier<THREADS, D>(q + qoff, tok, N, tid)(qs, q0);  // land with the first stage
  TileCopier<THREADS, D>(g + qoff, tok, N, tid)(gs, q0);
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
  float acc[NSUB][8][4];  // dq's 64-column halves
#pragma unroll
  for (int hh = 0; hh < NSUB; ++hh) zero_acc(acc[hh]);
  const float sl2 = scale * LOG2E;

  for (int it = 0; it < n_iters; ++it) {
    cp_async_wait<STAGES - 2>();  // this thread's share of this iteration's tiles has landed
    fence_proxy_async();          // and is visible to wgmma
    __syncthreads();              // everyone's is, and everyone is done with the iteration
    load_stage(it + STAGES - 1);  // before, whose stage the one STAGES - 1 ahead now takes
    const uint32_t ks = ring + (it % STAGES) * STAGE_BYTES;
    const uint64_t kd = wgmma_desc(ks);
    const uint64_t vd = wgmma_desc(ks + OP_BYTES);
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
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16<0>(s, qd + k_step(kk), kd + k_step(kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16<0>(dp, gd + k_step(kk), vd + k_step(kk), kk > 0);
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
#pragma unroll
        for (int hh = 0; hh < NSUB; ++hh)
          wgmma_m64n64k16<1>(acc[hh], dsf[kk], kd + hh * WGMMA_SUB_STEP + kk * WGMMA_ROW_STEP,
                             1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int hh = 0; hh < NSUB; ++hh) wgmma_pin(acc[hh]);
      wgmma_pin(dsf);
    }
  }
  __syncthreads();  // every warp is done with the q tile: it now stages the output
#pragma unroll
  for (int hh = 0; hh < NSUB; ++hh)
    store_rows(smem + hh * TILE_BYTES, warp * 16, acc[hh], dq + qoff + hh * SUB, tok, q0, N,
               lane);
}

// WHAT: DK_DV writes both gradients (D = 64); DK_ONLY and DV_ONLY one each
// (D = 128: two launches).  A DV_ONLY block forms no dP^T and no dS^T.
template <int D, int WHAT>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int N,
                    int M, int H, float scale) {
  constexpr bool WANT_DK = WHAT != DV_ONLY;
  constexpr bool WANT_DV = WHAT != DK_ONLY;
  constexpr int NSUB = D / SUB;
  constexpr int OP_BYTES = NSUB * TILE_BYTES;
  constexpr int STAGE_BYTES = 2 * OP_BYTES;
  // the block's k and v tiles, then the ring: stage s has its q tile at s *
  // STAGE_BYTES and its g tile after it; then the queries' lse (stats[s][0])
  // and delta (stats[s][1]); tiles start at multiples of 1024 bytes
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (1024 - (smem_u32(smem_raw) & 1023)) % 1024;
  const uint32_t ks = smem_u32(smem);
  const uint32_t vs = ks + OP_BYTES;
  const uint32_t ring = vs + OP_BYTES;
  float (*stats)[2][TILE] =
      reinterpret_cast<float (*)[2][TILE]>(smem + (2 + 2 * STAGES) * OP_BYTES);
  const uint32_t stats_base = ks + (2 + 2 * STAGES) * OP_BYTES;

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
  const TileCopier<THREADS, D> copy_q(qb, tok, N, tid), copy_g(gb, tok, N, tid);
  const int n_tiles = (N + TILE - 1) / TILE;
  auto load_stage = [&](int t) {
    if (t < n_tiles) {
      const int stage = t % STAGES;
      const int r0 = t * TILE;
      const uint32_t tiles = ring + stage * STAGE_BYTES;
      copy_q(tiles, r0);
      copy_g(tiles + OP_BYTES, r0);
      const int which = tid >> 6;
      const int i = tid & (TILE - 1);
      const bool ok = r0 + i < N;
      const float* src = (which == 0 ? lb : db) + (ok ? r0 + i : 0);
      cp_async_4(stats_base + ((stage * 2 + which) * TILE + i) * 4, src, ok);
    }
    cp_async_commit();  // an empty group past the last tile keeps the count in flight the same
  };

  TileCopier<THREADS, D>(k + koff, tok, M, tid)(ks, k0);  // land with the first stage
  if constexpr (WANT_DK) TileCopier<THREADS, D>(v + koff, tok, M, tid)(vs, k0);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load_stage(t);
  const uint64_t kd = wgmma_desc(ks);
  const uint64_t vd = wgmma_desc(vs);

  bool own[2];  // rows g and g + 8 of the warp's 16 are keys
#pragma unroll
  for (int r = 0; r < 2; ++r) own[r] = k0 + warp * 16 + (lane >> 2) + 8 * r < M;
  float dk_acc[WANT_DK ? NSUB : 1][8][4], dv_acc[WANT_DV ? NSUB : 1][8][4];
#pragma unroll
  for (int hh = 0; hh < NSUB; ++hh) {
    if constexpr (WANT_DK) zero_acc(dk_acc[hh]);
    if constexpr (WANT_DV) zero_acc(dv_acc[hh]);
  }
  const float sl2 = scale * LOG2E;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // this thread's share of tile t has landed
    fence_proxy_async();          // and is visible to wgmma
    __syncthreads();              // everyone's is, and everyone is done with tile t - 1,
    load_stage(t + STAGES - 1);   // whose stage the tile STAGES - 1 ahead now takes
    const uint32_t qs = ring + (t % STAGES) * STAGE_BYTES;
    const uint64_t qd = wgmma_desc(qs);
    const uint64_t gd = wgmma_desc(qs + OP_BYTES);
    const float* ls = stats[t % STAGES][0];
    const float* ds = stats[t % STAGES][1];

    float st[8][4], dpt[8][4];  // S^T and dP^T: rows are keys, columns queries
    zero_acc(st);  // never added: the first wgmma of each product overwrites them
    zero_acc(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16<0>(st, kd + k_step(kk), qd + k_step(kk), kk > 0);
    if constexpr (WANT_DK) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16<0>(dpt, vd + k_step(kk), gd + k_step(kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin(st);
    if constexpr (WANT_DK) wgmma_pin(dpt);

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
        if constexpr (WANT_DK) dpt[j][e] = p * (dpt[j][e] - dl) * scale;  // dS^T, fp32
      }
    }
    uint32_t pf[4][4], dsf[4][4];
    if constexpr (WANT_DV) pack_a_frags(pf, st);
    if constexpr (WANT_DK) pack_a_frags(dsf, dpt);
    wgmma_fence();
    if constexpr (WANT_DV) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dv += P^T . g
#pragma unroll
        for (int hh = 0; hh < NSUB; ++hh)
          wgmma_m64n64k16<1>(dv_acc[hh], pf[kk], gd + hh * WGMMA_SUB_STEP + kk * WGMMA_ROW_STEP,
                             1);
    }
    if constexpr (WANT_DK) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dk += dS^T . q
#pragma unroll
        for (int hh = 0; hh < NSUB; ++hh)
          wgmma_m64n64k16<1>(dk_acc[hh], dsf[kk], qd + hh * WGMMA_SUB_STEP + kk * WGMMA_ROW_STEP,
                             1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int hh = 0; hh < NSUB; ++hh) {
      if constexpr (WANT_DV) wgmma_pin(dv_acc[hh]);
      if constexpr (WANT_DK) wgmma_pin(dk_acc[hh]);
    }
    if constexpr (WANT_DV) wgmma_pin(pf);
    if constexpr (WANT_DK) wgmma_pin(dsf);
  }
  __syncthreads();  // every warp is done with the k and v tiles: they now stage the output
#pragma unroll
  for (int hh = 0; hh < NSUB; ++hh) {
    if constexpr (WANT_DK)
      store_rows(smem + hh * TILE_BYTES, warp * 16, dk_acc[hh], dk + koff + hh * SUB, tok, k0, M,
                 lane);
    if constexpr (WANT_DV)
      store_rows(smem + (NSUB + hh) * TILE_BYTES, warp * 16, dv_acc[hh], dv + koff + hh * SUB,
                 tok, k0, M, lane);
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* g, const void* lse,
                 void* delta, void* dq, void* dk, void* dv, int B, int N, int M, int H,
                 float scale, cudaStream_t st) {
  using T = __nv_bfloat16;
  // above the 48 KB a kernel gets unasked; the attribute is per device, so it
  // is set at every launch
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM<D>);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((N + ROWS - 1) / ROWS, H, B);
  attn_bwd_dq_wgmma<D><<<grid_q, THREADS, BWD_SMEM<D>, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<T*>(dq), N, M, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the dkdv launches read the delta that the dq kernel wrote: same stream, so
  // they run after it
  const dim3 grid_k((M + ROWS - 1) / ROWS, H, B);
  auto dkdv = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         BWD_SMEM<D>);
    if (e != cudaSuccess) return e;
    kernel<<<grid_k, THREADS, BWD_SMEM<D>, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(g), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), N, M, H,
        scale);
    return cudaGetLastError();
  };
  if constexpr (D == 64) {
    return (int)dkdv(attn_bwd_dkdv_wgmma<D, DK_DV>);
  } else {
    err = dkdv(attn_bwd_dkdv_wgmma<D, DK_ONLY>);
    if (err != cudaSuccess) return (int)err;
    return (int)dkdv(attn_bwd_dkdv_wgmma<D, DV_ONLY>);
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int PART = 32;      // dims held by one thread of a row's group
constexpr int ROWS32 = 64;    // rows (queries or keys) owned by a block
constexpr int TILE32 = 32;    // rows of the streamed operands per shared-memory tile

// SPLIT = D / PART threads share a row.  Local index l of a thread's part
// <-> dim of the row: float4 group SPLIT*(l/4) + part, so the threads of a
// row interleave 16-byte groups.
template <int SPLIT>
__device__ __forceinline__ int dim_of(int l, int part) {
  return 4 * (SPLIT * (l >> 2) + part) + (l & 3);
}

template <int SPLIT>
__device__ __forceinline__ void load_part(float (&r)[PART], const float* row, int part,
                                          bool active) {
#pragma unroll
  for (int l = 0; l < PART; ++l) r[l] = active ? row[dim_of<SPLIT>(l, part)] : 0.f;
}

template <int SPLIT>
__device__ __forceinline__ void store_part(float* row, const float (&r)[PART], int part) {
#pragma unroll
  for (int l = 0; l < PART; ++l) row[dim_of<SPLIT>(l, part)] = r[l];
}

// Rows r0 .. r0+TILE32 of a (rows, H, D) operand of one (batch, head) into a
// [TILE32][D] fp32 tile, zeros past n_rows.  Neighbouring threads read
// neighbouring addresses.
template <int D, int THREADS32>
__device__ __forceinline__ void load_tile32(float (*tile)[D], const float* base, long long tok,
                                            int r0, int n_rows, int tid) {
  for (int i = tid; i < TILE32 * D; i += THREADS32) {
    const int j = i / D;
    const int d = i % D;
    tile[j][d] = (r0 + j < n_rows) ? base[(long long)(r0 + j) * tok + d] : 0.f;
  }
}

// This thread's part of dot(r, row) where row is a [D] shared-memory row.
template <int SPLIT>
__device__ __forceinline__ float part_dot(const float (&r)[PART], const float* row, int part) {
  const float4* p = reinterpret_cast<const float4*>(row) + part;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int m = 0; m < PART / 4; ++m) {
    const float4 x = p[SPLIT * m];
    s0 = fmaf(r[4 * m + 0], x.x, s0);
    s1 = fmaf(r[4 * m + 1], x.y, s1);
    s2 = fmaf(r[4 * m + 2], x.z, s2);
    s3 = fmaf(r[4 * m + 3], x.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// acc += c * row, on this thread's part of the dims.
template <int SPLIT>
__device__ __forceinline__ void part_axpy(float (&acc)[PART], float c, const float* row,
                                          int part) {
  const float4* p = reinterpret_cast<const float4*>(row) + part;
#pragma unroll
  for (int m = 0; m < PART / 4; ++m) {
    const float4 x = p[SPLIT * m];
    acc[4 * m + 0] = fmaf(c, x.x, acc[4 * m + 0]);
    acc[4 * m + 1] = fmaf(c, x.y, acc[4 * m + 1]);
    acc[4 * m + 2] = fmaf(c, x.z, acc[4 * m + 2]);
    acc[4 * m + 3] = fmaf(c, x.w, acc[4 * m + 3]);
  }
}

// The sum over the SPLIT neighbouring threads of a row (2 or 4).
template <int SPLIT>
__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  if (SPLIT == 4) x += __shfl_xor_sync(FULL, x, 2);
  return x;
}

template <int D>
__global__ void __launch_bounds__(ROWS32 * (D / PART))
attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ g,
                const float* __restrict__ lse, float* __restrict__ delta,
                float* __restrict__ dq, int N, int M, int H, float scale) {
  constexpr int SPLIT = D / PART;
  constexpr int THREADS32 = ROWS32 * SPLIT;
  __shared__ __align__(16) float ks[TILE32][D];
  __shared__ __align__(16) float vs[TILE32][D];

  const int tid = threadIdx.x;
  const int part = tid % SPLIT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qi = blockIdx.x * ROWS32 + tid / SPLIT;
  const bool active = qi < N;
  const long long tok = (long long)H * D;  // elements between consecutive tokens
  const long long qoff = ((long long)b * N + (active ? qi : 0)) * tok + (long long)h * D;
  const long long stat = ((long long)b * H + h) * N + (active ? qi : 0);

  float qr[PART], gr[PART], acc[PART];
  load_part<SPLIT>(qr, q + qoff, part, active);
  load_part<SPLIT>(gr, g + qoff, part, active);
#pragma unroll
  for (int l = 0; l < PART; ++l) acc[l] = 0.f;
  const float row_lse = active ? lse[stat] : 0.f;

  const float* kb = k + (long long)b * M * tok + (long long)h * D;
  const float* vb = v + (long long)b * M * tok + (long long)h * D;

  // first pass over the keys: delta = rowsum(P * dP); the threads of a row
  // hold the same s and dP, so all end with the same delta
  float dl = 0.f;
  for (int k0 = 0; k0 < M; k0 += TILE32) {
    const int nk = min(TILE32, M - k0);
    __syncthreads();
    load_tile32<D, THREADS32>(ks, kb, tok, k0, M, tid);
    load_tile32<D, THREADS32>(vs, vb, tok, k0, M, tid);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float s = group_sum<SPLIT>(part_dot<SPLIT>(qr, ks[j], part)) * scale;
      const float dp = group_sum<SPLIT>(part_dot<SPLIT>(gr, vs[j], part));
      dl = fmaf(__expf(s - row_lse), dp, dl);
    }
  }
  if (active && part == 0) delta[stat] = dl;

  // second pass: dq = sum_j dS_ij k_j
  for (int k0 = 0; k0 < M; k0 += TILE32) {
    const int nk = min(TILE32, M - k0);
    __syncthreads();  // every thread is done with the previous tile
    load_tile32<D, THREADS32>(ks, kb, tok, k0, M, tid);
    load_tile32<D, THREADS32>(vs, vb, tok, k0, M, tid);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float s = group_sum<SPLIT>(part_dot<SPLIT>(qr, ks[j], part)) * scale;
      const float dp = group_sum<SPLIT>(part_dot<SPLIT>(gr, vs[j], part));
      const float p = __expf(s - row_lse);
      part_axpy<SPLIT>(acc, p * (dp - dl) * scale, ks[j], part);
    }
  }
  if (active) store_part<SPLIT>(dq + qoff, acc, part);
}

template <int D>
__global__ void __launch_bounds__(ROWS32 * (D / PART))
attn_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ g,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int N, int M, int H,
                  float scale) {
  constexpr int SPLIT = D / PART;
  constexpr int THREADS32 = ROWS32 * SPLIT;
  __shared__ __align__(16) float qs[TILE32][D];
  __shared__ __align__(16) float gs[TILE32][D];
  __shared__ float ls[TILE32];
  __shared__ float ds[TILE32];

  const int tid = threadIdx.x;
  const int part = tid % SPLIT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kj = blockIdx.x * ROWS32 + tid / SPLIT;
  const bool active = kj < M;
  const long long tok = (long long)H * D;
  const long long koff = ((long long)b * M + (active ? kj : 0)) * tok + (long long)h * D;

  float kr[PART], vr[PART], dkr[PART], dvr[PART];
  load_part<SPLIT>(kr, k + koff, part, active);
  load_part<SPLIT>(vr, v + koff, part, active);
#pragma unroll
  for (int l = 0; l < PART; ++l) { dkr[l] = 0.f; dvr[l] = 0.f; }

  const float* qb = q + (long long)b * N * tok + (long long)h * D;
  const float* gb = g + (long long)b * N * tok + (long long)h * D;
  const float* lb = lse + ((long long)b * H + h) * N;
  const float* db = delta + ((long long)b * H + h) * N;

  for (int q0 = 0; q0 < N; q0 += TILE32) {
    const int nq = min(TILE32, N - q0);
    __syncthreads();
    load_tile32<D, THREADS32>(qs, qb, tok, q0, N, tid);
    load_tile32<D, THREADS32>(gs, gb, tok, q0, N, tid);
    if (tid < TILE32) {
      const bool ok = q0 + tid < N;
      ls[tid] = ok ? lb[q0 + tid] : 0.f;
      ds[tid] = ok ? db[q0 + tid] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < nq; ++i) {
      const float s = group_sum<SPLIT>(part_dot<SPLIT>(kr, qs[i], part)) * scale;
      const float dp = group_sum<SPLIT>(part_dot<SPLIT>(vr, gs[i], part));
      const float p = active ? __expf(s - ls[i]) : 0.f;
      part_axpy<SPLIT>(dvr, p, gs[i], part);
      part_axpy<SPLIT>(dkr, p * (dp - ds[i]) * scale, qs[i], part);
    }
  }
  if (active) {
    store_part<SPLIT>(dk + koff, dkr, part);
    store_part<SPLIT>(dv + koff, dvr, part);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* g, const void* lse,
               void* delta, void* dq, void* dk, void* dv, int B, int N, int M, int H,
               float scale, cudaStream_t st) {
  using T = float;
  constexpr int THREADS32 = ROWS32 * (D / PART);
  const dim3 grid_q((N + ROWS32 - 1) / ROWS32, H, B);
  attn_bwd_dq_f32<D><<<grid_q, THREADS32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<T*>(dq), N, M, H, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // reads the delta that the dq kernel wrote: same stream, so it runs after it
  const dim3 grid_k((M + ROWS32 - 1) / ROWS32, H, B);
  attn_bwd_dkdv_f32<D><<<grid_k, THREADS32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), N, M, H,
      scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* g, const void* lse,
           void* delta, void* dq, void* dk, void* dv, int B, int N, int M, int H, float scale,
           int dtype, cudaStream_t st) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, g, lse, delta, dq, dk, dv, B, N, M, H, scale, st);
  if (dtype == 1)
    return launch_wgmma<D>(q, k, v, g, lse, delta, dq, dk, dv, B, N, M, H, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 64 or 128.  lse is the forward's
// log-sum-exp; delta is (B, H, N) fp32 scratch.  bf16 operands must be
// 16-byte aligned.  Returns the cudaError_t of the first launch that failed,
// or 0.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                   const void* lse, void* delta, void* dq, void* dk, void* dv,
                                   int B, int N, int M, int H, int head_dim, float scale,
                                   int dtype, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || H <= 0 || H > 65535 || B > 65535 || !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch<64>(q, k, v, g, lse, delta, dq, dk, dv, B, N, M, H, scale, dtype, st);
  if (head_dim == 128)
    return launch<128>(q, k, v, g, lse, delta, dq, dk, dv, B, N, M, H, scale, dtype, st);
  return (int)cudaErrorInvalidValue;
}

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
// Blocks on this card run in no order and a block cannot hold K/V for
// M = 1024 (512 KB in fp32 against 227 KB of shared memory).  So the work is
// split by ownership into two kernels, and no sum ever crosses a block (no
// atomics: the gradients are the same bits on every run):
//
//   attn_bwd_dq    a block owns 64 queries and streams the K/V tiles twice:
//                  once for each row's delta, once for dq; writes both;
//   attn_bwd_dkdv  a block owns 64 keys, streams q/g tiles with their
//                  log-sum-exp and delta, writes dk and dv.
//
// P is rebuilt in both from the forward's per-row log-sum-exp, P = exp(s -
// lse), so no pass over the keys is needed to find a row's max and sum.
// delta is summed as rowsum(P * dP) from the very P and dP that dS is then
// formed from.  rowsum(g * o) is the same number on paper and needs no pass,
// but o comes back rounded to the input type: in bf16 that error (2^-9 of
// |g||o|) does not cancel over the keys as dP - delta does, and where
// attention is near uniform, as at initialisation, it drowned dq and dk
// (mean relative error 1.4 in the last layer's to_q gradient, against 0.13
// for bf16 rounding alone).
//
// A row (query or key) belongs to a pair of neighbouring threads.  Each holds
// half of the row's 64 dims (the float4 groups of its parity, so that the two
// read neighbouring shared-memory banks) and half of the accumulators: 128
// fp32 registers of state instead of 256.  The two halves of a dot product
// meet through one __shfl_xor_sync.
//
// Ragged M (77 text tokens): the dq kernel loops over the valid keys of the
// last tile only; key threads past M accumulate and store nothing.  Ragged N:
// query threads past N load zeros, which add nothing to dk/dv, and store
// nothing.
//
// Layout: q, g, dq (B, N, H, D); k, v, dk, dv (B, M, H, D); lse and delta
// (B, H, N) fp32; all contiguous.  D = 64.  fp32 or bf16 in; every product
// accumulates in fp32, and P and dS stay in fp32 (the TPU kernel rounds them
// to the input type before its products; the plain PyTorch version beside the
// wrapper follows this kernel).  Gradients are written in the input type.
//
// Bound on this card: 10*B*H*N*M*D operations (five products).  This first
// version runs them on the fp32 CUDA cores and recomputes s and dP in both
// kernels and for delta (18*B*H*N*M*D in all); tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 64;         // head dim
constexpr int HALF = D / 2;   // dims held by one thread of a pair
constexpr int ROWS = 64;      // rows (queries or keys) owned by a block
constexpr int THREADS = 2 * ROWS;
constexpr int TILE = 32;      // rows of the streamed operands per shared-memory tile
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Local index l of a thread's half row <-> dim of the row: float4 group
// 2*(l/4) + half, so the two threads of a pair interleave 16-byte groups.
__device__ __forceinline__ int dim_of(int l, int half) {
  return 8 * (l >> 2) + 4 * half + (l & 3);
}

template <typename T>
__device__ __forceinline__ void load_half(float (&r)[HALF], const T* row, int half, bool active) {
#pragma unroll
  for (int l = 0; l < HALF; ++l) r[l] = active ? to_f(row[dim_of(l, half)]) : 0.f;
}

template <typename T>
__device__ __forceinline__ void store_half(T* row, const float (&r)[HALF], int half) {
#pragma unroll
  for (int l = 0; l < HALF; ++l) store_f(row + dim_of(l, half), r[l]);
}

// Rows r0 .. r0+TILE of a (rows, H, D) operand of one (batch, head) into a
// [TILE][D] fp32 tile, zeros past n_rows.  Neighbouring threads read
// neighbouring addresses.
template <typename T>
__device__ __forceinline__ void load_tile(float (*tile)[D], const T* base, long long tok,
                                          int r0, int n_rows, int tid) {
  for (int i = tid; i < TILE * D; i += THREADS) {
    const int j = i / D;
    const int d = i % D;
    tile[j][d] = (r0 + j < n_rows) ? to_f(base[(long long)(r0 + j) * tok + d]) : 0.f;
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
__device__ __forceinline__ void half_axpy(float (&acc)[HALF], float c, const float* row, int half) {
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ g, const float* __restrict__ lse, float* __restrict__ delta,
            T* __restrict__ dq, int N, int M, int H, float scale) {
  __shared__ __align__(16) float ks[TILE][D];
  __shared__ __align__(16) float vs[TILE][D];

  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qi = blockIdx.x * ROWS + (tid >> 1);
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

  const T* kb = k + (long long)b * M * tok + (long long)h * D;
  const T* vb = v + (long long)b * M * tok + (long long)h * D;

  // first pass over the keys: delta = rowsum(P * dP); both threads of a pair
  // hold the same s and dP, so both end with the same delta
  float dl = 0.f;
  for (int k0 = 0; k0 < M; k0 += TILE) {
    const int nk = min(TILE, M - k0);
    __syncthreads();
    load_tile(ks, kb, tok, k0, M, tid);
    load_tile(vs, vb, tok, k0, M, tid);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float s = pair_sum(half_dot(qr, ks[j], half)) * scale;
      const float dp = pair_sum(half_dot(gr, vs[j], half));
      dl = fmaf(__expf(s - row_lse), dp, dl);
    }
  }
  if (active && half == 0) delta[stat] = dl;

  // second pass: dq = sum_j dS_ij k_j
  for (int k0 = 0; k0 < M; k0 += TILE) {
    const int nk = min(TILE, M - k0);
    __syncthreads();  // every thread is done with the previous tile
    load_tile(ks, kb, tok, k0, M, tid);
    load_tile(vs, vb, tok, k0, M, tid);
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ g, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
              int N, int M, int H, float scale) {
  __shared__ __align__(16) float qs[TILE][D];
  __shared__ __align__(16) float gs[TILE][D];
  __shared__ float ls[TILE];
  __shared__ float ds[TILE];

  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kj = blockIdx.x * ROWS + (tid >> 1);
  const bool active = kj < M;
  const long long tok = (long long)H * D;
  const long long koff = ((long long)b * M + (active ? kj : 0)) * tok + (long long)h * D;

  float kr[HALF], vr[HALF], dkr[HALF], dvr[HALF];
  load_half(kr, k + koff, half, active);
  load_half(vr, v + koff, half, active);
#pragma unroll
  for (int l = 0; l < HALF; ++l) { dkr[l] = 0.f; dvr[l] = 0.f; }

  const T* qb = q + (long long)b * N * tok + (long long)h * D;
  const T* gb = g + (long long)b * N * tok + (long long)h * D;
  const float* lb = lse + ((long long)b * H + h) * N;
  const float* db = delta + ((long long)b * H + h) * N;

  for (int q0 = 0; q0 < N; q0 += TILE) {
    const int nq = min(TILE, N - q0);
    __syncthreads();
    load_tile(qs, qb, tok, q0, N, tid);
    load_tile(gs, gb, tok, q0, N, tid);
    if (tid < TILE) {
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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g, const void* lse,
           void* delta, void* dq, void* dk, void* dv, int B, int N, int M, int H, float scale,
           cudaStream_t st) {
  const dim3 grid_q((N + ROWS - 1) / ROWS, H, B);
  attn_bwd_dq<T><<<grid_q, THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<T*>(dq), N, M, H, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // reads the delta that attn_bwd_dq wrote: same stream, so it runs after it
  const dim3 grid_k((M + ROWS - 1) / ROWS, H, B);
  attn_bwd_dkdv<T><<<grid_k, THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), N, M, H,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  lse is the forward's log-sum-exp; delta
// is (B, H, N) fp32 scratch.  Returns the cudaError_t of the first launch that
// failed, or 0.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                   const void* lse, void* delta, void* dq, void* dk, void* dv,
                                   int B, int N, int M, int H, int head_dim, float scale,
                                   int dtype, void* stream) {
  if (head_dim != D || B <= 0 || N <= 0 || M <= 0 || H <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, g, lse, delta, dq, dk, dv, B, N, M, H, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, g, lse, delta, dq, dk, dv, B, N, M, H, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Non-causal flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paintmind_tpu/ops/flash_attention.py::
// _flash_forward (kernel _attn_kernel).  That kernel keeps all of one
// (batch, head)'s K/V in VMEM; on this card a block has at most 227 KB of
// shared memory, which does not hold K/V for M = 1024 in fp32 (512 KB).  So
// one block owns one (batch, head, tile of BQ queries), one query per thread,
// and streams K/V through shared memory in tiles of BK keys, carrying an
// online-softmax running max and sum in fp32.  Ragged M (77 text tokens) is
// handled by looping only over the valid keys of the last tile: no padding
// copy, no -inf fill.  Ragged N is handled by idle threads that store nothing.
//
// Layout: q (B, N, H, D), k and v (B, M, H, D), o (B, N, H, D), contiguous.
// D is fixed at 64 (every attention of the model); fp32 or bf16 in, fp32
// accumulation and softmax, output in the input type.  When a gradient is
// wanted the caller passes lse, a (B, H, N) fp32 buffer that receives each
// row's log-sum-exp of the scaled scores (max + log of the running sum): the
// backward kernel (flash_attention_bwd.cu) rebuilds P from it tile by tile.
//
// Bound on this card: 4*B*H*N*M*D operations.  This first version runs them
// on the fp32 CUDA cores with broadcast shared-memory reads (no tensor cores,
// no TMA); the operands are read from device memory once per query tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 64;    // head dim
constexpr int BQ = 128;  // queries per block, one per thread
constexpr int BK = 32;   // keys per shared-memory tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(BQ)
attn_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         T* __restrict__ o, float* __restrict__ lse, int N, int M, int H, float scale) {
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  __shared__ float ss[BK][BQ];  // this tile's scores, [key][query]: no bank conflicts

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qi = blockIdx.x * BQ + tid;
  const bool active = qi < N;
  const long long tok = (long long)H * D;  // elements between consecutive tokens

  float qr[D];
  float acc[D];
  if (active) {
    const T* qp = q + ((long long)b * N + qi) * tok + (long long)h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = to_f(qp[d]);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m_run = -INFINITY;
  float l_run = 0.f;

  const T* kb = k + (long long)b * M * tok + (long long)h * D;
  const T* vb = v + (long long)b * M * tok + (long long)h * D;

  for (int k0 = 0; k0 < M; k0 += BK) {
    const int nk = min(BK, M - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < BK * D; i += BQ) {
      const int j = i / D;
      const int d = i % D;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        const long long off = (long long)(k0 + j) * tok + d;
        kv = to_f(kb[off]);
        vv = to_f(vb[off]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();

    float tile_max = -INFINITY;
    for (int j = 0; j < nk; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks[j]);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kk = kr[d4];
        s0 = fmaf(qr[4 * d4 + 0], kk.x, s0);
        s1 = fmaf(qr[4 * d4 + 1], kk.y, s1);
        s2 = fmaf(qr[4 * d4 + 2], kk.z, s2);
        s3 = fmaf(qr[4 * d4 + 3], kk.w, s3);
      }
      const float s = ((s0 + s1) + (s2 + s3)) * scale;
      ss[j][tid] = s;
      tile_max = fmaxf(tile_max, s);
    }

    const float m_new = fmaxf(m_run, tile_max);
    const float corr = __expf(m_run - m_new);  // 0 on the first tile
    l_run *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;

    for (int j = 0; j < nk; ++j) {
      const float p = __expf(ss[j][tid] - m_new);
      l_run += p;
      const float4* vr = reinterpret_cast<const float4*>(vs[j]);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
    m_run = m_new;
  }

  if (active) {
    T* op = o + ((long long)b * N + qi) * tok + (long long)h * D;
    const float inv = 1.f / l_run;
#pragma unroll
    for (int d = 0; d < D; ++d) store_f(op + d, acc[d] * inv);
    if (lse != nullptr) lse[((long long)b * H + h) * N + qi] = m_run + logf(l_run);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; lse may be null (no gradient wanted).
// Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int N, int M, int H, int head_dim,
                                   float scale, int dtype, void* stream) {
  if (head_dim != D || B <= 0 || N <= 0 || M <= 0 || H <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BQ - 1) / BQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  if (dtype == 0) {
    attn_fwd<float><<<grid, BQ, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lp, N, M, H, scale);
  } else if (dtype == 1) {
    attn_fwd<__nv_bfloat16><<<grid, BQ, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lp, N,
        M, H, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Fused codebook nearest-neighbour lookup for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paintmind_tpu/ops/vq_lookup.py::
// _fused_nearest_codes (kernel _lookup_kernel): argmax_j z.e_j over
// l2-normalised rows, ties to the lowest index, without writing the
// (T, C) score matrix to device memory.  The TPU grid carried a running
// (best value, best index) from one codebook block to the next; here blocks
// run in no order, so each block owns a tile of 32 tokens outright (one per
// lane) and loops over the whole codebook itself.  The block's 8 warps split
// every shared-memory codebook tile (32 codes each), keep a running best
// under a strict '>' (so a later, equal score never replaces an earlier
// index), and the 8 partial bests are reduced inside the block, again
// preferring the lower index on equal scores.  Nothing crosses blocks.
//
// Layout: z (T, 32) fp32, e (C, 32) fp32, out (T,) int32, contiguous.
// Bound on this card: 2*T*C*32 fp32 operations (the bytes are ~2 MB); they
// run on the fp32 CUDA cores with broadcast shared-memory reads.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int DZ = 32;            // code dim
constexpr int TT = 32;            // tokens per block, one per lane
constexpr int WARPS = 8;          // warps splitting each codebook tile
constexpr int CT = WARPS * 32;    // codes per shared-memory tile
constexpr int THREADS = WARPS * 32;

__global__ void __launch_bounds__(THREADS)
vq_lookup(const float* __restrict__ z, const float* __restrict__ e,
          int* __restrict__ out, int T, int C) {
  __shared__ __align__(16) float es[CT][DZ];  // 32 KB
  __shared__ float best_v[WARPS][TT];
  __shared__ int best_i[WARPS][TT];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t = blockIdx.x * TT + lane;

  float zr[DZ];
  if (t < T) {
    const float4* zp = reinterpret_cast<const float4*>(z + (long long)t * DZ);
#pragma unroll
    for (int d4 = 0; d4 < DZ / 4; ++d4) {
      const float4 zz = zp[d4];
      zr[4 * d4 + 0] = zz.x;
      zr[4 * d4 + 1] = zz.y;
      zr[4 * d4 + 2] = zz.z;
      zr[4 * d4 + 3] = zz.w;
    }
  } else {
#pragma unroll
    for (int d = 0; d < DZ; ++d) zr[d] = 0.f;
  }

  float best = -INFINITY;
  int arg = 0;
  for (int c0 = 0; c0 < C; c0 += CT) {
    const int nc = min(CT, C - c0);
    __syncthreads();
    for (int i = tid; i < CT * DZ; i += THREADS) {
      const int j = i / DZ;
      es[j][i % DZ] = j < nc ? e[(long long)c0 * DZ + i] : 0.f;
    }
    __syncthreads();
    const int jlo = warp * 32;
    const int jhi = min(jlo + 32, nc);
    for (int j = jlo; j < jhi; ++j) {
      const float4* er = reinterpret_cast<const float4*>(es[j]);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DZ / 4; ++d4) {
        const float4 ee = er[d4];
        s0 = fmaf(zr[4 * d4 + 0], ee.x, s0);
        s1 = fmaf(zr[4 * d4 + 1], ee.y, s1);
        s2 = fmaf(zr[4 * d4 + 2], ee.z, s2);
        s3 = fmaf(zr[4 * d4 + 3], ee.w, s3);
      }
      const float s = (s0 + s1) + (s2 + s3);
      if (s > best) {  // strict: equal later codes keep the earlier index
        best = s;
        arg = c0 + j;
      }
    }
  }

  best_v[warp][lane] = best;
  best_i[warp][lane] = arg;
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < WARPS; ++w) {
      const float v = best_v[w][lane];
      const int i = best_i[w][lane];
      if (v > best || (v == best && i < arg)) {
        best = v;
        arg = i;
      }
    }
    if (t < T) out[t] = arg;
  }
}

}  // namespace

// Returns the cudaError_t of the launch.
extern "C" int vq_lookup_fwd(const void* z, const void* e, void* out, int T, int C,
                             int dim, void* stream) {
  if (dim != DZ || T <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (T + TT - 1) / TT;
  vq_lookup<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(e),
      static_cast<int*>(out), T, C);
  return (int)cudaGetLastError();
}

// K6: QK-norm and the rotary embedding of SDAR-30B-A3B's attention in one
// pass over q or k (sm_90a), the result stored where the caller wants it
// (k straight into its rows of the KV cache).
//
// Replaces no TPU kernel: the JAX package has no SDAR stack.  In plain
// PyTorch the same function (ops/rope.py: norm_rope_plain) is some eight
// passes over the tensor in fp32 (a cast, the norm's reduction, products,
// a roll, a sum, a cast back), 0.43 ms for one block pass's q (64 x 64
// tokens x 32 heads x 128) on an H100, a fifth of the whole layer's time.
//
// What bounds it on this card: bytes.  It reads each element once (bf16)
// and writes it once (bf16), 4 bytes an element, and does some ten
// operations an element: 33.5 M elements of q are 134 MB, 0.040 ms at
// 3.35 TB/s.  So one warp takes one (token, head) row of D = 128 (or 64):
// lane l holds elements V l .. V l + V - 1 (V = D / 32) in registers, the
// row's sum of squares is a warp reduction (QK-norm: x / sqrt(mean(x²) +
// eps) · w, in fp32), and the rotate-half partner of element d, d ± D / 2,
// lies in lane l ^ 16: one shuffle.  out = y · cos + y_partner · sin with
// the tables' sin negated on the first half (ops/rope.py), rounded once to
// bf16.  Rows are independent; a warp loops over them grid-strided.
//
// Layout: x (B, N, H, D) bf16 contiguous; out (B, N, H, D) bf16 with batch
// and token strides of its own (heads and dims contiguous, strides multiples
// of 8 elements: a KV cache's rows [start, start + N)); cos and sin (N, D)
// fp32 contiguous, the positions of the N tokens; w (D) bf16, the norm's
// gain.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // eight warps, a row each at a time

template <int D>
__global__ void __launch_bounds__(THREADS)
    norm_rope_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                     __nv_bfloat16* __restrict__ out, long long out_b, long long out_n, int B,
                     int N, int H, float eps) {
  constexpr int V = D / 32;  // elements a lane
  const int lane = threadIdx.x & 31;
  const long long rows = (long long)B * N * H;
  const long long warps = (long long)gridDim.x * (THREADS / 32);
  for (long long r = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5); r < rows; r += warps) {
    const int h = (int)(r % H);
    const long long bn = r / H;
    const int n = (int)(bn % N);
    const int b = (int)(bn / N);
    float y[V];
    const __nv_bfloat16* src = x + r * D + lane * V;
#pragma unroll
    for (int j = 0; j < V; j += 2) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + j));
      y[j] = f.x;
      y[j + 1] = f.y;
    }
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) ss = fmaf(y[j], y[j], ss);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float inv = rsqrtf(ss / D + eps);
#pragma unroll
    for (int j = 0; j < V; ++j) y[j] = y[j] * inv * __bfloat162float(w[lane * V + j]);
    const float* c = cos_t + (long long)n * D + lane * V;
    const float* s = sin_t + (long long)n * D + lane * V;
    __nv_bfloat16* dst = out + b * out_b + n * out_n + (long long)h * D + lane * V;
#pragma unroll
    for (int j = 0; j < V; j += 2) {
      const float p0 = __shfl_xor_sync(0xffffffffu, y[j], 16);
      const float p1 = __shfl_xor_sync(0xffffffffu, y[j + 1], 16);
      const float o0 = fmaf(p0, s[j], y[j] * c[j]);
      const float o1 = fmaf(p1, s[j + 1], y[j + 1] * c[j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dst + j) = __floats2bfloat162_rn(o0, o1);
    }
  }
}

}  // namespace

// out (B, N, H, D) = rope(norm(x)), w the norm's gain.  D 64 or 128; out_b and
// out_n the element strides of out's batch and token axes (multiples of 8).
// sms: the card's SM count.  Returns the cudaError_t of the launch.
extern "C" int norm_rope(const void* x, const void* w, const float* cos_t, const float* sin_t,
                         void* out, long long out_b, long long out_n, int B, int N, int H, int D,
                         float eps, int sms, void* stream) {
  if (w == nullptr || B <= 0 || N <= 0 || H <= 0 || sms <= 0 || out_b % 8 || out_n % 8 ||
      !(eps >= 0.f))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * N * H;
  const long long want = (rows + THREADS / 32 - 1) / (THREADS / 32);
  const int grid = (int)(want < 16LL * sms ? want : 16LL * sms);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 128)
    norm_rope_kernel<128><<<grid, THREADS, 0, st>>>(xp, wp, cos_t, sin_t, op, out_b, out_n, B, N,
                                                    H, eps);
  else if (D == 64)
    norm_rope_kernel<64><<<grid, THREADS, 0, st>>>(xp, wp, cos_t, sin_t, op, out_b, out_n, B, N,
                                                   H, eps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

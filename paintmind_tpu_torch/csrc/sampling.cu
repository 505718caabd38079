// Fused MaskGIT sampling head for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paintmind_tpu/ops/sampling.py::
// _fused_gumbel_topk_sample (kernel _sample_kernel).  For each row of logits:
//   pred = argmax (first index on a tie) of l / temp + gumbel over exactly the
//          k entries that topk_keep_mask keeps;
//   conf = softmax(l)[pred] under the original logits.
//
// Bound on this card: the bytes.  The logits are read once (134 MB in bf16 at
// 8192 rows x 8192 classes) and nothing but (pred, conf) is written; the
// arithmetic a logit cannot avoid is a max, an exp and a compare.  On a TPU a
// row reduction is one vector instruction; here a reduction across a block is
// a barrier, so the design has none:
//
//   * One warp owns a row and reads it once.  Lane i takes the 16-byte chunks
//     i, i + 32, ... (a warp's load is 512 contiguous bytes), UNROLL of them in
//     flight at a time, with streaming loads.  A row that does not start on a
//     16-byte boundary takes its first elements one per lane, and the elements
//     past the last whole chunk likewise, so any V and any element-aligned
//     row works.
//   * The k kept entries are the k largest under the total order (value
//     descending, column ascending): every entry is distinct under it, so
//     top-k with ties to the lower index is a plain selection.  Each lane keeps
//     a sorted list of its own best entries in registers.  A chunk whose
//     maximum does not beat the lane's last entry is skipped with one compare;
//     otherwise its elements are inserted under a strict '>'.  A lane meets its
//     columns in ascending order, so strict '>' keeps the lower column on equal
//     values.  The same chunk maximum drives an online log-sum-exp (m, s).
//   * A lane sees 1/32 of the row, so its own k-th best is a weak threshold and
//     some lane of the warp would insert at nearly every chunk.  After the
//     groups 1, 2, 4, ... of UNROLL chunks the lanes therefore share a lower
//     bound on the row's k-th value so far (k rounds of a shuffle maximum over
//     the lists' heads): whatever comes later in the row and does not beat it
//     strictly cannot be kept.
//   * After the pass the lanes merge: k rounds in which every lane offers the
//     head of its list, a 5-step shuffle tournament picks the best under the
//     total order, and the winning lane pops.  (m, s) merge by the usual
//     rescale.
//   * Noise is drawn for the k survivors only: lane r < k holds the r-th kept
//     (value, column), evaluates Philox 4x32-10 at counter (column, row low,
//     row high, 0) under the call's 64-bit seed, forms the Gumbel noise from the
//     first word's top 24 bits and the score value / temp + g with IEEE division
//     and logf (so the plain PyTorch version can follow it), and one more
//     tournament picks the largest score, the lower column on a tie.
//
// The list length is a template constant: 1, 5 or 16.  A k between two of
// them runs the next longer list and merges only k rounds (the merge yields
// the entries in order, so its first k are the top k).  k > 16 is refused.
//
// Layout: logits (rows, V) bf16 or fp32, contiguous; pred (rows,) int32; conf
// (rows,) fp32; seed one 64-bit word in device memory; the temperature either
// a value or a device pointer indexed by row / rows_per_temp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;         // rows per block, one per warp
constexpr int UNROLL = 4;        // 16-byte loads in flight per lane
constexpr int MAX_BLOCKS = 1 << 20;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NO_COL = 0x7fffffff;  // column of an empty list entry

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// exp(a - b) for a <= b; 1 when both are -inf (a lane that met no element)
__device__ __forceinline__ float rescale(float a, float b) {
  return a == b ? 1.f : exp2_approx((a - b) * LOG2E);
}

// (value, column) a before (value, column) b in the selection's total order
__device__ __forceinline__ bool before(float av, int ac, float bv, int bc) {
  return av > bv || (av == bv && ac < bc);
}

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int VEC = 4;
  static __device__ __forceinline__ void widen(const uint4& r, float (&x)[VEC]) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ float one(const float* p) { return __ldcs(p); }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static __device__ __forceinline__ void widen(const uint4& r, float (&x)[VEC]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ float one(const __nv_bfloat16* p) {
    const uint32_t w = __ldcs(reinterpret_cast<const unsigned short*>(p));
    return __uint_as_float(w << 16);
  }
};

// Philox 4x32-10 (Salmon et al. 2011), first output word.
__device__ __forceinline__ uint32_t philox_word(uint32_t c0, uint32_t c1, uint32_t c2,
                                                uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// One lane's running state over its share of a row.
template <int K>
struct Lane {
  float m, s;     // online log-sum-exp: s = sum exp(x - m)
  float val[K];   // the lane's K best entries, sorted by (value desc, column asc)
  int col[K];
  float thr;      // what a later entry must beat: max(val[K - 1], the warp's bound)

  __device__ __forceinline__ void init() {
    m = -INFINITY;
    s = 0.f;
    thr = -INFINITY;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      val[i] = -INFINITY;
      col[i] = NO_COL;
    }
  }

  // x: N consecutive logits starting at column col0, all later in the row
  // than anything this lane has met.
  template <int N>
  __device__ __forceinline__ void consume(const float (&x)[N], int col0) {
    float cmax = x[0];
#pragma unroll
    for (int e = 1; e < N; ++e) cmax = fmaxf(cmax, x[e]);
    const float nm = fmaxf(m, cmax);
#ifndef K3_NO_EXP  // timing experiment only: see kernel_times.py
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < N; ++e) part += exp2_approx((x[e] - nm) * LOG2E);
    s = s * rescale(m, nm) + part;
#endif
    m = nm;
#ifndef K3_NO_SELECT  // timing experiment only
    if (cmax > thr) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if (x[e] > thr) {
          val[K - 1] = x[e];
          col[K - 1] = col0 + e;
#pragma unroll
          for (int i = K - 1; i > 0; --i) {
            if (val[i] > val[i - 1]) {  // strict: an equal, earlier column stays ahead
              const float tv = val[i];
              val[i] = val[i - 1];
              val[i - 1] = tv;
              const int tc = col[i];
              col[i] = col[i - 1];
              col[i - 1] = tc;
            }
          }
          thr = fmaxf(thr, val[K - 1]);
        }
      }
    }
#endif
  }

  // A lower bound on the k-th largest value the warp has met: k rounds of
  // the lanes' maximum head, the lanes that hold it popping (lanes with equal
  // heads pop together, which only lowers the bound).  Every lane must call it.
  __device__ __forceinline__ float warp_kth(int k) const {
    float v[K];
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] = val[i];
    float kth = -INFINITY;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      if (r < k) {
        kth = v[0];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          kth = fmaxf(kth, __shfl_xor_sync(FULL, kth, off));
        if (v[0] == kth) {
#pragma unroll
          for (int i = 0; i + 1 < K; ++i) v[i] = v[i + 1];
          v[K - 1] = -INFINITY;
        }
      }
    }
    return kth;
  }
};

template <typename T, int K>
__global__ void __launch_bounds__(WARPS * 32)
sample_rows(const T* __restrict__ logits, const float* __restrict__ temp_ptr, float temp_value,
            long long rows_per_temp, const unsigned long long* __restrict__ seed_ptr,
            int* __restrict__ pred, float* __restrict__ conf, long long rows, int V, int k) {
  constexpr int VEC = Elem<T>::VEC;
  const int lane = threadIdx.x & 31;
  const unsigned long long seed = *seed_ptr;
  const long long stride = (long long)gridDim.x * WARPS;
  for (long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5); row < rows;
       row += stride) {
    const T* rp = logits + row * V;
    Lane<K> st;
    st.init();

    // the elements before the first 16-byte boundary, one per lane
    int head = (int)(((16 - (reinterpret_cast<uintptr_t>(rp) & 15)) & 15) / sizeof(T));
    head = min(head, V);
    if (lane < head) {
      const float x[1] = {Elem<T>::one(rp + lane)};
      st.consume(x, lane);
    }
    // whole 16-byte chunks: lane i takes chunks i, i + 32, ...
    const int nvec = (V - head) / VEC;
    const uint4* vp = reinterpret_cast<const uint4*>(rp + head);
    int c = lane;
    for (int group = 1; c - lane + 32 * UNROLL <= nvec; c += 32 * UNROLL, ++group) {
      uint4 r[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) r[u] = __ldcs(vp + c + 32 * u);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float x[VEC];
        Elem<T>::widen(r[u], x);
        st.consume(x, head + (c + 32 * u) * VEC);
      }
      // After groups 1, 2, 4, ... the lanes share a bound on the row's k-th
      // value.  Every column still to come is later than all that went into it,
      // so an entry that does not beat it strictly cannot be kept, and most
      // chunks of the rest of the row fail the one compare.
      if ((group & (group - 1)) == 0 && c - lane + 32 * UNROLL < nvec)
        st.thr = fmaxf(st.thr, st.warp_kth(k));
    }
    for (; c < nvec; c += 32) {  // fewer than UNROLL chunks a lane are left
      float x[VEC];
      Elem<T>::widen(__ldcs(vp + c), x);
      st.consume(x, head + c * VEC);
    }
    // the elements past the last whole chunk, one per lane
    const int tail = head + nvec * VEC + lane;
    if (tail < V) {
      const float x[1] = {Elem<T>::one(rp + tail)};
      st.consume(x, tail);
    }
    __syncwarp();

    // merge the log-sum-exp across the lanes
    float m = st.m, s = st.s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(FULL, m, off);
      const float os = __shfl_xor_sync(FULL, s, off);
      const float nm = fmaxf(m, om);
      s = s * rescale(m, nm) + os * rescale(om, nm);
      m = nm;
    }

    // merge the lists: round r leaves the r-th kept entry in lane r
    float kv = -INFINITY;
    int kc = NO_COL;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      if (r < k) {
        float bv = st.val[0];
        int bc = st.col[0];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(FULL, bv, off);
          const int oc = __shfl_xor_sync(FULL, bc, off);
          if (before(ov, oc, bv, bc)) {
            bv = ov;
            bc = oc;
          }
        }
        if (lane == r) {
          kv = bv;
          kc = bc;
        }
        if (st.col[0] == bc) {  // the winner pops its head
#pragma unroll
          for (int i = 0; i + 1 < K; ++i) {
            st.val[i] = st.val[i + 1];
            st.col[i] = st.col[i + 1];
          }
          st.val[K - 1] = -INFINITY;
          st.col[K - 1] = NO_COL;
        }
      }
    }

    // Gumbel noise at the survivors, then the argmax of the perturbed scores
    float temp = temp_ptr ? temp_ptr[row / rows_per_temp] : temp_value;
    temp = fmaxf(temp, 1e-10f);
    float score = -INFINITY;
    if (kc != NO_COL) {
      const uint32_t word = philox_word((uint32_t)kc, (uint32_t)row,
                                        (uint32_t)((unsigned long long)row >> 32), 0u,
                                        (uint32_t)seed, (uint32_t)(seed >> 32));
      const float u = (float)(word >> 8) * 5.9604644775390625e-08f;  // 2^-24
      const float g = -logf(-logf(fmaxf(u, 1e-20f)));
      score = kv / temp + g;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(FULL, score, off);
      const int oc = __shfl_xor_sync(FULL, kc, off);
      const float ov = __shfl_xor_sync(FULL, kv, off);
      if (before(os, oc, score, kc)) {  // first index on a tie, as argmax over the row
        score = os;
        kc = oc;
        kv = ov;
      }
    }
    if (lane == 0) {
      pred[row] = kc;
      conf[row] = expf(kv - m - logf(s));
    }
  }
}

template <typename T>
int launch(int list, const void* logits, const float* temp_ptr, float temp_value,
           long long rows_per_temp, const unsigned long long* seed, int* pred, float* conf,
           long long rows, int V, int k, cudaStream_t stream) {
  const long long want = (rows + WARPS - 1) / WARPS;
  const int blocks = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
#define SAMPLE_LAUNCH(K)                                                              \
  sample_rows<T, K><<<blocks, WARPS * 32, 0, stream>>>(                               \
      static_cast<const T*>(logits), temp_ptr, temp_value, rows_per_temp, seed, pred, \
      conf, rows, V, k)
  switch (list) {
    case 1: SAMPLE_LAUNCH(1); break;
    case 5: SAMPLE_LAUNCH(5); break;
    default: SAMPLE_LAUNCH(16); break;
  }
#undef SAMPLE_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch.  temp_ptr null: every row takes
// temp_value; else row r takes temp_ptr[r / rows_per_temp].
extern "C" int sample_fwd(const void* logits, int is_bf16, const void* temp_ptr, float temp_value,
                          long long rows_per_temp, const void* seed, void* pred, void* conf,
                          long long rows, int V, int k, void* stream) {
  if (rows <= 0 || V <= 0 || k < 1 || k > 16 || k > V || rows_per_temp < 1)
    return (int)cudaErrorInvalidValue;
  const int list = k == 1 ? 1 : k <= 5 ? 5 : 16;
  const float* tp = static_cast<const float*>(temp_ptr);
  const unsigned long long* sp = static_cast<const unsigned long long*>(seed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(list, logits, tp, temp_value, rows_per_temp, sp,
                                 static_cast<int*>(pred), static_cast<float*>(conf), rows, V, k,
                                 st);
  return launch<float>(list, logits, tp, temp_value, rows_per_temp, sp, static_cast<int*>(pred),
                       static_cast<float*>(conf), rows, V, k, st);
}

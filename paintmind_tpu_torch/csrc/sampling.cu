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
// The list length is a template constant: 1 or 5.  A k between them runs
// the 5-entry list and merges only k rounds (the merge yields the entries in
// order, so its first k are the top k).
//
// A second kernel, sample_rows_radix (K3r), below, takes any k up to V, and
// the wrapper sends it every k > 5: longer lists cost more than it does (on an
// H100 at bf16 8192 x 8192, 16-entry lists took 0.72 ms at k = 16 and 0.45 ms
// at k = 6, K3r 0.12 ms at either).  It gives a row to a block of 256 threads
// and computes the same function, the same survivors and the same noise, bit
// for bit.  A row is selected on order-preserving integer keys (a larger
// float is a larger key; -0 and +0 share one): 32-bit keys for fp32, 16-bit
// keys for bf16 (a bf16 widened to fp32 has its low 16 bits zero, so its
// key's low half says nothing).
//
//   * Pass 1 reads the row once, in 16-byte streaming loads (a warp's load is
//     512 contiguous bytes; the elements before the first 16-byte boundary
//     and past the last whole chunk one per lane), feeds an online
//     log-sum-exp, counts the keys' first digit, their top 11 bits (sign,
//     exponent and the top mantissa bits), in a 2048-bin shared histogram,
//     and keeps the keys of a row of up to 8192 elements in shared memory
//     (16 KB in bf16, 32 KB in fp32); a longer row is read again from memory
//     (L2) by every later sweep.  A block scan from the top finds the bin b
//     that holds the k-th largest key.
//   * One sweep writes every key whose digit is >= b (the survivors above b
//     and the candidates in b), with its column, into a 1024-entry shared
//     buffer in column order: thread t takes a contiguous run of chunks, and
//     a block scan of the threads' counts places their keys.
//   * The rest of the row is one warp's, with no block barrier: over the
//     buffer (over the row again when it overflowed: mass ties), the later
//     passes (bf16: 5 bits; fp32: 11, then 10) count the keys that match the
//     prefix so far, until the chosen bin holds exactly the keys still
//     needed or the key is complete; the keys of the last chosen bin (the
//     tied class) are admitted lowest column first, by a running count over
//     the entries in column order; the kept entries draw Philox noise at
//     the same counter under the same seed; shuffles take the argmax of
//     value / temp + g (the lower column on a tie) and merge the
//     log-sum-exp.
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
  // written out: a local array of the four words can land in local memory
  static __device__ __forceinline__ void widen(const uint4& r, float (&x)[VEC]) {
    x[0] = __uint_as_float(r.x << 16);
    x[1] = __uint_as_float(r.x & 0xffff0000u);
    x[2] = __uint_as_float(r.y << 16);
    x[3] = __uint_as_float(r.y & 0xffff0000u);
    x[4] = __uint_as_float(r.z << 16);
    x[5] = __uint_as_float(r.z & 0xffff0000u);
    x[6] = __uint_as_float(r.w << 16);
    x[7] = __uint_as_float(r.w & 0xffff0000u);
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

// The Gumbel noise of (row, column) under the call's seed: Philox at counter
// (column, row low, row high, 0), the first word's top 24 bits as u in [0, 1),
// -log(-log(max(u, 1e-20))) with IEEE logf (the plain version follows it).
__device__ __forceinline__ float gumbel_at(int col, long long row, unsigned long long seed) {
  const uint32_t word = philox_word((uint32_t)col, (uint32_t)row,
                                    (uint32_t)((unsigned long long)row >> 32), 0u,
                                    (uint32_t)seed, (uint32_t)(seed >> 32));
  const float u = (float)(word >> 8) * 5.9604644775390625e-08f;  // 2^-24
  return -logf(-logf(fmaxf(u, 1e-20f)));
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
    if (kc != NO_COL) score = kv / temp + gumbel_at(kc, row, seed);
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
  if (list == 1)
    SAMPLE_LAUNCH(1);
  else
    SAMPLE_LAUNCH(5);
#undef SAMPLE_LAUNCH
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3r: one block a row, radix select (see the head of this file)
// ---------------------------------------------------------------------------

constexpr int RS_THREADS = 256;
constexpr int RS_WARPS = RS_THREADS / 32;
constexpr int FIRST_BITS = 11;  // the first digit (RADIX_FIRST_BITS in ops/sampling.py)
constexpr int LATER_BITS = 11;  // widest digit of a later pass (RADIX_LATER_BITS)
constexpr int HIST_WORDS = 1 << (FIRST_BITS > LATER_BITS ? FIRST_BITS : LATER_BITS);
constexpr int CAP = 1024;     // entries of the buffer (RADIX_CAP)
constexpr int REG_V = 8192;   // rows up to this long keep their keys in shared memory

// Larger float, larger key; -0 and +0 map to one key, as they compare equal.
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t u = x == 0.f ? 0u : __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// bits of the selection's keys: the top half of the fp32 key for bf16
template <typename T>
struct KeyBits {
  static constexpr int value = 32;
};
template <>
struct KeyBits<__nv_bfloat16> {
  static constexpr int value = 16;
};

template <int BITS>
__device__ __forceinline__ uint32_t key_of(float x) {
  return order_key(x) >> (32 - BITS);
}

template <int BITS>
__device__ __forceinline__ float value_of(uint32_t key) {
  if (BITS == 32) return key_value(key);
  return key_value((key << 16) | ((key & 0x8000u) ? 0u : 0xffffu));
}

// A chunk's keys in 16 bytes: bf16 two a word (the lower column in the low
// half), fp32 one.
template <int BITS, int N>
__device__ __forceinline__ uint4 pack(const uint32_t (&k)[N]) {
  if constexpr (BITS == 16)
    return make_uint4(k[0] | (k[1] << 16), k[2] | (k[3] << 16), k[4] | (k[5] << 16),
                      k[6] | (k[7] << 16));
  else
    return make_uint4(k[0], k[1], k[2], k[3]);
}

template <int BITS, int N>
__device__ __forceinline__ void unpack(const uint4& q, uint32_t (&k)[N]) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if constexpr (BITS == 16)
      k[e] = (w[e >> 1] >> (16 * (e & 1))) & 0xffffu;
    else
      k[e] = w[e];
  }
}

// The key of element e of chunk c from shared memory.
template <int BITS>
__device__ __forceinline__ uint32_t chunk_key(const uint4* kq, int c, int e) {
  if constexpr (BITS == 16)
    return reinterpret_cast<const unsigned short*>(kq)[c * 8 + e];
  else
    return reinterpret_cast<const uint32_t*>(kq)[c * 4 + e];
}

// Where a row's elements lie: `head` elements before its first 16-byte
// boundary, `nvec` whole chunks, the tail from column tail0; rw chunks a
// thread.
struct RowLayout {
  int head, nvec, rw, tail0;
};

struct RadixShared {
  alignas(16) unsigned hist[HIST_WORDS];
  alignas(16) unsigned warp_sum[RS_WARPS];
  uint32_t cand_key[CAP];  // the keys at or above the first bin, in column order
  int cand_col[CAP];
  uint32_t head_key[8], tail_key[8];
  float red_m[RS_WARPS], red_s[RS_WARPS];
  unsigned digit, above, inbin, total;
};

// a[0] + ... + a[n - 1] of the warps' sums, n < RS_WARPS (two 16-byte reads)
__device__ __forceinline__ unsigned sum_below(const unsigned* a, int n) {
  const uint4 lo = *reinterpret_cast<const uint4*>(a);
  const uint4 hi = *reinterpret_cast<const uint4*>(a + 4);
  return (n > 0 ? lo.x : 0u) + (n > 1 ? lo.y : 0u) + (n > 2 ? lo.z : 0u) +
         (n > 3 ? lo.w : 0u) + (n > 4 ? hi.x : 0u) + (n > 5 ? hi.y : 0u) +
         (n > 6 ? hi.z : 0u);
}

__device__ __forceinline__ unsigned warp_inclusive_scan(unsigned x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// Inclusive prefix sum of one value per thread over the block, in thread order.
__device__ __forceinline__ unsigned block_inclusive_scan(unsigned x, RadixShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_inclusive_scan(x);
  if (lane == 31) sh.warp_sum[warp] = x;
  __syncthreads();
  return x + sum_below(sh.warp_sum, warp);
}

// The sum of bins [base, base + per) (16-byte reads where per is a multiple
// of 4; base is a multiple of per).
__device__ __forceinline__ unsigned bins_sum(const unsigned* hist, int base, int per) {
  unsigned h = 0;
  const unsigned* p = hist + base;
  if (per % 4 == 0) {
    for (int i = 0; i < per; i += 4) {
      const uint4 q = *reinterpret_cast<const uint4*>(p + i);
      h += q.x + q.y + q.z + q.w;
    }
  } else {
    for (int i = 0; i < per; ++i) h += p[i];
  }
  return h;
}

// The bin of the first pass's histogram (nb bins) that holds the
// remaining-th largest key, the bins taken from the top:
// sh.digit, with the counts of the bins above it (sh.above) and of its own
// (sh.inbin).  Thread t sums the bins [nb - (t + 1) * per, nb - t * per).
// Every thread calls it; it ends with a barrier.
__device__ __forceinline__ void block_pick(const unsigned* hist, int nb, unsigned remaining,
                                           RadixShared& sh) {
  const int per = nb / RS_THREADS;
  const int base = nb - ((int)threadIdx.x + 1) * per;
  const unsigned h = bins_sum(hist, base, per);
  const unsigned incl = block_inclusive_scan(h, sh);
  if (h > 0 && incl >= remaining && incl - h < remaining) {
    unsigned run = incl - h;
    for (int bin = base + per - 1; bin >= base; --bin) {
      const unsigned n = bins_sum(hist, bin, 1);
      if (run + n >= remaining) {
        sh.digit = bin;
        sh.above = run;
        sh.inbin = n;
        break;
      }
      run += n;
    }
  }
  __syncthreads();
}

// The same over hist[0, nb) by one warp: lane l sums a run of bins from the
// top, and the lane whose run holds the key narrows it down, until a run is
// one bin.  Returns the bin; above and inbin as block_pick's.
__device__ __forceinline__ unsigned warp_pick(const unsigned* hist, int nb, unsigned remaining,
                                              unsigned& above, unsigned& inbin) {
  const int lane = threadIdx.x & 31;
  int top = nb, span = nb;  // the bins [top - span, top) hold it
  unsigned run = 0;         // the keys in the bins from top up
  while (true) {
    const int per = span > 32 ? span / 32 : 1;
    const int base = top - (lane + 1) * per;
    const unsigned h = base >= top - span ? bins_sum(hist, base, per) : 0u;
    const unsigned incl = warp_inclusive_scan(h);
    const bool here = h > 0 && run + incl >= remaining && run + incl - h < remaining;
    const int src = __ffs(__ballot_sync(FULL, here)) - 1;
    const unsigned excl = __shfl_sync(FULL, incl - h, src);
    if (per == 1) {
      above = run + excl;
      inbin = __shfl_sync(FULL, h, src);
      return (unsigned)(top - 1 - src);
    }
    run += excl;
    top -= src * per;
    span = per;
  }
}

// Zeroes hist[0, n), n a multiple of 4, with the threads [0, threads).
__device__ __forceinline__ void zero_bins(unsigned* hist, int n, int threads) {
  for (int i = 4 * (int)threadIdx.x; i < n; i += 4 * threads)
    *reinterpret_cast<uint4*>(hist + i) = make_uint4(0u, 0u, 0u, 0u);
}

// x: N consecutive values into the lane's online log-sum-exp (m, s) and the
// first pass's histogram; their keys out.
template <int BITS, int N>
__device__ __forceinline__ void first_pass(const float (&x)[N], bool have, float& m, float& s,
                                           unsigned* hist, uint32_t (&k)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) k[e] = key_of<BITS>(x[e]);
  if (!have) return;
  float cmax = x[0];
#pragma unroll
  for (int e = 1; e < N; ++e) cmax = fmaxf(cmax, x[e]);
  const float nm = fmaxf(m, cmax);
  float part = 0.f;
#pragma unroll
  for (int e = 0; e < N; ++e) part += exp2_approx((x[e] - nm) * LOG2E);
  s = s * rescale(m, nm) + part;
  m = nm;
#pragma unroll
  for (int e = 0; e < N; ++e) atomicAdd(&hist[k[e] >> (BITS - FIRST_BITS)], 1u);
}

template <typename T>
__device__ __forceinline__ float load_cached(const T* p);
template <>
__device__ __forceinline__ float load_cached(const float* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float load_cached(const __nv_bfloat16* p) {
  const uint32_t w = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(w << 16);
}

// R > 0: rows of at most REG_V elements, their keys kept in shared memory
// (R chunks a thread at most); R == 0: any row, read again from memory by
// every later sweep.
template <typename T, int R>
__global__ void __launch_bounds__(RS_THREADS, R == 4 ? 6 : 4)
sample_rows_radix(const T* __restrict__ logits, const float* __restrict__ temp_ptr,
                  float temp_value, long long rows_per_temp,
                  const unsigned long long* __restrict__ seed_ptr, int* __restrict__ pred,
                  float* __restrict__ conf, long long rows, int V, int k) {
  __shared__ RadixShared sh;
  extern __shared__ uint4 smem_keys[];  // chunk c's keys in smem_keys[c] when R > 0
  constexpr int VEC = Elem<T>::VEC, BITS = KeyBits<T>::value;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned long long seed = *seed_ptr;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* rp = logits + row * V;
    RowLayout L;
    L.head = min((int)(((16 - (reinterpret_cast<uintptr_t>(rp) & 15)) & 15) / sizeof(T)), V);
    L.nvec = (V - L.head) / VEC;
    L.rw = (L.nvec + RS_THREADS - 1) / RS_THREADS;
    L.tail0 = L.head + L.nvec * VEC;
    const uint4* vp = reinterpret_cast<const uint4*>(rp + L.head);

    // the loads first, then the histogram is zeroed behind them.  Pass 1
    // takes chunk (warp * rw + j) * 32 + lane: a warp's load is 512
    // contiguous bytes.
    const bool has_head = warp == 0 && lane < L.head;
    const bool has_tail = warp == RS_WARPS - 1 && L.tail0 + lane < V;
    const float hx = has_head ? Elem<T>::one(rp + lane) : 0.f;
    const float tx = has_tail ? Elem<T>::one(rp + L.tail0 + lane) : 0.f;
    uint4 raw[R > 0 ? R : 1];
#pragma unroll
    for (int j = 0; j < (R > 0 ? R : 1); ++j) {
      const int c = (warp * L.rw + j) * 32 + lane;
      raw[j] = R > 0 && j < L.rw && c < L.nvec ? __ldcs(vp + c) : make_uint4(0u, 0u, 0u, 0u);
    }
    zero_bins(sh.hist, HIST_WORDS, RS_THREADS);
    __syncthreads();

    // pass 1 over the row: the first digit's histogram, the log-sum-exp, the keys
    float m = -INFINITY, s = 0.f;
    {
      const float x[1] = {hx};
      uint32_t kk[1];
      first_pass<BITS>(x, has_head, m, s, sh.hist, kk);
      if (has_head) sh.head_key[lane] = kk[0];
    }
    if (R > 0) {
#pragma unroll
      for (int j = 0; j < (R > 0 ? R : 1); ++j) {
        if (j < L.rw) {
          const int c = (warp * L.rw + j) * 32 + lane;
          float x[VEC];
          uint32_t kk[VEC];
          Elem<T>::widen(raw[j], x);
          first_pass<BITS>(x, c < L.nvec, m, s, sh.hist, kk);
          if (c < L.nvec) smem_keys[c] = pack<BITS>(kk);
        }
      }
    } else {
      for (int j = 0; j < L.rw; ++j) {
        const int c = (warp * L.rw + j) * 32 + lane;
        if (c < L.nvec) {
          float x[VEC];
          uint32_t kk[VEC];
          Elem<T>::widen(__ldg(vp + c), x);
          first_pass<BITS>(x, true, m, s, sh.hist, kk);
        }
      }
    }
    {
      const float x[1] = {tx};
      uint32_t kk[1];
      first_pass<BITS>(x, has_tail, m, s, sh.hist, kk);
      if (has_tail) sh.tail_key[lane] = kk[0];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(FULL, m, off);
      const float os = __shfl_xor_sync(FULL, s, off);
      const float nm = fmaxf(m, om);
      s = s * rescale(m, nm) + os * rescale(om, nm);
      m = nm;
    }
    if (lane == 0) {
      sh.red_m[warp] = m;
      sh.red_s[warp] = s;
    }
    __syncthreads();  // the histogram and the keys are complete
    block_pick(sh.hist, 1 << FIRST_BITS, (unsigned)k, sh);
    constexpr int SHIFT1 = BITS - FIRST_BITS;
    uint32_t prefix = sh.digit << SHIFT1;  // the kept keys' bits known so far
    uint32_t pmask = ((1u << FIRST_BITS) - 1u) << SHIFT1;
    unsigned remaining = (unsigned)k - sh.above;  // kept keys still to find in the bin
    unsigned inbin = sh.inbin;

    // The keys at or above the first bin (>= prefix) into the buffer, in
    // column order: thread t takes the chunks [t * rw, (t + 1) * rw), thread 0
    // the head before them, the last thread the tail after them; a block scan
    // of the threads' counts places them.
    const int c0 = min(tid * L.rw, L.nvec), c1 = min(c0 + L.rw, L.nvec);
    const int nh = tid == 0 ? L.head : 0;
    const int nt = tid == RS_THREADS - 1 ? V - L.tail0 : 0;
    const int nrun = nh + (c1 - c0) * VEC + nt;
    // R > 0: the i-th element of the thread's run: its column, and its key
    auto run_col = [&](int i) {
      return i < nh ? i : i < nrun - nt ? L.head + c0 * VEC + (i - nh) : L.tail0 + (i - nrun + nt);
    };
    auto run_key = [&](int i) -> uint32_t {
      if (i < nh) return sh.head_key[i];
      if (i >= nrun - nt) return sh.tail_key[i - nrun + nt];
      return chunk_key<BITS>(smem_keys, c0 + (i - nh) / VEC, (i - nh) % VEC);
    };
    // R == 0: f(key, column) over the run in column order, its chunks read
    // again from memory 16 bytes a load
    auto for_run = [&](auto&& f) {
      for (int i = 0; i < nh; ++i) f(sh.head_key[i], i);
      for (int c = c0; c < c1; ++c) {
        float x[VEC];
        Elem<T>::widen(__ldg(vp + c), x);
#pragma unroll
        for (int e = 0; e < VEC; ++e) f(key_of<BITS>(x[e]), L.head + c * VEC + e);
      }
      for (int i = 0; i < nt; ++i) f(sh.tail_key[i], L.tail0 + i);
    };
    unsigned met = 0;
    // R > 0: bit i for the run's element i: the head's, the chunks' (R * VEC
    // = 32 bits), the tail's
    unsigned hit_head = 0, hit_chunks = 0, hit_tail = 0;
    if constexpr (R > 0) {
      for (int i = 0; i < nh; ++i) hit_head |= (unsigned)(sh.head_key[i] >= prefix) << i;
      // lanes start at different chunks of their runs (rw * 16 bytes apart),
      // so that a warp's 16-byte reads fall in different banks
      const int rot = L.rw > 0 ? ((lane * L.rw) >> 3) % L.rw : 0;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        int jj = j + rot;
        if (jj >= L.rw) jj -= L.rw;
        if (j < L.rw && c0 + jj < c1) {
          uint32_t kk[VEC];
          unpack<BITS>(smem_keys[c0 + jj], kk);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            hit_chunks |= (unsigned)(kk[e] >= prefix) << (jj * VEC + e);
        }
      }
      for (int i = 0; i < nt; ++i) hit_tail |= (unsigned)(sh.tail_key[i] >= prefix) << i;
      met = __popc(hit_head) + __popc(hit_chunks) + __popc(hit_tail);
    } else {
      for_run([&](uint32_t key, int) { met += key >= prefix; });
    }
    const unsigned incl = block_inclusive_scan(met, sh);
    if (tid == RS_THREADS - 1) sh.total = incl;
    unsigned pos = incl - met;
    if constexpr (R > 0) {
      const unsigned long long hits = hit_head | (unsigned long long)hit_chunks << nh |
                                      (unsigned long long)hit_tail << (nrun - nt);
      for (unsigned long long b = hits; b; b &= b - 1, ++pos) {
        const int i = __ffsll(b) - 1;
        if (pos < CAP) {
          sh.cand_key[pos] = run_key(i);
          sh.cand_col[pos] = run_col(i);
        }
      }
    } else {
      for_run([&](uint32_t key, int col) {
        if (key >= prefix) {
          if (pos < CAP) {
            sh.cand_key[pos] = key;
            sh.cand_col[pos] = col;
          }
          ++pos;
        }
      });
    }
    __syncthreads();

    // The rest of the row is warp 0's: the later passes, the tie admission
    // and the noise, over the buffer, or over the row when it overflowed.
    if (warp == 0) {
      const unsigned total = sh.total;
      const bool overflow = total > CAP;
      // f(key, col, have) over the entries in column order, 32 a step
      auto for_each_entry = [&](auto&& f) {
        if (!overflow) {
          for (unsigned i = 0; i < total; i += 32) {
            const bool have = i + lane < total;
            f(have ? sh.cand_key[i + lane] : 0u, have ? sh.cand_col[i + lane] : 0, have);
          }
        } else {
          for (int c = 0; c < V; c += 32) {
            const int col = c + lane;
            uint32_t key = 0;
            if (col < L.head) {
              key = sh.head_key[col];
            } else if (col >= L.tail0) {
              if (col < V) key = sh.tail_key[col - L.tail0];
            } else if constexpr (R > 0) {
              key = chunk_key<BITS>(smem_keys, (col - L.head) / VEC, (col - L.head) % VEC);
            } else {
              key = key_of<BITS>(load_cached(rp + col));
            }
            f(key, col, col < V);
          }
        }
      };
      // later passes over the keys that match the prefix, until the chosen
      // bin holds exactly the keys still needed or the key is complete
      for (int shift = SHIFT1; shift > 0 && inbin != remaining;) {
        const int width = shift < LATER_BITS ? shift : LATER_BITS;
        shift -= width;
        const int nb = 1 << width;
        zero_bins(sh.hist, nb, 32);
        __syncwarp();
        for_each_entry([&](uint32_t key, int, bool have) {
          if (have && (key & pmask) == prefix)
            atomicAdd(&sh.hist[(key >> shift) & (nb - 1)], 1u);
        });
        __syncwarp();
        unsigned above;
        const unsigned digit = warp_pick(sh.hist, nb, remaining, above, inbin);
        __syncwarp();  // the histogram is read before it is zeroed again
        prefix |= digit << shift;
        pmask |= (unsigned)(nb - 1) << shift;
        remaining -= above;
      }

      // the tied class (key & pmask) == prefix: its first `remaining` in
      // column order are kept, after the keys above it; the kept draw noise
      const bool all_tied = inbin == remaining;
      const float temp = fmaxf(
          temp_ptr ? temp_ptr[(unsigned)row / (unsigned)rows_per_temp] : temp_value, 1e-10f);
      unsigned rank = 0;  // tied keys met so far
      float score = -INFINITY;
      int col = NO_COL;
      uint32_t key = 0;
      for_each_entry([&](uint32_t ek, int ec, bool have) {
        const uint32_t mk = ek & pmask;
        const bool tied = have && mk == prefix;
        const unsigned ties = __ballot_sync(FULL, tied);
        const bool keep =
            have && (mk > prefix ||
                     (tied && (all_tied || rank + __popc(ties & ((1u << lane) - 1u)) < remaining)));
        rank += __popc(ties);
        if (keep) {
          const float sc = value_of<BITS>(ek) / temp + gumbel_at(ec, row, seed);
          if (before(sc, ec, score, col)) {
            score = sc;
            col = ec;
            key = ek;
          }
        }
      });
      m = lane < RS_WARPS ? sh.red_m[lane] : -INFINITY;
      s = lane < RS_WARPS ? sh.red_s[lane] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_xor_sync(FULL, score, off);
        const int oc = __shfl_xor_sync(FULL, col, off);
        const uint32_t ok = __shfl_xor_sync(FULL, key, off);
        if (before(os, oc, score, col)) {
          score = os;
          col = oc;
          key = ok;
        }
        const float om = __shfl_xor_sync(FULL, m, off);
        const float osum = __shfl_xor_sync(FULL, s, off);
        const float nm = fmaxf(m, om);
        s = s * rescale(m, nm) + osum * rescale(om, nm);
        m = nm;
      }
      if (lane == 0) {
        pred[row] = col;
        conf[row] = expf(value_of<BITS>(key) - m - logf(s));
      }
    }
    __syncthreads();  // the next row reuses sh
  }
}

template <typename T>
int launch_radix(const void* logits, const float* temp_ptr, float temp_value,
                 long long rows_per_temp, const unsigned long long* seed, int* pred, float* conf,
                 long long rows, int V, int k, cudaStream_t stream) {
  constexpr int R = REG_V / Elem<T>::VEC / RS_THREADS;  // chunks a lane of a REG_V row
  const T* x = static_cast<const T*>(logits);
  const int blocks = (int)(rows < MAX_BLOCKS ? rows : MAX_BLOCKS);
  if (V <= REG_V) {
    const int smem = R * RS_THREADS * (int)sizeof(uint4);  // the row's keys
    const cudaError_t err = cudaFuncSetAttribute(
        sample_rows_radix<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    sample_rows_radix<T, R><<<blocks, RS_THREADS, smem, stream>>>(
        x, temp_ptr, temp_value, rows_per_temp, seed, pred, conf, rows, V, k);
  }
  else {
    sample_rows_radix<T, 0><<<blocks, RS_THREADS, 0, stream>>>(
        x, temp_ptr, temp_value, rows_per_temp, seed, pred, conf, rows, V, k);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch.  temp_ptr null: every row takes
// temp_value; else row r takes temp_ptr[r / rows_per_temp].
extern "C" int sample_fwd(const void* logits, int is_bf16, const void* temp_ptr, float temp_value,
                          long long rows_per_temp, const void* seed, void* pred, void* conf,
                          long long rows, int V, int k, void* stream) {
  if (rows <= 0 || V <= 0 || k < 1 || k > 5 || k > V || rows_per_temp < 1)
    return (int)cudaErrorInvalidValue;
  const int list = k == 1 ? 1 : 5;
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

// K3r: one block a row, radix select.  Same arguments and result as
// sample_fwd, for any 1 <= k <= V, any V and fewer than 2^31 rows.
extern "C" int sample_radix_fwd(const void* logits, int is_bf16, const void* temp_ptr,
                                float temp_value, long long rows_per_temp, const void* seed,
                                void* pred, void* conf, long long rows, int V, int k,
                                void* stream) {
  if (rows <= 0 || rows >= (1ll << 31) || V <= 0 || k < 1 || k > V || rows_per_temp < 1)
    return (int)cudaErrorInvalidValue;
  const float* tp = static_cast<const float*>(temp_ptr);
  const unsigned long long* sp = static_cast<const unsigned long long*>(seed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_radix<__nv_bfloat16>(logits, tp, temp_value, rows_per_temp, sp,
                                       static_cast<int*>(pred), static_cast<float*>(conf), rows,
                                       V, k, st);
  return launch_radix<float>(logits, tp, temp_value, rows_per_temp, sp, static_cast<int*>(pred),
                             static_cast<float*>(conf), rows, V, k, st);
}

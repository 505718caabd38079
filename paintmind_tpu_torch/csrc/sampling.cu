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
// the entries in order, so its first k are the top k).
//
// k > 16 (any k up to V) goes to a second kernel, sample_rows_radix, below:
// per-lane lists that long would not fit in registers.  It gives a row to a
// block of 256 threads and computes the same function, the same survivors and
// the same noise, bit for bit:
//
//   * one read of the row (16-byte streaming loads, scalar head and tail as
//     above) turns each value into an order-preserving 32-bit key (a larger
//     float is a larger key; -0 and +0 share one) kept in shared memory when
//     the row fits (8192 keys are 32 KB; else in the block's row of a
//     scratch buffer the wrapper allocates), and feeds an online log-sum-exp;
//   * a radix select over those keys, four passes of 8 bits, finds the k-th
//     largest key T and how many of the k lie strictly above it.  A pass is a
//     256-bin histogram of the next digit over the keys that match the
//     prefix so far (warp-aggregated shared-memory atomics: the lanes with one
//     digit add their count once) and a block suffix scan of the bins;
//   * the keys equal to T are admitted lowest column first: each warp owns a
//     contiguous run of columns, counts its equal keys by ballot, and a warp
//     admits the first k - greater of them after the runs before it;
//   * the k survivors draw Philox noise at the same counter under the same
//     seed, and a block reduction takes the argmax of value / temp + g, the
//     lower column on a tie.
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
  switch (list) {
    case 1: SAMPLE_LAUNCH(1); break;
    case 5: SAMPLE_LAUNCH(5); break;
    default: SAMPLE_LAUNCH(16); break;
  }
#undef SAMPLE_LAUNCH
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// k > 16: one block a row, radix select (see the head of this file)
// ---------------------------------------------------------------------------

constexpr int RS_THREADS = 256;  // one thread per bin of an 8-bit digit
constexpr int RS_WARPS = RS_THREADS / 32;
constexpr int BINS = 256;
constexpr size_t ROW_SMEM_MAX = 200 * 1024;  // rows up to 51200 keys stay in shared memory
                                             // (RADIX_ROW_SMEM_MAX in ops/sampling.py)

// Larger float, larger key; -0 and +0 map to one key, as they compare equal.
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t u = x == 0.f ? 0u : __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

struct RadixShared {
  unsigned hist[BINS];
  unsigned warp_sum[RS_WARPS];
  float red_m[RS_WARPS], red_s[RS_WARPS];
  float red_score[RS_WARPS];
  int red_col[RS_WARPS];
  uint32_t prefix;
  int remaining;
};

// Inclusive prefix sum of one value per thread over the block, in thread order.
__device__ __forceinline__ unsigned block_inclusive_scan(unsigned x, RadixShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) sh.warp_sum[warp] = x;
  __syncthreads();
  for (int w = 0; w < warp; ++w) x += sh.warp_sum[w];
  return x;
}

// N consecutive values from column col0 into a thread's online log-sum-exp
// (m, s), and their keys into the row's key buffer.
template <int N>
__device__ __forceinline__ void read_chunk(const float (&x)[N], int col0, float& m, float& s,
                                           uint32_t* keys) {
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
  for (int e = 0; e < N; ++e) keys[col0 + e] = order_key(x[e]);
}

// IN_SMEM: the row's keys live in dynamic shared memory; else in the
// block's row of a global scratch buffer (gridDim.x rows of V keys).
template <typename T, bool IN_SMEM>
__global__ void __launch_bounds__(RS_THREADS)
sample_rows_radix(const T* __restrict__ logits, const float* __restrict__ temp_ptr,
                  float temp_value, long long rows_per_temp,
                  const unsigned long long* __restrict__ seed_ptr, int* __restrict__ pred,
                  float* __restrict__ conf, uint32_t* __restrict__ scratch, long long rows,
                  int V, int k) {
  extern __shared__ uint32_t smem_keys[];
  __shared__ RadixShared sh;
  uint32_t* keys = IN_SMEM ? smem_keys : scratch + (size_t)blockIdx.x * V;
  constexpr int VEC = Elem<T>::VEC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned long long seed = *seed_ptr;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* rp = logits + row * V;
    // (read first: few values are live across the 64-bit division's call)
    const float temp = fmaxf(temp_ptr ? temp_ptr[row / rows_per_temp] : temp_value, 1e-10f);

    // one read of the row: the keys, and an online log-sum-exp per thread
    float m = -INFINITY, s = 0.f;
    int head = (int)(((16 - (reinterpret_cast<uintptr_t>(rp) & 15)) & 15) / sizeof(T));
    head = min(head, V);
    if (tid < head) {
      const float x[1] = {Elem<T>::one(rp + tid)};
      read_chunk(x, tid, m, s, keys);
    }
    const int nvec = (V - head) / VEC;
    const uint4* vp = reinterpret_cast<const uint4*>(rp + head);
    for (int c = tid; c < nvec; c += RS_THREADS) {
      float x[VEC];
      Elem<T>::widen(__ldcs(vp + c), x);
      read_chunk(x, head + c * VEC, m, s, keys);
    }
    const int tail = head + nvec * VEC + tid;
    if (tail < V) {
      const float x[1] = {Elem<T>::one(rp + tail)};
      read_chunk(x, tail, m, s, keys);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(FULL, m, off);
      const float os = __shfl_xor_sync(FULL, s, off);
      const float nm = fmaxf(m, om);
      s = s * rescale(m, nm) + os * rescale(om, nm);
      m = nm;
    }
    if (lane == 0) {  // merged by thread 0 at the end: nothing else is live
      sh.red_m[warp] = m;
      sh.red_s[warp] = s;
    }
    __syncthreads();  // the keys and the warps' (m, s) are stored

    // radix select: the k-th largest key, 8 bits a pass from the top
    uint32_t prefix = 0, pmask = 0;
    int remaining = k;  // rank of the k-th key among the keys matching prefix
    for (int shift = 24; shift >= 0; shift -= 8) {
      sh.hist[tid] = 0;
      __syncthreads();
      for (int base = 0; base < V; base += RS_THREADS) {
        const int i = base + tid;
        uint32_t key = 0;
        bool in = false;
        if (i < V) {
          key = keys[i];
          in = (key & pmask) == prefix;
        }
        const unsigned digit = (key >> shift) & (BINS - 1);
        const unsigned active = __ballot_sync(FULL, in);
        if (in) {
          const unsigned peers = __match_any_sync(active, digit);
          if (lane == __ffs(peers) - 1) atomicAdd(&sh.hist[digit], __popc(peers));
        }
      }
      __syncthreads();
      // thread t holds bin 255 - t: the scan counts the keys with a digit >= it
      const unsigned h = sh.hist[BINS - 1 - tid];
      const unsigned incl = block_inclusive_scan(h, sh);
      if (incl >= (unsigned)remaining && incl - h < (unsigned)remaining) {
        sh.prefix = prefix | ((uint32_t)(BINS - 1 - tid) << shift);
        sh.remaining = remaining - (int)(incl - h);
      }
      __syncthreads();
      prefix = sh.prefix;
      remaining = sh.remaining;
      pmask |= (uint32_t)(BINS - 1) << shift;
    }
    const uint32_t thr = prefix;   // the k-th largest key
    const unsigned need = remaining;  // how many keys equal to it are kept

    // warp w owns columns [lo, hi); its equal keys come after those of the
    // warps before it, so admitting the lowest columns first is a prefix count
    const int seg = ((V + RS_WARPS - 1) / RS_WARPS + 31) & ~31;
    const int lo = warp * seg, hi = min(lo + seg, V);
    unsigned equal = 0;
    for (int c = lo; c < hi; c += 32) {
      const int i = c + lane;
      const bool eq = i < hi && keys[i] == thr;
      equal += __popc(__ballot_sync(FULL, eq));
    }
    if (lane == 0) sh.warp_sum[warp] = equal;
    __syncthreads();
    unsigned rank0 = 0;
    for (int w = 0; w < warp; ++w) rank0 += sh.warp_sum[w];

    // the survivors: noise, score, and the argmax with ties to the lower column
    float score = -INFINITY;
    int col = NO_COL;
    for (int c = lo; c < hi; c += 32) {
      const int i = c + lane;
      const uint32_t key = i < hi ? keys[i] : 0u;
      const bool eq = i < hi && key == thr;
      const unsigned ballot = __ballot_sync(FULL, eq);
      const unsigned rank = rank0 + __popc(ballot & ((1u << lane) - 1u));
      rank0 += __popc(ballot);
      if ((i < hi && key > thr) || (eq && rank < need)) {
        const float sc = key_value(key) / temp + gumbel_at(i, row, seed);
        if (before(sc, i, score, col)) {
          score = sc;
          col = i;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(FULL, score, off);
      const int oc = __shfl_xor_sync(FULL, col, off);
      if (before(os, oc, score, col)) {
        score = os;
        col = oc;
      }
    }
    if (lane == 0) {
      sh.red_score[warp] = score;
      sh.red_col[warp] = col;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < RS_WARPS; ++w) {
        if (before(sh.red_score[w], sh.red_col[w], score, col)) {
          score = sh.red_score[w];
          col = sh.red_col[w];
        }
      }
      m = sh.red_m[0];
      s = sh.red_s[0];
      for (int w = 1; w < RS_WARPS; ++w) {
        const float om = sh.red_m[w], os = sh.red_s[w];
        const float nm = fmaxf(m, om);
        s = s * rescale(m, nm) + os * rescale(om, nm);
        m = nm;
      }
      pred[row] = col;
      conf[row] = expf(key_value(keys[col]) - m - logf(s));
    }
    __syncthreads();  // the next row reuses the keys and sh
  }
}

template <typename T>
int launch_radix(const void* logits, const float* temp_ptr, float temp_value,
                 long long rows_per_temp, const unsigned long long* seed, int* pred, float* conf,
                 uint32_t* scratch, long long scratch_rows, long long rows, int V, int k,
                 cudaStream_t stream) {
  const T* x = static_cast<const T*>(logits);
  if (scratch == nullptr) {
    const size_t smem = (size_t)V * sizeof(uint32_t);
    if (smem > ROW_SMEM_MAX) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          sample_rows_radix<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const int blocks = (int)(rows < MAX_BLOCKS ? rows : MAX_BLOCKS);
    sample_rows_radix<T, true><<<blocks, RS_THREADS, smem, stream>>>(
        x, temp_ptr, temp_value, rows_per_temp, seed, pred, conf, nullptr, rows, V, k);
  } else {  // a row too long for shared memory: its keys go to the scratch row
    const int blocks = (int)(rows < scratch_rows ? rows : scratch_rows);
    sample_rows_radix<T, false><<<blocks, RS_THREADS, 0, stream>>>(
        x, temp_ptr, temp_value, rows_per_temp, seed, pred, conf, scratch, rows, V, k);
  }
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

// k > 16: one block a row, radix select.  Same arguments and result as
// sample_fwd, for any 1 <= k <= V, and a key buffer: scratch null keeps each
// row's keys in shared memory (V * 4 bytes <= 200 KB); else scratch holds
// scratch_rows rows of V 32-bit keys, one per block.
extern "C" int sample_radix_fwd(const void* logits, int is_bf16, const void* temp_ptr,
                                float temp_value, long long rows_per_temp, const void* seed,
                                void* pred, void* conf, void* scratch, long long scratch_rows,
                                long long rows, int V, int k, void* stream) {
  if (rows <= 0 || V <= 0 || k < 1 || k > V || rows_per_temp < 1 ||
      (scratch != nullptr && scratch_rows < 1))
    return (int)cudaErrorInvalidValue;
  const float* tp = static_cast<const float*>(temp_ptr);
  const unsigned long long* sp = static_cast<const unsigned long long*>(seed);
  uint32_t* keys = static_cast<uint32_t*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_radix<__nv_bfloat16>(logits, tp, temp_value, rows_per_temp, sp,
                                       static_cast<int*>(pred), static_cast<float*>(conf), keys,
                                       scratch_rows, rows, V, k, st);
  return launch_radix<float>(logits, tp, temp_value, rows_per_temp, sp, static_cast<int*>(pred),
                             static_cast<float*>(conf), keys, scratch_rows, rows, V, k, st);
}

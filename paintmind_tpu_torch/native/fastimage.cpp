// Native host-side image pipeline: JPEG decode + antialiased bicubic resize
// + crop/flip + [-1,1] float32 normalize, batch-parallel with std::thread.
//
// The port's own copy of paintmind_tpu/native/fastimage.cpp (same source,
// so both packages' libraries give the same bits).  The reference delegates
// this work to PIL/torchvision on the Python side
// (reference paintmind/utils/transform.py, utils/datasets.py); here the
// decode→preprocess hot loop runs in C++ so the host keeps the card fed.
// The resize implements PIL-compatible separable cubic resampling
// (Catmull-Rom a=-0.5 with support scaling on downscale, i.e. antialiased),
// so outputs match the host/PIL transform within float tolerance.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdio>  // jpeglib.h needs FILE declared first

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <functional>
#include <map>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG buffer to packed RGB8. Returns true on success.
bool DecodeJpeg(const uint8_t* data, size_t len, std::vector<uint8_t>* out,
                int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *h = cinfo.output_height;
  *w = cinfo.output_width;
  out->resize(size_t(*h) * *w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + size_t(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

inline double CubicKernel(double x) {  // Catmull-Rom, a = -0.5 (PIL BICUBIC)
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// PIL-style separable resample along one axis with support scaling.
struct Taps {
  std::vector<int> start;      // first source index per output pixel
  std::vector<int> count;      // number of taps
  std::vector<double> weight;  // taps, row-major [out][count]
  int max_count = 0;
};

Taps BuildTaps(int in_size, int out_size) {
  Taps t;
  double scale = double(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);  // antialias on downscale
  double support = 2.0 * filterscale;
  t.max_count = int(std::ceil(support)) * 2 + 1;
  t.start.resize(out_size);
  t.count.resize(out_size);
  t.weight.assign(size_t(out_size) * t.max_count, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = std::max(0, int(center - support + 0.5));
    int xmax = std::min(in_size, int(center + support + 0.5));
    double sum = 0.0;
    int n = xmax - xmin;
    for (int i = 0; i < n; ++i) {
      double wgt = CubicKernel((xmin + i - center + 0.5) / filterscale);
      t.weight[size_t(xx) * t.max_count + i] = wgt;
      sum += wgt;
    }
    if (sum != 0.0) {
      for (int i = 0; i < n; ++i) t.weight[size_t(xx) * t.max_count + i] /= sum;
    }
    t.start[xx] = xmin;
    t.count[xx] = n;
  }
  return t;
}

// Resize RGB float image (h, w, 3) -> (oh, ow, 3), separable.
void ResizeBicubic(const float* src, int h, int w, float* dst, int oh,
                   int ow) {
  Taps tx = BuildTaps(w, ow);
  Taps ty = BuildTaps(h, oh);
  std::vector<float> tmp(size_t(h) * ow * 3);  // horizontal pass first
  for (int y = 0; y < h; ++y) {
    const float* srow = src + size_t(y) * w * 3;
    float* trow = tmp.data() + size_t(y) * ow * 3;
    for (int x = 0; x < ow; ++x) {
      const double* wt = &tx.weight[size_t(x) * tx.max_count];
      int s0 = tx.start[x], n = tx.count[x];
      double acc0 = 0, acc1 = 0, acc2 = 0;
      for (int i = 0; i < n; ++i) {
        const float* p = srow + size_t(s0 + i) * 3;
        acc0 += wt[i] * p[0];
        acc1 += wt[i] * p[1];
        acc2 += wt[i] * p[2];
      }
      trow[x * 3 + 0] = float(acc0);
      trow[x * 3 + 1] = float(acc1);
      trow[x * 3 + 2] = float(acc2);
    }
  }
  for (int y = 0; y < oh; ++y) {
    const double* wt = &ty.weight[size_t(y) * ty.max_count];
    int s0 = ty.start[y], n = ty.count[y];
    float* drow = dst + size_t(y) * ow * 3;
    for (int x = 0; x < ow * 3; ++x) {
      double acc = 0;
      for (int i = 0; i < n; ++i)
        acc += wt[i] * tmp[size_t(s0 + i) * ow * 3 + x];
      drow[x] = float(acc);
    }
  }
}

// Full single-image pipeline: RGB8 (h, w) -> resize (rs, rs) -> crop
// (top, left, cs) -> optional hflip -> float32 [-1, 1] HWC into out.
void PreprocessOne(const uint8_t* rgb, int h, int w, int rs, int cs, int top,
                   int left, int flip, float* out) {
  std::vector<float> asfloat(size_t(h) * w * 3);
  for (size_t i = 0; i < asfloat.size(); ++i)
    asfloat[i] = rgb[i] * (1.0f / 255.0f);
  std::vector<float> resized(size_t(rs) * rs * 3);
  ResizeBicubic(asfloat.data(), h, w, resized.data(), rs, rs);
  for (int y = 0; y < cs; ++y) {
    for (int x = 0; x < cs; ++x) {
      int sx = flip ? (left + cs - 1 - x) : (left + x);
      const float* p = &resized[(size_t(top + y) * rs + sx) * 3];
      float* q = out + (size_t(y) * cs + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = std::min(std::max(p[c], 0.0f), 1.0f);
        q[c] = v * 2.0f - 1.0f;
      }
    }
  }
}

// Read a whole file into a byte vector. Returns false on IO error.
bool ReadFileBytes(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  if (sz < 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  out->resize(size_t(sz));
  size_t got = sz ? std::fread(out->data(), 1, size_t(sz), f) : 0;
  std::fclose(f);
  return got == size_t(sz);
}

void ParallelFor(int n, int num_threads, const std::function<void(int)>& fn) {
  num_threads = std::max(1, std::min(num_threads, n));
  if (num_threads == 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> threads;
  std::atomic<int> next{0};
  for (int t = 0; t < num_threads; ++t) {
    threads.emplace_back([&] {
      int i;
      while ((i = next.fetch_add(1)) < n) fn(i);
    });
  }
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Pipelined loader: disk read -> JPEG decode -> preprocess in a worker pool,
// with a bounded in-order prefetch queue.  This is the native counterpart of
// torch DataLoader workers (the reference's host loading tier,
// paintmind/utils/datasets.py + torch DataLoader inside accelerate.prepare):
// the consumer thread (Python) only ever memcpy's finished float batches.
// ---------------------------------------------------------------------------

struct Loader {
  std::vector<std::string> paths;
  int batch_size, rs, cs, is_train, hflip, drop_last;
  uint64_t seed;
  int num_threads, prefetch;

  // epoch state
  int epoch = -1;
  std::vector<int> order;                 // shuffled item indices
  int n_batches = 0;
  std::atomic<int> next_ticket{0};        // next batch a worker grabs
  std::atomic<int> failures{0};
  std::atomic<bool> stop{false};

  std::mutex mu;
  std::condition_variable cv_ready;       // consumer waits for its batch
  std::condition_variable cv_space;       // workers wait for queue space
  std::map<int, std::vector<float>> ready;  // batch index -> pixels
  std::map<int, int> ready_count;           // batch index -> item count
  std::map<int, std::vector<int>> ready_idx;  // batch index -> item indices
  int next_deliver = 0;

  std::vector<std::thread> workers;

  int items_in_batch(int b) const {
    int n = int(order.size());
    int lo = b * batch_size;
    return std::min(batch_size, n - lo);
  }

  void join_workers() {
    stop.store(true);
    cv_space.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    workers.clear();
    stop.store(false);
  }

  void worker_main() {
    std::vector<uint8_t> filebuf, rgb;
    for (;;) {
      int b = next_ticket.fetch_add(1);
      if (b >= n_batches || stop.load()) return;
      {
        // bounded prefetch: stay within `prefetch` batches of the consumer
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop.load() || b < next_deliver + prefetch;
        });
        if (stop.load()) return;
      }
      int count = items_in_batch(b);
      std::vector<float> pixels(size_t(count) * cs * cs * 3);
      std::vector<int> indices(count);
      for (int j = 0; j < count; ++j) {
        int item = order[size_t(b) * batch_size + j];
        indices[j] = item;
        float* dst = pixels.data() + size_t(j) * cs * cs * 3;
        int h = 0, w = 0;
        // per-item RNG keyed by (seed, epoch, item): crop/flip params are
        // reproducible regardless of thread scheduling
        std::mt19937_64 rng(seed ^ (uint64_t(epoch) << 32) ^
                            (uint64_t(item) * 0x9e3779b97f4a7c15ull));
        int max_off = rs - cs;
        int top = max_off / 2, left = max_off / 2, flip = 0;
        if (is_train) {
          top = int(rng() % uint64_t(max_off + 1));
          left = int(rng() % uint64_t(max_off + 1));
          flip = hflip && (rng() % 2);
        }
        if (!ReadFileBytes(paths[item].c_str(), &filebuf) ||
            !DecodeJpeg(filebuf.data(), filebuf.size(), &rgb, &h, &w)) {
          std::memset(dst, 0, size_t(cs) * cs * 3 * sizeof(float));
          failures.fetch_add(1);
          continue;
        }
        PreprocessOne(rgb.data(), h, w, rs, cs, top, left, flip, dst);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.emplace(b, std::move(pixels));
        ready_count.emplace(b, count);
        ready_idx.emplace(b, std::move(indices));
      }
      cv_ready.notify_all();
    }
  }

  void start_epoch(int e) {
    join_workers();
    {
      std::lock_guard<std::mutex> lk(mu);
      ready.clear();
      ready_count.clear();
      ready_idx.clear();
      next_deliver = 0;
    }
    epoch = e;
    next_ticket.store(0);
    failures.store(0);
    int n = int(paths.size());
    order.resize(n);
    for (int i = 0; i < n; ++i) order[i] = i;
    if (is_train) {  // eval order is deterministic file order
      std::mt19937_64 rng(seed ^ 0xda7a10ad ^ (uint64_t(e) * 0x2545f4914f6cdd1dull));
      for (int i = n - 1; i > 0; --i)
        std::swap(order[i], order[size_t(rng() % uint64_t(i + 1))]);
    }
    n_batches = drop_last ? n / batch_size : (n + batch_size - 1) / batch_size;
    int threads = std::max(1, std::min(num_threads, n_batches));
    for (int t = 0; t < threads; ++t)
      workers.emplace_back([this] { worker_main(); });
  }

  // Blocks until batch `next_deliver` is ready; returns item count (0 when
  // the epoch is exhausted).
  int next(float* out, int* idx_out) {
    std::unique_lock<std::mutex> lk(mu);
    if (next_deliver >= n_batches) return 0;
    int b = next_deliver;
    cv_ready.wait(lk, [&] { return ready.count(b) > 0; });
    int count = ready_count[b];
    std::memcpy(out, ready[b].data(),
                size_t(count) * cs * cs * 3 * sizeof(float));
    if (idx_out)
      std::memcpy(idx_out, ready_idx[b].data(), size_t(count) * sizeof(int));
    ready.erase(b);
    ready_count.erase(b);
    ready_idx.erase(b);
    ++next_deliver;
    lk.unlock();
    cv_space.notify_all();
    return count;
  }

  ~Loader() { join_workers(); }
};

}  // namespace

extern "C" {

// Pipelined folder loader. `paths` are NUL-terminated JPEG file paths
// (copied at create time).  See struct Loader above.
void* pm_loader_create(const char* const* paths, int n_paths, int batch_size,
                       int rs, int cs, int is_train, int hflip, uint64_t seed,
                       int num_threads, int prefetch_batches, int drop_last) {
  if (n_paths <= 0 || batch_size <= 0 || rs < cs) return nullptr;
  Loader* l = new Loader();
  l->paths.assign(paths, paths + n_paths);
  l->batch_size = batch_size;
  l->rs = rs;
  l->cs = cs;
  l->is_train = is_train;
  l->hflip = hflip;
  l->drop_last = drop_last;
  l->seed = seed;
  l->num_threads = std::max(1, num_threads);
  l->prefetch = std::max(1, prefetch_batches);
  return l;
}

void pm_loader_start_epoch(void* handle, int epoch) {
  static_cast<Loader*>(handle)->start_epoch(epoch);
}

int pm_loader_num_batches(void* handle) {
  Loader* l = static_cast<Loader*>(handle);
  int n = int(l->paths.size());
  return l->drop_last ? n / l->batch_size
                      : (n + l->batch_size - 1) / l->batch_size;
}

int pm_loader_next(void* handle, float* out, int* idx_out) {
  return static_cast<Loader*>(handle)->next(out, idx_out);
}

int pm_loader_failed_count(void* handle) {
  return static_cast<Loader*>(handle)->failures.load();
}

void pm_loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

// Decode+preprocess a batch of JPEG buffers.
//   datas/lens: n JPEG byte buffers
//   rs: resize edge (img_size/scale); cs: crop size; tops/lefts: per-image
//   crop offsets; flips: per-image 0/1; out: (n, cs, cs, 3) float32.
// Returns number of failed decodes (failed slots are zero-filled).
int pm_batch_decode_preprocess(const uint8_t** datas, const size_t* lens,
                               int n, int rs, int cs, const int* tops,
                               const int* lefts, const uint8_t* flips,
                               float* out, int num_threads) {
  std::atomic<int> failures{0};
  ParallelFor(n, num_threads, [&](int i) {
    std::vector<uint8_t> rgb;
    int h = 0, w = 0;
    float* dst = out + size_t(i) * cs * cs * 3;
    if (!DecodeJpeg(datas[i], lens[i], &rgb, &h, &w)) {
      std::memset(dst, 0, size_t(cs) * cs * 3 * sizeof(float));
      failures.fetch_add(1);
      return;
    }
    PreprocessOne(rgb.data(), h, w, rs, cs, tops[i], lefts[i], flips[i], dst);
  });
  return failures.load();
}

// Preprocess raw RGB8 images already in memory: imgs[i] is (hs[i], ws[i], 3).
int pm_batch_preprocess_rgb(const uint8_t** imgs, const int* hs, const int* ws,
                            int n, int rs, int cs, const int* tops,
                            const int* lefts, const uint8_t* flips, float* out,
                            int num_threads) {
  ParallelFor(n, num_threads, [&](int i) {
    PreprocessOne(imgs[i], hs[i], ws[i], rs, cs, tops[i], lefts[i], flips[i],
                  out + size_t(i) * cs * cs * 3);
  });
  return 0;
}

// Single JPEG probe: returns 0 on success and fills h/w.
int pm_jpeg_shape(const uint8_t* data, size_t len, int* h, int* w) {
  std::vector<uint8_t> rgb;  // decode to validate (cheap header-only path
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"

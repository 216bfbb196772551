// Native data-loader runtime: threaded PNG decode + bilinear resize +
// normalisation, feeding fixed-shape float batches to the device pipeline.
//
// The port's copy of the JAX package's native/vioio.cpp, unchanged in
// what it computes. The reference delegates this work to torchvision/PIL
// inside torch DataLoader worker *processes* (its scripts/train_model.py:
// 143-150, --workers 8). Here it is an in-process C++ thread pool with a
// ticketed prefetch queue, bound via ctypes (ode_vio_tpu_torch/data/
// native_loader.py) so host-side decode overlaps device compute without
// process-fork overhead or tensor IPC.
//
// PNG support: 8-bit RGB / RGBA / greyscale, non-interlaced (what KITTI
// image_2 and the synthetic fixture produce); zlib inflate + the five
// standard row filters. Output: float32 HWC in [0,1], bilinearly resized.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <deque>
#include <functional>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

// ---------------------------------------------------------------------------
// Minimal PNG decoder
// ---------------------------------------------------------------------------

struct Image {
  int w = 0, h = 0, c = 0;
  std::vector<uint8_t> pixels;  // HWC, 8-bit
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

bool inflate_all(const std::vector<uint8_t>& in, std::vector<uint8_t>& out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(in.data());
  zs.avail_in = static_cast<uInt>(in.size());
  zs.next_out = out.data();
  zs.avail_out = static_cast<uInt>(out.size());
  int ret = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return ret == Z_STREAM_END && zs.avail_out == 0;
}

bool decode_png(const uint8_t* data, size_t size, Image* img) {
  static const uint8_t kMagic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (size < 45 || std::memcmp(data, kMagic, 8) != 0) return false;

  uint32_t w = 0, h = 0;
  int bit_depth = 0, color_type = -1, interlace = 0;
  std::vector<uint8_t> idat;

  size_t pos = 8;
  while (pos + 12 <= size) {
    uint32_t len = be32(data + pos);
    const char* type = reinterpret_cast<const char*>(data + pos + 4);
    const uint8_t* payload = data + pos + 8;
    if (pos + 12 + len > size) return false;
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) return false;
      w = be32(payload);
      h = be32(payload + 4);
      bit_depth = payload[8];
      color_type = payload[9];
      interlace = payload[12];
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), payload, payload + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (w == 0 || h == 0 || bit_depth != 8 || interlace != 0) return false;
  int ch;
  switch (color_type) {
    case 0: ch = 1; break;  // grey
    case 2: ch = 3; break;  // RGB
    case 6: ch = 4; break;  // RGBA
    default: return false;  // palette / grey+alpha unsupported
  }

  const size_t stride = size_t(w) * ch;
  std::vector<uint8_t> raw((stride + 1) * h);
  if (!inflate_all(idat, raw)) return false;

  img->w = int(w);
  img->h = int(h);
  img->c = ch;
  img->pixels.resize(stride * h);

  std::vector<uint8_t> prev(stride, 0);
  for (uint32_t y = 0; y < h; ++y) {
    const uint8_t* src = raw.data() + y * (stride + 1);
    uint8_t filter = src[0];
    ++src;
    uint8_t* dst = img->pixels.data() + y * stride;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= size_t(ch) ? dst[x - ch] : 0;       // left
      int b = prev[x];                                  // up
      int c = x >= size_t(ch) ? prev[x - ch] : 0;       // up-left
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return false;
      }
      dst[x] = uint8_t(v);
    }
    std::memcpy(prev.data(), dst, stride);
  }
  return true;
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(size_t(n));
  size_t got = std::fread(out->data(), 1, size_t(n), f);
  std::fclose(f);
  return got == size_t(n);
}

// PIL-equivalent antialiased bilinear (triangle-filter) resampling: when
// downscaling, the filter support widens with the scale factor — this is
// what torchvision's TF.resize on PIL images does in the reference eval
// path (KITTI_eval.py:102), so the native loader must match it.
struct ResampleKernel {
  std::vector<int> starts;       // per output index: first input tap
  std::vector<int> sizes;        // taps per output index
  std::vector<float> weights;    // flattened, max_taps per output
  int max_taps = 0;
};

ResampleKernel build_kernel(int in_size, int out_size) {
  ResampleKernel k;
  const double scale = double(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;  // triangle filter support
  k.max_taps = int(std::ceil(support) * 2 + 1);
  k.starts.resize(out_size);
  k.sizes.resize(out_size);
  k.weights.assign(size_t(out_size) * k.max_taps, 0.0f);
  for (int i = 0; i < out_size; ++i) {
    double center = (i + 0.5) * scale;
    int xmin = int(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = int(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    double total = 0.0;
    std::vector<double> ws(xmax - xmin);
    for (int x = xmin; x < xmax; ++x) {
      double t = (x + 0.5 - center) / filterscale;
      double w = t < 0 ? 1.0 + t : 1.0 - t;  // triangle
      if (w < 0) w = 0;
      ws[x - xmin] = w;
      total += w;
    }
    k.starts[i] = xmin;
    k.sizes[i] = xmax - xmin;
    for (int j = 0; j < xmax - xmin; ++j)
      k.weights[size_t(i) * k.max_taps + j] =
          float(total > 0 ? ws[j] / total : 0.0);
  }
  return k;
}

// Separable resample + uint8->float [0,1]; always emits 3 channels
// (greyscale broadcast, alpha dropped).
void resize_to_float(const Image& img, int out_h, int out_w, float* out) {
  const int ch = img.c;
  ResampleKernel kx = build_kernel(img.w, out_w);
  ResampleKernel ky = build_kernel(img.h, out_h);

  // horizontal pass: (img.h, out_w, 3) float
  std::vector<float> tmp(size_t(img.h) * out_w * 3);
  for (int y = 0; y < img.h; ++y) {
    const uint8_t* row = img.pixels.data() + size_t(y) * img.w * ch;
    for (int ox = 0; ox < out_w; ++ox) {
      const float* w = kx.weights.data() + size_t(ox) * kx.max_taps;
      int start = kx.starts[ox], n = kx.sizes[ox];
      float acc[3] = {0, 0, 0};
      for (int j = 0; j < n; ++j) {
        const uint8_t* p = row + size_t(start + j) * ch;
        for (int c = 0; c < 3; ++c) acc[c] += w[j] * p[ch == 1 ? 0 : c];
      }
      float* dst = tmp.data() + (size_t(y) * out_w + ox) * 3;
      for (int c = 0; c < 3; ++c) dst[c] = acc[c];
    }
  }
  // vertical pass
  for (int oy = 0; oy < out_h; ++oy) {
    const float* w = ky.weights.data() + size_t(oy) * ky.max_taps;
    int start = ky.starts[oy], n = ky.sizes[oy];
    for (int ox = 0; ox < out_w; ++ox) {
      float acc[3] = {0, 0, 0};
      for (int j = 0; j < n; ++j) {
        const float* p = tmp.data() + (size_t(start + j) * out_w + ox) * 3;
        for (int c = 0; c < 3; ++c) acc[c] += w[j] * p[c];
      }
      float* dst = out + (size_t(oy) * out_w + ox) * 3;
      for (int c = 0; c < 3; ++c) dst[c] = acc[c] / 255.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// Thread pool + ticketed prefetcher
// ---------------------------------------------------------------------------

struct Job {
  std::vector<std::string> paths;
  int out_h, out_w;
  uint64_t ticket;
};

struct Result {
  std::vector<float> data;  // (n, out_h, out_w, 3)
  int ok = 0;
};

class Prefetcher {
 public:
  Prefetcher(int threads) : stop_(false) {
    for (int i = 0; i < threads; ++i)
      workers_.emplace_back([this] { worker(); });
  }

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  void submit(Job job) {
    std::lock_guard<std::mutex> lk(mu_);
    queue_.push_back(std::move(job));
    cv_.notify_one();
  }

  // Blocks until the ticket's result is ready; moves it out.
  Result get(uint64_t ticket) {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [&] { return results_.count(ticket) > 0; });
    Result r = std::move(results_[ticket]);
    results_.erase(ticket);
    return r;
  }

 private:
  void worker() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return stop_ || !queue_.empty(); });
        if (stop_ && queue_.empty()) return;
        job = std::move(queue_.front());
        queue_.pop_front();
      }
      Result res;
      const size_t frame = size_t(job.out_h) * job.out_w * 3;
      res.data.resize(frame * job.paths.size());
      res.ok = 1;
      for (size_t i = 0; i < job.paths.size(); ++i) {
        std::vector<uint8_t> bytes;
        Image img;
        if (!read_file(job.paths[i].c_str(), &bytes) ||
            !decode_png(bytes.data(), bytes.size(), &img)) {
          res.ok = 0;
          break;
        }
        resize_to_float(img, job.out_h, job.out_w, res.data.data() + i * frame);
      }
      {
        std::lock_guard<std::mutex> lk(mu_);
        results_[job.ticket] = std::move(res);
      }
      done_cv_.notify_all();
    }
  }

  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  std::deque<Job> queue_;
  std::map<uint64_t, Result> results_;
  std::vector<std::thread> workers_;
  bool stop_;
};

}  // namespace

// ---------------------------------------------------------------------------
// C API (ctypes)
// ---------------------------------------------------------------------------

extern "C" {

// Synchronous: decode+resize n PNGs into out (n, out_h, out_w, 3) float32.
// Returns 0 on success.
int vio_decode_batch(const char** paths, int n, int out_h, int out_w,
                     float* out, int threads) {
  if (n <= 0) return 0;
  std::atomic<int> next(0), failed(0);
  const size_t frame = size_t(out_h) * out_w * 3;
  auto work = [&] {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      std::vector<uint8_t> bytes;
      Image img;
      if (!read_file(paths[i], &bytes) ||
          !decode_png(bytes.data(), bytes.size(), &img)) {
        failed.store(1);
        return;
      }
      resize_to_float(img, out_h, out_w, out + size_t(i) * frame);
    }
  };
  if (threads <= 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t) pool.emplace_back(work);
    for (auto& t : pool) t.join();
  }
  return failed.load();
}

void* vio_prefetcher_create(int threads) {
  return new Prefetcher(threads < 1 ? 1 : threads);
}

void vio_prefetcher_submit(void* p, const char** paths, int n, int out_h,
                           int out_w, uint64_t ticket) {
  Job job;
  job.paths.assign(paths, paths + n);
  job.out_h = out_h;
  job.out_w = out_w;
  job.ticket = ticket;
  static_cast<Prefetcher*>(p)->submit(std::move(job));
}

// Blocks until ready; copies into out. Returns 0 on success.
int vio_prefetcher_get(void* p, uint64_t ticket, float* out, int64_t count) {
  Result r = static_cast<Prefetcher*>(p)->get(ticket);
  if (!r.ok || int64_t(r.data.size()) != count) return 1;
  std::memcpy(out, r.data.data(), r.data.size() * sizeof(float));
  return 0;
}

void vio_prefetcher_destroy(void* p) { delete static_cast<Prefetcher*>(p); }

}  // extern "C"

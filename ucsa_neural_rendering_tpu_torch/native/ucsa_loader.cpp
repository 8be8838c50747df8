// Native data-loading runtime: threaded JPEG/PNG decode + resize.
//
// The reference's data path runs through torch DataLoader worker *processes*
// with cv2 decode (ref: nr4seg/lightning/*_data_module.py num_workers); this
// is the TPU-framework equivalent as a C++ component: libjpeg/libpng decode,
// area-average (images) or nearest (labels/depth) resize, and a persistent
// thread pool that fills whole batches without touching the Python GIL.
// Exposed as a C ABI consumed via ctypes (see
// ucsa_neural_rendering_tpu_torch/data/native_loader.py, which builds it
// into build/torch_native/ at first use — the analogue of the reference's
// JIT extension harness, ref: nr4seg/nerf/raymarching/backend.py:45-57).
// The port's own copy of the repository's native/ucsa_loader.cpp.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------- thread pool
class ThreadPool {
 public:
  explicit ThreadPool(int n) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop();
          }
          job();
        }
      });
    }
  }
  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }
  void submit(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(job));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_ = false;
};

ThreadPool* pool() {
  static ThreadPool p(std::max(2u, std::thread::hardware_concurrency()));
  return &p;
}

// ------------------------------------------------------------------- decode
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

// Decode a JPEG file to RGB uint8. Returns true on success.
bool decode_jpeg(const char* path, std::vector<uint8_t>* out, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize(size_t(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + size_t(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// Decode PNG to (channels x 8/16-bit). Returns bit depth via *depth.
bool decode_png(const char* path, std::vector<uint8_t>* out, int* w, int* h,
                int* channels, int* depth) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  // constructed BEFORE setjmp: a libpng error longjmps back here, and
  // jumping over a live vector's construction would skip its destructor
  // (leak + UB); constructed-before objects are destroyed normally when
  // the error branch returns
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  *w = png_get_image_width(png, info);
  *h = png_get_image_height(png, info);
  *depth = png_get_bit_depth(png, info);
  png_byte color = png_get_color_type(png, info);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && *depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);  // unpack 1/2/4-bit rows to 8-bit
  if (*depth == 16) png_set_swap(png);  // little-endian uint16
  png_read_update_info(png, info);
  *depth = png_get_bit_depth(png, info);  // post-expansion
  *channels = png_get_channels(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  out->resize(rowbytes * *h);
  rows.resize(*h);
  for (int y = 0; y < *h; ++y) rows[y] = out->data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  return true;
}

// ------------------------------------------------------------------- resize
// Area-average resize of HWC uint8 → float32 [0,1], like cv2.INTER_AREA for
// downscaling (box filter over the source footprint of each target pixel).
void resize_area_to_float(const uint8_t* src, int sw, int sh, int c,
                          float* dst, int dw, int dh) {
  const float sx = float(sw) / dw, sy = float(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    const float fy0 = y * sy, fy1 = fy0 + sy;
    const int y0 = int(fy0), y1 = std::min(int(std::ceil(fy1)), sh);
    for (int x = 0; x < dw; ++x) {
      const float fx0 = x * sx, fx1 = fx0 + sx;
      const int x0 = int(fx0), x1 = std::min(int(std::ceil(fx1)), sw);
      for (int ch = 0; ch < c; ++ch) {
        double acc = 0.0, wsum = 0.0;
        for (int yy = y0; yy < y1; ++yy) {
          const float wy = std::min(fy1, float(yy + 1)) - std::max(fy0, float(yy));
          for (int xx = x0; xx < x1; ++xx) {
            const float wx =
                std::min(fx1, float(xx + 1)) - std::max(fx0, float(xx));
            acc += double(wy) * wx * src[(size_t(yy) * sw + xx) * c + ch];
            wsum += double(wy) * wx;
          }
        }
        dst[(size_t(y) * dw + x) * c + ch] =
            float(acc / (wsum * 255.0));
      }
    }
  }
}

template <typename T>
void resize_nearest(const T* src, int sw, int sh, T* dst, int dw, int dh) {
  for (int y = 0; y < dh; ++y) {
    // cv2 INTER_NEAREST source index: floor(y * sy)
    int yy = std::min(int(y * (float(sh) / dh)), sh - 1);
    for (int x = 0; x < dw; ++x) {
      int xx = std::min(int(x * (float(sw) / dw)), sw - 1);
      dst[size_t(y) * dw + x] = src[size_t(yy) * sw + xx];
    }
  }
}

}  // namespace

extern "C" {

// Decode one JPEG (or 8-bit RGB PNG) and area-resize to [dh, dw, 3] float32
// in [0,1]. Returns 0 on success.
int ucsa_load_rgb(const char* path, int dw, int dh, float* out) {
  std::vector<uint8_t> buf;
  int w, h;
  size_t len = strlen(path);
  bool ok = false;
  if (len > 4 && (strcmp(path + len - 4, ".png") == 0)) {
    int c, depth;
    ok = decode_png(path, &buf, &w, &h, &c, &depth);
    if (ok && (depth != 8 || c < 3)) ok = false;
    if (ok && c == 4) {  // drop alpha
      std::vector<uint8_t> rgb(size_t(w) * h * 3);
      for (size_t i = 0; i < size_t(w) * h; ++i)
        memcpy(&rgb[i * 3], &buf[i * 4], 3);
      buf.swap(rgb);
    }
  } else {
    ok = decode_jpeg(path, &buf, &w, &h);
  }
  if (!ok) return 1;
  resize_area_to_float(buf.data(), w, h, 3, out, dw, dh);
  return 0;
}

// Decode an 8- or 16-bit single-channel PNG and nearest-resize to
// [dh, dw] int32 (label or raw id map). Returns 0 on success.
int ucsa_load_label(const char* path, int dw, int dh, int32_t* out) {
  std::vector<uint8_t> buf;
  int w, h, c, depth;
  if (!decode_png(path, &buf, &w, &h, &c, &depth) || c != 1) return 1;
  std::vector<int32_t> full(size_t(w) * h);
  if (depth == 16) {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(buf.data());
    for (size_t i = 0; i < full.size(); ++i) full[i] = p[i];
  } else {
    for (size_t i = 0; i < full.size(); ++i) full[i] = buf[i];
  }
  resize_nearest(full.data(), w, h, out, dw, dh);
  return 0;
}

// Decode a 16-bit depth PNG (millimeters) and nearest-resize to [dh, dw]
// float32 meters. Returns 0 on success.
int ucsa_load_depth(const char* path, int dw, int dh, float* out) {
  std::vector<uint8_t> buf;
  int w, h, c, depth;
  if (!decode_png(path, &buf, &w, &h, &c, &depth) || c != 1 || depth != 16)
    return 1;
  const uint16_t* p = reinterpret_cast<const uint16_t*>(buf.data());
  std::vector<float> full(size_t(w) * h);
  for (size_t i = 0; i < full.size(); ++i) full[i] = p[i] / 1000.0f;
  resize_nearest(full.data(), w, h, out, dw, dh);
  return 0;
}

// Batch RGB loading across the thread pool: paths are `n` C strings; out is
// [n, dh, dw, 3] float32. status[i] = 0 on success. Blocks until done.
void ucsa_load_rgb_batch(const char** paths, int n, int dw, int dh,
                         float* out, int32_t* status) {
  std::mutex mu;
  std::condition_variable cv;
  int done = 0;
  for (int i = 0; i < n; ++i) {
    pool()->submit([=, &done, &mu, &cv] {
      int32_t s = ucsa_load_rgb(paths[i], dw, dh,
                                out + size_t(i) * dw * dh * 3);
      // increment AND notify under the lock: an unlocked count bump lets a
      // spuriously-woken waiter observe done==n and return — destroying
      // the stack-local mu/cv while this worker is about to touch them
      std::lock_guard<std::mutex> lk(mu);
      status[i] = s;
      ++done;
      cv.notify_all();
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done == n; });
}

}  // extern "C"

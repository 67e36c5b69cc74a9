// Native host-side JPEG decode + resize worker pool.
//
// The port's own copy of moma_tpu/data/native/decoder.cpp (same C ABI and
// arithmetic), so the two packages write the same pack bytes.
//
// Role: the decode half of the input pipeline — the part NVIDIA DALI's
// native pipeline played for the reference (dataset/imagenet_dali.py:31-76
// decoders.image) and PIL played for the histo loaders
// (dataset/dataset.py:12-16 pil_loader).  Owns file IO, libjpeg decode and
// the resize to the working resolution, multi-threaded across a batch, so
// pack-cache builds and streaming-decode paths never bottleneck on the
// Python interpreter.
//
// Resize semantics match PIL Image.resize(BILINEAR) (the reference
// transform stacks, dataset/histo_dataset.py:207-239): a separable
// triangle-filter resample whose support scales with the downscale factor
// — NOT naive 4-tap bilinear, which aliases badly on 4x+ downscales.
// Coefficients are computed in double precision; output may differ from
// Pillow's fixed-point path by ±1 LSB (tests allow ≤2).
//
// C ABI (ctypes-friendly):
//   dec_decode_file(path, out_size, fast, out)        -> 0 ok / <0 error
//   dec_decode_mem(buf, nbytes, out_size, fast, out)  -> 0 ok / <0 error
//   dec_decode_files(paths[], n, out_size, fast, out, fail[], n_threads)
//       -> number of failures (fail[i]=1 rows are zeroed; caller falls
//          back to PIL for those, e.g. PNG inputs)
//
// fast=1 enables libjpeg DCT scaling (decode at 1/2, 1/4, 1/8 when the
// target is much smaller) — DALI-style speedup, slight value deviation;
// fast=0 is full decode (bit-exact libjpeg output, PIL-parity path).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <setjmp.h>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
  auto* e = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(e->jb, 1);
}

void err_silent(j_common_ptr, int) {}
void err_silent_msg(j_common_ptr) {}

// ---------------------------------------------------------------- resize

// One separable pass: for each output coordinate, triangle-filter weighted
// sum of input coords (PIL ImagingResampleHorizontal semantics).
struct Taps {
  std::vector<int> lo;        // first input index per output
  std::vector<int> count;     // number of taps per output
  std::vector<double> w;      // flattened weights, stride = max_count
  int max_count = 0;
};

Taps make_taps(int in_size, int out_size) {
  Taps t;
  double scale = (double)in_size / out_size;
  double support = 1.0 * std::max(1.0, scale);  // BILINEAR filter support=1
  t.max_count = (int)std::ceil(support * 2) + 1;
  t.lo.resize(out_size);
  t.count.resize(out_size);
  t.w.assign((size_t)out_size * t.max_count, 0.0);
  for (int xo = 0; xo < out_size; ++xo) {
    double center = (xo + 0.5) * scale;
    int lo = (int)std::floor(center - support);
    int hi = (int)std::ceil(center + support);
    lo = std::max(lo, 0);
    hi = std::min(hi, in_size);
    double ss = 1.0 / std::max(1.0, scale);
    double sum = 0.0;
    int cnt = 0;
    for (int xi = lo; xi < hi; ++xi) {
      double d = (xi + 0.5 - center) * ss;
      double tw = d < 0 ? 1.0 + d : 1.0 - d;  // triangle
      if (tw <= 0.0) {
        if (cnt == 0) { continue; }
        // trailing zero-weight taps are dropped by not growing cnt
        tw = 0.0;
      }
      if (cnt == 0) t.lo[xo] = xi;
      t.w[(size_t)xo * t.max_count + cnt] = tw;
      sum += tw;
      ++cnt;
    }
    // strip trailing zeros
    while (cnt > 0 && t.w[(size_t)xo * t.max_count + cnt - 1] == 0.0) --cnt;
    t.count[xo] = cnt;
    if (sum > 0)
      for (int k = 0; k < cnt; ++k) t.w[(size_t)xo * t.max_count + k] /= sum;
  }
  return t;
}

inline uint8_t clamp8(double v) {
  return (uint8_t)(v < 0.5 ? 0 : v >= 254.5 ? 255 : (int)(v + 0.5));
}

// in: (h, w, 3) uint8 -> out: (size, size, 3) uint8, horizontal then
// vertical pass (PIL order), float accumulation.
void resize_bilinear(const uint8_t* in, int h, int w, int size, uint8_t* out) {
  if (h == size && w == size) {
    std::memcpy(out, in, (size_t)h * w * 3);
    return;
  }
  Taps tx = make_taps(w, size);
  // horizontal: (h, w, 3) -> (h, size, 3) in float
  std::vector<float> mid((size_t)h * size * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = in + (size_t)y * w * 3;
    float* mrow = mid.data() + (size_t)y * size * 3;
    for (int xo = 0; xo < size; ++xo) {
      const double* ww = tx.w.data() + (size_t)xo * tx.max_count;
      int lo = tx.lo[xo], cnt = tx.count[xo];
      double r = 0, g = 0, b = 0;
      for (int k = 0; k < cnt; ++k) {
        const uint8_t* p = row + (size_t)(lo + k) * 3;
        r += ww[k] * p[0];
        g += ww[k] * p[1];
        b += ww[k] * p[2];
      }
      mrow[xo * 3 + 0] = (float)r;
      mrow[xo * 3 + 1] = (float)g;
      mrow[xo * 3 + 2] = (float)b;
    }
  }
  // vertical: (h, size, 3) -> (size, size, 3)
  Taps ty = make_taps(h, size);
  for (int yo = 0; yo < size; ++yo) {
    const double* ww = ty.w.data() + (size_t)yo * ty.max_count;
    int lo = ty.lo[yo], cnt = ty.count[yo];
    uint8_t* orow = out + (size_t)yo * size * 3;
    for (int x = 0; x < size * 3; ++x) {
      double acc = 0;
      for (int k = 0; k < cnt; ++k)
        acc += ww[k] * mid[(size_t)(lo + k) * size * 3 + x];
      orow[x] = clamp8(acc);
    }
  }
}

// ---------------------------------------------------------------- decode

int decode_mem_impl(const uint8_t* buf, size_t nbytes, int out_size, int fast,
                    uint8_t* out) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  jerr.pub.emit_message = err_silent;
  jerr.pub.output_message = err_silent_msg;
  std::vector<uint8_t> pixels;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;  // corrupt / not a jpeg
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), (unsigned long)nbytes);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;
  if (fast) {
    // decode at the smallest DCT scale that still covers 2x the target
    // (leaves headroom for the triangle filter to anti-alias properly)
    cinfo.scale_num = 1;
    cinfo.scale_denom = 1;
    while (cinfo.scale_denom < 8 &&
           (int)cinfo.image_width / (int)(cinfo.scale_denom * 2) >=
               2 * out_size &&
           (int)cinfo.image_height / (int)(cinfo.scale_denom * 2) >=
               2 * out_size) {
      cinfo.scale_denom *= 2;
    }
  }
  jpeg_start_decompress(&cinfo);
  int w = cinfo.output_width, h = cinfo.output_height;
  int ch = cinfo.output_components;
  if (ch != 3 && ch != 1) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  pixels.resize((size_t)h * w * ch);
  while ((int)cinfo.output_scanline < h) {
    JSAMPROW row = pixels.data() + (size_t)cinfo.output_scanline * w * ch;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  if (ch == 1) {  // grayscale -> RGB (PIL convert("RGB") parity)
    std::vector<uint8_t> rgb((size_t)h * w * 3);
    for (size_t i = 0; i < (size_t)h * w; ++i)
      rgb[i * 3] = rgb[i * 3 + 1] = rgb[i * 3 + 2] = pixels[i];
    pixels.swap(rgb);
  }
  resize_bilinear(pixels.data(), h, w, out_size, out);
  return 0;
}

int decode_file_impl(const char* path, int out_size, int fast, uint8_t* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n <= 0) {
    std::fclose(f);
    return -1;
  }
  std::vector<uint8_t> buf((size_t)n);
  size_t rd = std::fread(buf.data(), 1, (size_t)n, f);
  std::fclose(f);
  if (rd != (size_t)n) return -1;
  return decode_mem_impl(buf.data(), rd, out_size, fast, out);
}

}  // namespace

extern "C" {

int dec_decode_mem(const uint8_t* buf, int64_t nbytes, int out_size, int fast,
                   uint8_t* out) {
  return decode_mem_impl(buf, (size_t)nbytes, out_size, fast, out);
}

int dec_decode_file(const char* path, int out_size, int fast, uint8_t* out) {
  return decode_file_impl(path, out_size, fast, out);
}

// Decode n files into out[n, out_size, out_size, 3]; fail[i]=1 marks rows
// that could not be decoded (zeroed).  Returns the failure count.
int64_t dec_decode_files(const char* const* paths, int64_t n, int out_size,
                         int fast, uint8_t* out, uint8_t* fail,
                         int n_threads) {
  const size_t row = (size_t)out_size * out_size * 3;
  std::atomic<int64_t> next{0}, failures{0};
  auto work = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      int rc = decode_file_impl(paths[i], out_size, fast, out + (size_t)i * row);
      fail[i] = rc != 0;
      if (rc != 0) {
        std::memset(out + (size_t)i * row, 0, row);
        failures.fetch_add(1);
      }
    }
  };
  int nt = std::max(1, std::min<int>(n_threads, (int)n));
  std::vector<std::thread> ts;
  for (int t = 0; t < nt - 1; ++t) ts.emplace_back(work);
  work();
  for (auto& t : ts) t.join();
  return failures.load();
}

}  // extern "C"

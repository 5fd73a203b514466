// Native host-side image preprocessing for the MIMIC-IT and tar-shard
// pipelines (a copy of otter_tpu/native/preproc.cpp).
//
// The input pipeline (base64 -> JPEG/PNG decode -> bicubic resize ->
// CLIP-mean normalize) can starve the GPU when done in Python one image at
// a time. This library provides the hot path in C++:
//   - urlsafe base64 decode
//   - JPEG (libjpeg) and PNG (libpng) decode
//   - separable antialiased bicubic resize (PIL-compatible: cubic a=-0.5,
//     support scaled by the downsampling factor)
//   - normalize to CHW float32
//   - OpenMP-parallel batch API
//
// Exposed via a C ABI consumed through ctypes
// (otter_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ── base64 (urlsafe + standard) ─────────────────────────────────────

struct B64Table {
  int8_t v[256];
  B64Table() {
    for (int i = 0; i < 256; i++) v[i] = -1;
    for (int i = 'A'; i <= 'Z'; i++) v[i] = static_cast<int8_t>(i - 'A');
    for (int i = 'a'; i <= 'z'; i++) v[i] = static_cast<int8_t>(i - 'a' + 26);
    for (int i = '0'; i <= '9'; i++) v[i] = static_cast<int8_t>(i - '0' + 52);
    v[static_cast<int>('+')] = v[static_cast<int>('-')] = 62;
    v[static_cast<int>('/')] = v[static_cast<int>('_')] = 63;
  }
};
const B64Table kB64;

std::vector<uint8_t> base64_decode(const uint8_t* data, size_t len) {
  std::vector<uint8_t> out(len / 4 * 3 + 3);
  uint8_t* o = out.data();
  size_t i = 0;
  // fast path: whole 4-char groups of valid symbols -> 3 bytes, branch-free
  while (i + 4 <= len) {
    int a = kB64.v[data[i]], b = kB64.v[data[i + 1]];
    int c = kB64.v[data[i + 2]], d = kB64.v[data[i + 3]];
    if ((a | b | c | d) < 0) break;  // padding/whitespace: slow tail below
    uint32_t v = static_cast<uint32_t>(a) << 18 |
                 static_cast<uint32_t>(b) << 12 |
                 static_cast<uint32_t>(c) << 6 | static_cast<uint32_t>(d);
    o[0] = static_cast<uint8_t>(v >> 16);
    o[1] = static_cast<uint8_t>(v >> 8);
    o[2] = static_cast<uint8_t>(v);
    o += 3;
    i += 4;
  }
  int buf = 0, bits = 0;
  for (; i < len; i++) {
    int v = kB64.v[data[i]];
    if (v < 0) continue;  // skip padding/whitespace
    buf = (buf << 6) | v;
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      *o++ = static_cast<uint8_t>((buf >> bits) & 0xFF);
    }
  }
  out.resize(o - out.data());
  return out;
}

// ── JPEG decode ─────────────────────────────────────────────────────

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// target_size > 0 enables scaled-DCT decode: libjpeg IDCTs straight to
// the smallest M/8 scale whose short side still covers target_size
// (480x640 -> 224 decodes at 1/2 scale: 4x fewer IDCT outputs and 4x
// fewer pixels through the resize; PIL's Image.draft does the same).
// The entropy (Huffman) decode is unavoidable either way.
bool decode_jpeg(const uint8_t* data, size_t len, std::vector<uint8_t>& rgb,
                 int& w, int& h, int target_size) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  if (target_size > 0) {
    int short_side = std::min<int>(cinfo.image_width, cinfo.image_height);
    int num = 8;
    while (num > 1 && (short_side * (num - 1)) / 8 >= target_size) num--;
    cinfo.scale_num = num;
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  rgb.resize(static_cast<size_t>(w) * h * 3);
  std::vector<uint8_t*> rows(cinfo.rec_outbuf_height);
  while (cinfo.output_scanline < cinfo.output_height) {
    JDIMENSION y = cinfo.output_scanline;
    int avail = std::min<int>(cinfo.rec_outbuf_height, h - y);
    for (int i = 0; i < avail; i++)
      rows[i] = rgb.data() + (static_cast<size_t>(y) + i) * w * 3;
    jpeg_read_scanlines(&cinfo, rows.data(), avail);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ── PNG decode ──────────────────────────────────────────────────────

struct PngReadState {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* st = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (st->pos + n > st->len) {
    png_error(png, "EOF");
    return;
  }
  memcpy(out, st->data + st->pos, n);
  st->pos += n;
}

bool decode_png(const uint8_t* data, size_t len, std::vector<uint8_t>& rgb,
                int& w, int& h) {
  if (len < 8 || png_sig_cmp(data, 0, 8)) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState st{data, len, 0};
  png_set_read_fn(png, &st, png_read_fn);
  png_read_info(png, info);
  w = png_get_image_width(png, info);
  h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  rgb.resize(static_cast<size_t>(w) * h * 3);
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; y++)
    rows[y] = rgb.data() + static_cast<size_t>(y) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// ── PIL-compatible separable bicubic resize ─────────────────────────

double cubic_filter(double x) {
  // Keys cubic, a = -0.5 (PIL BICUBIC)
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct FilterTable {
  std::vector<double> weights;  // [out, ksize]
  std::vector<int> starts;      // [out]
  int ksize;
};

FilterTable build_filter(int in_size, int out_size) {
  constexpr double support = 2.0;
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);  // antialias on downscale
  double sup = support * filterscale;
  int ksize = static_cast<int>(std::ceil(sup)) * 2 + 1;
  FilterTable t;
  t.ksize = ksize;
  t.weights.assign(static_cast<size_t>(out_size) * ksize, 0.0);
  t.starts.assign(out_size, 0);
  for (int xx = 0; xx < out_size; xx++) {
    double center = (xx + 0.5) * scale;
    int xmin = std::max(static_cast<int>(center - sup + 0.5), 0);
    int xmax = std::min(static_cast<int>(center + sup + 0.5), in_size);
    t.starts[xx] = xmin;
    double* w = &t.weights[static_cast<size_t>(xx) * ksize];
    double total = 0.0;
    for (int x = xmin; x < xmax; x++) {
      double val = cubic_filter((x + 0.5 - center) / filterscale);
      w[x - xmin] = val;
      total += val;
    }
    if (total != 0.0)
      for (int x = 0; x < xmax - xmin; x++) w[x] /= total;
  }
  return t;
}

// resize RGB u8 [h, w, 3] straight to normalized CHW f32 [3, S, S]: the
// vertical accumulation writes each channel plane directly (clamp +
// (v - mean)/std fused), skipping the separate HWC buffer + normalize
// pass otter_preprocess_one used to pay (one full extra read+write of
// 3*S*S floats per image)
void resize_bicubic_chw_norm(const uint8_t* src, int w, int h, float* out,
                             int size, const float* mean,
                             const float* std_) {
  FilterTable fx = build_filter(w, size);
  FilterTable fy = build_filter(h, size);
  std::vector<float> tmp(static_cast<size_t>(h) * size * 3);
  for (int y = 0; y < h; y++) {
    const uint8_t* row = src + static_cast<size_t>(y) * w * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * size * 3;
    for (int xx = 0; xx < size; xx++) {
      const double* wts = &fx.weights[static_cast<size_t>(xx) * fx.ksize];
      int x0 = fx.starts[xx];
      int kmax = std::min(fx.ksize, w - x0);
      float acc[3] = {0, 0, 0};
      for (int k = 0; k < kmax; k++) {
        float wv = static_cast<float>(wts[k]);
        const uint8_t* px = row + static_cast<size_t>(x0 + k) * 3;
        acc[0] += wv * px[0];
        acc[1] += wv * px[1];
        acc[2] += wv * px[2];
      }
      trow[xx * 3 + 0] = acc[0];
      trow[xx * 3 + 1] = acc[1];
      trow[xx * 3 + 2] = acc[2];
    }
  }
  float m[3], inv_s[3];
  for (int c = 0; c < 3; c++) {
    m[c] = mean[c] * 255.0f;
    inv_s[c] = 1.0f / (std_[c] * 255.0f);
  }
  std::vector<float> rowacc(static_cast<size_t>(size) * 3);
  const size_t plane = static_cast<size_t>(size) * size;
  for (int yy = 0; yy < size; yy++) {
    const double* wts = &fy.weights[static_cast<size_t>(yy) * fy.ksize];
    int y0 = fy.starts[yy];
    int kmax = std::min(fy.ksize, h - y0);
    for (int k = 0; k < kmax; k++) {
      float wv = static_cast<float>(wts[k]);
      const float* trow = &tmp[static_cast<size_t>(y0 + k) * size * 3];
      if (k == 0) {
        for (int xx = 0; xx < size * 3; xx++) rowacc[xx] = wv * trow[xx];
      } else {
        for (int xx = 0; xx < size * 3; xx++) rowacc[xx] += wv * trow[xx];
      }
    }
    for (int c = 0; c < 3; c++) {
      float* orow = out + plane * c + static_cast<size_t>(yy) * size;
      for (int xx = 0; xx < size; xx++) {
        float v = rowacc[static_cast<size_t>(xx) * 3 + c];
        v = std::min(std::max(v, 0.0f), 255.0f);
        orow[xx] = (v - m[c]) * inv_s[c];
      }
    }
  }
}

bool decode_any(const uint8_t* data, size_t len, std::vector<uint8_t>& rgb,
                int& w, int& h, int target_size) {
  if (len >= 2 && data[0] == 0xFF && data[1] == 0xD8)
    return decode_jpeg(data, len, rgb, w, h, target_size);
  if (len >= 8 && !png_sig_cmp(data, 0, 8))
    return decode_png(data, len, rgb, w, h);
  // fall through: try both
  return decode_jpeg(data, len, rgb, w, h, target_size) ||
         decode_png(data, len, rgb, w, h);
}

int preprocess_one_impl(const uint8_t* data, size_t n, int is_base64,
                        int size, int scaled_decode, const float* mean,
                        const float* std_, float* out) {
  std::vector<uint8_t> raw;
  const uint8_t* ptr = data;
  if (is_base64) {
    raw = base64_decode(data, n);
    ptr = raw.data();
    n = raw.size();
  }
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  if (!decode_any(ptr, n, rgb, w, h, scaled_decode ? size : 0)) return 1;
  resize_bicubic_chw_norm(rgb.data(), w, h, out, size, mean, std_);
  return 0;
}

}  // namespace

extern "C" {

// Decode one image (raw or base64 bytes) -> normalized CHW f32 [3, S, S].
// Returns 0 on success. scaled_decode=1 lets libjpeg IDCT straight to
// the smallest M/8 scale covering `size` (2-4x fewer pixels decoded;
// bit-different from full decode the way PIL's draft mode is).
int otter_preprocess_one2(const uint8_t* data, int64_t len, int is_base64,
                          int size, int scaled_decode, const float* mean,
                          const float* std_, float* out) {
  return preprocess_one_impl(data, static_cast<size_t>(len), is_base64,
                             size, scaled_decode, mean, std_, out);
}

// Back-compat single-image entry (full decode).
int otter_preprocess_one(const uint8_t* data, int64_t len, int is_base64,
                         int size, const float* mean, const float* std_,
                         float* out) {
  return preprocess_one_impl(data, static_cast<size_t>(len), is_base64,
                             size, /*scaled_decode=*/0, mean, std_, out);
}

// Batched parallel variant. datas: concatenated buffers, offsets [n+1].
// out: [n, 3, size, size] f32. status: [n] (0 ok). Returns #failures.
int otter_preprocess_batch2(const uint8_t* datas, const int64_t* offsets,
                            int n, int is_base64, int size,
                            int scaled_decode, const float* mean,
                            const float* std_, float* out, int* status) {
  int failures = 0;
#pragma omp parallel for schedule(dynamic) reduction(+ : failures)
  for (int i = 0; i < n; i++) {
    const uint8_t* p = datas + offsets[i];
    int64_t len = offsets[i + 1] - offsets[i];
    int rc = preprocess_one_impl(
        p, static_cast<size_t>(len), is_base64, size, scaled_decode,
        mean, std_, out + static_cast<size_t>(i) * 3 * size * size);
    status[i] = rc;
    if (rc) failures++;
  }
  return failures;
}

int otter_preprocess_batch(const uint8_t* datas, const int64_t* offsets,
                           int n, int is_base64, int size,
                           const float* mean, const float* std_,
                           float* out, int* status) {
  return otter_preprocess_batch2(datas, offsets, n, is_base64, size,
                                 /*scaled_decode=*/0, mean, std_, out,
                                 status);
}

}  // extern "C"

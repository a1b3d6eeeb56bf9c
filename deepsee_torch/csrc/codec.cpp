// deepsee-tpu native host codec: fused decode -> crop -> resample -> flip ->
// normalize pipeline over libjpeg/libpng, exposed as a C ABI for ctypes.
//
// Rebuilds the host half of the reference's data path (data/base_dataset.py:
// 87-107 PIL decode + torchvision transforms; util/visualizer PNG dumps) as a
// native component.  The geometric semantics are PIL's own, re-implemented
// bit-exactly:
//   * JPEG decode goes through the same libjpeg the PIL wheel links, with
//     default (ISLOW, fancy-upsampling) settings -> identical pixels.
//   * PNG decode is lossless by construction.
//   * The resampler replicates Pillow's Resample.c fixed-point algorithm
//     (PRECISION_BITS = 32-8-2, per-pass uint8 clip) for BILINEAR/BICUBIC and
//     Geometry.c's affine-nearest for NEAREST, so resized pixels match
//     PIL.Image.resize byte-for-byte (locked by tests/test_native_codec.py).
//   * Normalization is float32 (x/255)*2-1, matching
//     data/transforms.py:apply_image_transform (compile with -ffp-contract=off
//     so no FMA changes the rounding).
// An opt-in fast path (ops.scaled_decode) uses libjpeg's DCT scaling to decode
// directly near the target size; it is NOT bit-exact and callers must treat it
// as an approximate serving-throughput mode.
//
// Every entry point returns 0 on success or a negative DSN_ERR_* code; no
// exceptions cross the ABI.  Calls are thread-safe (no globals), so Python
// thread pools parallelize them across cores while ctypes releases the GIL.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <vector>

#include <jpeglib.h>
#include <png.h>

extern "C" {

enum {
  DSN_OK = 0,
  DSN_ERR_IO = -1,           // file unreadable
  DSN_ERR_FORMAT = -2,       // not a JPEG/PNG
  DSN_ERR_DECODE = -3,       // corrupt stream
  DSN_ERR_DIMS = -4,         // computed output dims != caller expectation
  DSN_ERR_UNSUPPORTED = -5,  // color/bit-depth outside the exact-parity set
  DSN_ERR_BOUNDS = -6,       // crop exceeds image bounds (PIL would pad)
  DSN_ERR_CAP = -7,          // output buffer too small (encoder)
};

enum { DSN_NEAREST = 0, DSN_BILINEAR = 1, DSN_BICUBIC = 2 };

// Geometric ops, applied in PIL pipeline order (data/transforms.py:_apply_pil):
// center_crop -> resize -> crop -> flip.
typedef struct {
  int32_t center_crop;            // 0 = off, else square size (pre-resize)
  int32_t resize_w, resize_h;     // 0 = off
  int32_t crop_x, crop_y;         // post-resize crop origin
  int32_t crop_w, crop_h;         // 0 = off
  int32_t flip;                   // 1 = horizontal flip (last)
  int32_t resample;               // DSN_NEAREST / DSN_BILINEAR / DSN_BICUBIC
  int32_t scaled_decode;          // 1 = approximate DCT-scaled JPEG decode
} DsnOps;

int32_t dsn_abi_version(void) { return 3; }

}  // extern "C"

namespace {

// Decompression-bomb guard: the daemon feeds this code untrusted HTTP bytes,
// so a crafted 100000x100000 header must not become a 30 GB allocation (a
// bad_alloc crossing the C ABI would abort the process — remote DoS).  The
// cap is below PIL's own MAX_IMAGE_PIXELS bomb threshold (~178 MP); legit
// inputs (CelebA-HQ is 1 MP) are orders of magnitude under it, and larger
// images simply fall back to the PIL path with its own bomb policy.
constexpr int64_t kMaxPixels = int64_t{1} << 27;  // 134 M pixels

inline bool dims_ok(int64_t w, int64_t h) {
  // Per-axis caps first: w and h can each be up to 2^32-1 off the wire
  // (dsn_probe's raw IHDR read), so the product may overflow int64 — found
  // by the fuzzer (tests/data/codec_corpus/png_ihdr_int64_overflow.bin).
  return w > 0 && h > 0 && w <= kMaxPixels && h <= kMaxPixels &&
         w * h <= kMaxPixels;
}

// ---------------------------------------------------------------------------
// Pillow-exact resampler (Resample.c).
// ---------------------------------------------------------------------------

constexpr int kPrecisionBits = 32 - 8 - 2;

inline uint8_t clip8(int in) {
  if (in >= (1 << (kPrecisionBits + 8))) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

double bicubic_filter(double x) {
  constexpr double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

struct Filter {
  double (*fn)(double);
  double support;
};

// Precompute normalized fixed-point coefficients exactly as Pillow's
// precompute_coeffs + normalize_coeffs_8bpc.
int precompute_coeffs(int in_size, int out_size, const Filter& f,
                      std::vector<int>* bounds, std::vector<int32_t>* kk) {
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = f.support * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

  std::vector<double> prekk(static_cast<size_t>(out_size) * ksize);
  bounds->resize(static_cast<size_t>(out_size) * 2);
  for (int xx = 0; xx < out_size; xx++) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &prekk[static_cast<size_t>(xx) * ksize];
    int x = 0;
    for (; x < xmax; x++) {
      double w = f.fn((x + xmin - center + 0.5) * ss) * ss;
      k[x] = w;
      ww += w;
    }
    for (x = 0; x < xmax; x++) {
      if (ww != 0.0) k[x] /= ww;
    }
    for (; x < ksize; x++) k[x] = 0;
    (*bounds)[static_cast<size_t>(xx) * 2 + 0] = xmin;
    (*bounds)[static_cast<size_t>(xx) * 2 + 1] = xmax;
  }

  kk->resize(prekk.size());
  for (size_t i = 0; i < prekk.size(); i++) {
    (*kk)[i] = prekk[i] < 0
                   ? static_cast<int>(-0.5 + prekk[i] * (1 << kPrecisionBits))
                   : static_cast<int>(0.5 + prekk[i] * (1 << kPrecisionBits));
  }
  return ksize;
}

// Horizontal pass over a C-channel interleaved uint8 image.  One tap loop
// accumulates every channel (contiguous loads, like Pillow's ss0..ss3 form);
// the arithmetic is identical, only the loop order differs.
void resample_horizontal(const uint8_t* in, int in_w, int rows, int ch,
                         int out_w, int ksize, const std::vector<int>& bounds,
                         const std::vector<int32_t>& kk, uint8_t* out) {
  constexpr int kHalf = 1 << (kPrecisionBits - 1);
  for (int yy = 0; yy < rows; yy++) {
    const uint8_t* row = in + static_cast<size_t>(yy) * in_w * ch;
    uint8_t* orow = out + static_cast<size_t>(yy) * out_w * ch;
    if (ch == 3) {
      for (int xx = 0; xx < out_w; xx++) {
        int xmin = bounds[static_cast<size_t>(xx) * 2 + 0];
        int xmax = bounds[static_cast<size_t>(xx) * 2 + 1];
        const int32_t* k = &kk[static_cast<size_t>(xx) * ksize];
        int s0 = kHalf, s1 = kHalf, s2 = kHalf;
        const uint8_t* p = row + static_cast<size_t>(xmin) * 3;
        for (int x = 0; x < xmax; x++, p += 3) {
          int kx = k[x];
          s0 += p[0] * kx;
          s1 += p[1] * kx;
          s2 += p[2] * kx;
        }
        orow[xx * 3 + 0] = clip8(s0);
        orow[xx * 3 + 1] = clip8(s1);
        orow[xx * 3 + 2] = clip8(s2);
      }
    } else {
      for (int xx = 0; xx < out_w; xx++) {
        int xmin = bounds[static_cast<size_t>(xx) * 2 + 0];
        int xmax = bounds[static_cast<size_t>(xx) * 2 + 1];
        const int32_t* k = &kk[static_cast<size_t>(xx) * ksize];
        int ss = kHalf;
        const uint8_t* p = row + xmin;
        for (int x = 0; x < xmax; x++) ss += p[x] * k[x];
        orow[xx] = clip8(ss);
      }
    }
  }
}

// Vertical pass: per output row, stream each contributing source row once
// (tap-outer, pixel-inner) into an i32 accumulator row — row-major access
// that auto-vectorizes; same fixed-point math as the reference loop order.
void resample_vertical(const uint8_t* in, int w, int ch, int out_h, int ksize,
                       const std::vector<int>& bounds,
                       const std::vector<int32_t>& kk, uint8_t* out) {
  constexpr int kHalf = 1 << (kPrecisionBits - 1);
  const size_t stride = static_cast<size_t>(w) * ch;
  std::vector<int32_t> acc(stride);
  for (int yy = 0; yy < out_h; yy++) {
    int ymin = bounds[static_cast<size_t>(yy) * 2 + 0];
    int ymax = bounds[static_cast<size_t>(yy) * 2 + 1];
    const int32_t* k = &kk[static_cast<size_t>(yy) * ksize];
    std::fill(acc.begin(), acc.end(), kHalf);
    for (int y = 0; y < ymax; y++) {
      const uint8_t* row = in + static_cast<size_t>(y + ymin) * stride;
      int32_t ky = k[y];
      for (size_t i = 0; i < stride; i++) acc[i] += row[i] * ky;
    }
    uint8_t* orow = out + static_cast<size_t>(yy) * stride;
    for (size_t i = 0; i < stride; i++) orow[i] = clip8(acc[i]);
  }
}

// PIL.Image.resize with BILINEAR/BICUBIC (antialiased two-pass resample).
void resample_image(const std::vector<uint8_t>& in, int w, int h, int ch,
                    int out_w, int out_h, const Filter& f,
                    std::vector<uint8_t>* out) {
  bool need_h = out_w != w;
  bool need_v = out_h != h;
  if (!need_h && !need_v) {
    *out = in;
    return;
  }
  const std::vector<uint8_t>* src = &in;
  std::vector<uint8_t> tmp;
  int cur_h = h;
  if (need_h) {
    std::vector<int> bounds;
    std::vector<int32_t> kk;
    int ksize = precompute_coeffs(w, out_w, f, &bounds, &kk);
    tmp.resize(static_cast<size_t>(out_w) * cur_h * ch);
    resample_horizontal(src->data(), w, cur_h, ch, out_w, ksize, bounds, kk,
                        tmp.data());
    src = &tmp;
  }
  if (need_v) {
    std::vector<int> bounds;
    std::vector<int32_t> kk;
    int ksize = precompute_coeffs(h, out_h, f, &bounds, &kk);
    out->resize(static_cast<size_t>(out_w) * out_h * ch);
    resample_vertical(src->data(), out_w, ch, out_h, ksize, bounds, kk,
                      out->data());
  } else {
    *out = std::move(tmp);
  }
}

// PIL.Image.resize with NEAREST: affine transform with truncation sampling
// (Geometry.c nearest; _imaging.c builds a = in/out, xin = floor(a*(x+0.5))).
void resample_nearest(const std::vector<uint8_t>& in, int w, int h, int ch,
                      int out_w, int out_h, std::vector<uint8_t>* out) {
  out->resize(static_cast<size_t>(out_w) * out_h * ch);
  double ax = static_cast<double>(w) / out_w;
  double ay = static_cast<double>(h) / out_h;
  std::vector<int> xmap(out_w);
  for (int x = 0; x < out_w; x++) {
    int xin = static_cast<int>(ax * (x + 0.5));
    xmap[x] = xin < w ? xin : w - 1;
  }
  for (int y = 0; y < out_h; y++) {
    int yin = static_cast<int>(ay * (y + 0.5));
    if (yin >= h) yin = h - 1;
    const uint8_t* row = in.data() + static_cast<size_t>(yin) * w * ch;
    uint8_t* orow = out->data() + static_cast<size_t>(y) * out_w * ch;
    for (int x = 0; x < out_w; x++)
      std::memcpy(&orow[x * ch], &row[xmap[x] * ch], ch);
  }
}

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg, PIL-default settings).
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_error_trap(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

// Corrupt-but-decodable streams make libjpeg print warnings per call — in
// the serving daemon that is attacker-controlled stderr flooding.  PIL
// suppresses them too.
void jpeg_silent_output(j_common_ptr) {}

// Corrupt-data warnings (msg_level -1, e.g. "premature end of data segment")
// mean libjpeg would gray-fill and carry on — PIL instead raises "image file
// is truncated".  Decoding must MATCH PIL or decline, so a warning fails the
// native decode and the caller falls back to PIL (which then raises or
// decodes identically).  Trace messages (msg_level >= 0) are ignored.
void jpeg_warn_trap(j_common_ptr cinfo, int msg_level) {
  if (msg_level < 0) longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

// libpng's default handlers also print to stderr per error/warning; route
// errors to the setjmp recovery silently (attacker-controlled log flooding,
// same as the libjpeg case above).
void png_silent_error(png_structp png, png_const_charp) {
  png_longjmp(png, 1);
}
void png_silent_warn(png_structp, png_const_charp) {}

// channels: 3 = force RGB (gray replicated, like PIL convert("RGB")),
//           1 = single channel (gray as-is; RGB takes channel 0 like
//               transforms.py:apply_label_transform's arr[..., 0]).
// target_w/h > 0 with scaled==1 enables DCT-scaled decode to the smallest
// scale >= target (approximate fast path).
int decode_jpeg(const uint8_t* data, size_t len, int channels, int scaled,
                int target_w, int target_h, std::vector<uint8_t>* out,
                int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_trap;
  jerr.pub.output_message = jpeg_silent_output;
  jerr.pub.emit_message = jpeg_warn_trap;
  std::vector<uint8_t> rowbuf;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return DSN_ERR_DECODE;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return DSN_ERR_DECODE;
  }
  bool gray_src = cinfo.jpeg_color_space == JCS_GRAYSCALE;
  if (!gray_src && cinfo.jpeg_color_space != JCS_YCbCr &&
      cinfo.jpeg_color_space != JCS_RGB) {
    jpeg_destroy_decompress(&cinfo);  // CMYK/YCCK: PIL semantics differ
    return DSN_ERR_UNSUPPORTED;
  }
  cinfo.out_color_space = gray_src ? JCS_GRAYSCALE : JCS_RGB;
  if (scaled && target_w > 0 && target_h > 0) {
    // largest downscale (smallest M/8) whose output still covers the target
    for (int num = 1; num <= 8; num++) {
      cinfo.scale_num = num;
      cinfo.scale_denom = 8;
      jpeg_calc_output_dimensions(&cinfo);
      if (static_cast<int>(cinfo.output_width) >= target_w &&
          static_cast<int>(cinfo.output_height) >= target_h)
        break;
    }
  }
  jpeg_start_decompress(&cinfo);
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  if (!dims_ok(*w, *h)) {  // bomb guard BEFORE the pixel allocation
    jpeg_destroy_decompress(&cinfo);
    return DSN_ERR_UNSUPPORTED;
  }
  int src_ch = cinfo.output_components;  // 1 or 3
  out->resize(static_cast<size_t>(*w) * *h * channels);
  rowbuf.resize(static_cast<size_t>(*w) * src_ch);
  JSAMPROW rows[1] = {rowbuf.data()};
  for (int y = 0; y < *h; y++) {
    jpeg_read_scanlines(&cinfo, rows, 1);
    uint8_t* orow = out->data() + static_cast<size_t>(y) * *w * channels;
    if (src_ch == channels) {
      std::memcpy(orow, rowbuf.data(), static_cast<size_t>(*w) * channels);
    } else if (src_ch == 1) {  // gray -> RGB replicate (PIL L->RGB)
      for (int x = 0; x < *w; x++)
        orow[x * 3] = orow[x * 3 + 1] = orow[x * 3 + 2] = rowbuf[x];
    } else {  // RGB -> single channel 0
      for (int x = 0; x < *w; x++) orow[x] = rowbuf[x * 3];
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return DSN_OK;
}

// ---------------------------------------------------------------------------
// PNG decode/encode (libpng).
// ---------------------------------------------------------------------------

struct PngReadState {
  const uint8_t* data;
  size_t len;
  size_t off;
};

void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->off + n > s->len) {
    png_error(png, "short read");
    return;
  }
  std::memcpy(out, s->data + s->off, n);
  s->off += n;
}

int decode_png(const uint8_t* data, size_t len, int channels,
               std::vector<uint8_t>* out, int* w, int* h) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, png_silent_error,
                             png_silent_warn);
  if (!png) return DSN_ERR_DECODE;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return DSN_ERR_DECODE;
  }
  // raw/rowptrs live above the setjmp: a longjmp from inside png_read_image
  // would otherwise skip destructors of locals declared after this point
  // (leaking the pixel buffer on every corrupt input in a long-lived server)
  std::vector<uint8_t> raw;
  std::vector<png_bytep> rowptrs;
  int rc = DSN_OK;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return DSN_ERR_DECODE;
  }
  PngReadState state{data, len, 0};
  png_set_read_fn(png, &state, png_mem_read);
  png_read_info(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);
  if (bit_depth == 16) {
    rc = DSN_ERR_UNSUPPORTED;  // PIL "I;16" conversion semantics differ
  } else if (channels == 3) {
    if (color_type == PNG_COLOR_TYPE_PALETTE) {
      png_set_palette_to_rgb(png);
    } else if (color_type == PNG_COLOR_TYPE_GRAY ||
               color_type == PNG_COLOR_TYPE_GRAY_ALPHA) {
      if (bit_depth < 8) png_set_expand_gray_1_2_4_to_8(png);
      png_set_gray_to_rgb(png);
    }
    // PIL convert("RGB") drops alpha without compositing; so does strip
    png_set_strip_alpha(png);
  } else {  // labels: raw palette indices or gray, 8-bit
    if (color_type == PNG_COLOR_TYPE_PALETTE) {
      if (bit_depth < 8) png_set_packing(png);
    } else if (color_type == PNG_COLOR_TYPE_RGB) {
      // take channel 0 after read (handled below)
    } else if (color_type != PNG_COLOR_TYPE_GRAY || bit_depth != 8) {
      rc = DSN_ERR_UNSUPPORTED;
    }
  }
  if (rc != DSN_OK) {
    png_destroy_read_struct(&png, &info, nullptr);
    return rc;
  }
  png_read_update_info(png, info);
  *w = static_cast<int>(png_get_image_width(png, info));
  *h = static_cast<int>(png_get_image_height(png, info));
  if (!dims_ok(*w, *h)) {  // bomb guard BEFORE the pixel allocation
    png_destroy_read_struct(&png, &info, nullptr);
    return DSN_ERR_UNSUPPORTED;
  }
  int src_ch = static_cast<int>(png_get_channels(png, info));
  if ((channels == 3 && src_ch != 3) ||
      (channels == 1 && src_ch != 1 && src_ch != 3)) {
    png_destroy_read_struct(&png, &info, nullptr);
    return DSN_ERR_UNSUPPORTED;
  }
  raw.resize(static_cast<size_t>(*w) * *h * src_ch);
  rowptrs.resize(*h);
  for (int y = 0; y < *h; y++)
    rowptrs[y] = raw.data() + static_cast<size_t>(y) * *w * src_ch;
  png_read_image(png, rowptrs.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  if (src_ch == channels) {
    *out = std::move(raw);
  } else {  // RGB label -> channel 0
    out->resize(static_cast<size_t>(*w) * *h);
    for (size_t i = 0; i < out->size(); i++) (*out)[i] = raw[i * 3];
  }
  return DSN_OK;
}

void png_mem_write(png_structp png, png_bytep data, png_size_t n) {
  auto* vec = static_cast<std::vector<uint8_t>*>(png_get_io_ptr(png));
  vec->insert(vec->end(), data, data + n);
}

void png_mem_flush(png_structp) {}

// ---------------------------------------------------------------------------
// Shared pipeline.
// ---------------------------------------------------------------------------

int sniff_and_decode(const uint8_t* data, size_t len, int channels,
                     const DsnOps* ops, std::vector<uint8_t>* px, int* w,
                     int* h) {
  if (len >= 2 && data[0] == 0xFF && data[1] == 0xD8) {
    int tw = 0, th = 0;
    if (ops->scaled_decode && ops->resize_w > 0) {
      // decode may stop above the pre-crop (center_crop) size if one is set:
      // the resize input is the center crop, so cover that region instead
      tw = ops->center_crop > 0 ? ops->center_crop : ops->resize_w;
      th = ops->center_crop > 0 ? ops->center_crop : ops->resize_h;
    }
    return decode_jpeg(data, len, channels, ops->scaled_decode, tw, th, px, w,
                       h);
  }
  if (len >= 4 && data[0] == 0x89 && data[1] == 'P' && data[2] == 'N' &&
      data[3] == 'G')
    return decode_png(data, len, channels, px, w, h);
  return DSN_ERR_FORMAT;
}

// Python's round() is round-half-to-even: int(round(m / 2.0)) for m >= 0.
// std::lround is half-away-from-zero, which differs whenever m is odd and
// floor(m/2) is even (m=1: 0 vs 1; m=5: 2 vs 3) — the crop origin must match
// the PIL paths (transforms.py:69-71, evaluate_folder.py:46) bit-exactly.
static inline int half_even_div2(int m) {
  int q = m / 2;
  if (m % 2 == 0) return q;
  return q + (q & 1);
}

int apply_ops(std::vector<uint8_t>* px, int* w, int* h, int ch,
              const DsnOps* ops) {
  // center crop (Python banker's-rounding origin; transforms.py:67-72)
  if (ops->center_crop > 0) {
    int cc = ops->center_crop;
    if (cc > *w || cc > *h) return DSN_ERR_BOUNDS;
    int left = half_even_div2(*w - cc);
    int top = half_even_div2(*h - cc);
    std::vector<uint8_t> cropped(static_cast<size_t>(cc) * cc * ch);
    for (int y = 0; y < cc; y++)
      std::memcpy(&cropped[static_cast<size_t>(y) * cc * ch],
                  px->data() + ((static_cast<size_t>(top + y) * *w) + left) * ch,
                  static_cast<size_t>(cc) * ch);
    *px = std::move(cropped);
    *w = *h = cc;
  }
  // resize
  if (ops->resize_w > 0 && (ops->resize_w != *w || ops->resize_h != *h)) {
    // Both target dims must be positive and the output bounded: a zero or
    // negative resize_h would divide by zero / wrap a size_t allocation.
    if (!dims_ok(ops->resize_w, ops->resize_h)) return DSN_ERR_DIMS;
    std::vector<uint8_t> resized;
    if (ops->resample == DSN_NEAREST) {
      resample_nearest(*px, *w, *h, ch, ops->resize_w, ops->resize_h, &resized);
    } else {
      Filter f = ops->resample == DSN_BILINEAR
                     ? Filter{bilinear_filter, 1.0}
                     : Filter{bicubic_filter, 2.0};
      resample_image(*px, *w, *h, ch, ops->resize_w, ops->resize_h, f,
                     &resized);
    }
    *px = std::move(resized);
    *w = ops->resize_w;
    *h = ops->resize_h;
  }
  // crop
  if (ops->crop_w > 0 && (ops->crop_w != *w || ops->crop_h != *h ||
                          ops->crop_x != 0 || ops->crop_y != 0)) {
    if (ops->crop_h <= 0) return DSN_ERR_BOUNDS;
    // int64 arithmetic: crop_x + crop_w can overflow int32 on hostile ops
    if (ops->crop_x < 0 || ops->crop_y < 0 ||
        int64_t{ops->crop_x} + ops->crop_w > *w ||
        int64_t{ops->crop_y} + ops->crop_h > *h)
      return DSN_ERR_BOUNDS;
    std::vector<uint8_t> cropped(static_cast<size_t>(ops->crop_w) *
                                 ops->crop_h * ch);
    for (int y = 0; y < ops->crop_h; y++)
      std::memcpy(
          &cropped[static_cast<size_t>(y) * ops->crop_w * ch],
          px->data() +
              ((static_cast<size_t>(ops->crop_y + y) * *w) + ops->crop_x) * ch,
          static_cast<size_t>(ops->crop_w) * ch);
    *px = std::move(cropped);
    *w = ops->crop_w;
    *h = ops->crop_h;
  }
  // horizontal flip
  if (ops->flip) {
    for (int y = 0; y < *h; y++) {
      uint8_t* row = px->data() + static_cast<size_t>(y) * *w * ch;
      for (int x = 0; x < *w / 2; x++)
        for (int c = 0; c < ch; c++)
          std::swap(row[x * ch + c], row[(*w - 1 - x) * ch + c]);
    }
  }
  return DSN_OK;
}

int read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return DSN_ERR_IO;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  if (n < 0) {
    std::fclose(f);
    return DSN_ERR_IO;
  }
  std::fseek(f, 0, SEEK_SET);
  buf->resize(static_cast<size_t>(n));
  size_t got = std::fread(buf->data(), 1, buf->size(), f);
  std::fclose(f);
  return got == buf->size() ? DSN_OK : DSN_ERR_IO;
}

int decode_image_impl(const uint8_t* data, size_t len, const DsnOps* ops,
                      int expect_w, int expect_h, float* out) {
  std::vector<uint8_t> px;
  int w = 0, h = 0;
  int rc = sniff_and_decode(data, len, 3, ops, &px, &w, &h);
  if (rc != DSN_OK) return rc;
  rc = apply_ops(&px, &w, &h, 3, ops);
  if (rc != DSN_OK) return rc;
  if (w != expect_w || h != expect_h) return DSN_ERR_DIMS;
  // float32 (x/255)*2-1, two f32 ops like numpy (transforms.py:108-109)
  size_t n = static_cast<size_t>(w) * h * 3;
  for (size_t i = 0; i < n; i++) {
    float v = static_cast<float>(px[i]) / 255.0f;
    out[i] = v * 2.0f - 1.0f;
  }
  return DSN_OK;
}

int decode_label_impl(const uint8_t* data, size_t len, const DsnOps* ops,
                      int map255_to, int expect_w, int expect_h, int32_t* out) {
  std::vector<uint8_t> px;
  int w = 0, h = 0;
  DsnOps lops = *ops;
  lops.resample = DSN_NEAREST;  // labels always NEAREST (base_dataset.py:90)
  lops.scaled_decode = 0;       // labels stay exact even in fast mode
  int rc = sniff_and_decode(data, len, 1, &lops, &px, &w, &h);
  if (rc != DSN_OK) return rc;
  rc = apply_ops(&px, &w, &h, 1, &lops);
  if (rc != DSN_OK) return rc;
  if (w != expect_w || h != expect_h) return DSN_ERR_DIMS;
  size_t n = static_cast<size_t>(w) * h;
  for (size_t i = 0; i < n; i++)
    out[i] = px[i] == 255 ? map255_to : px[i];
  return DSN_OK;
}

}  // namespace

extern "C" {

// "No exceptions cross the ABI": a hostile stream that still slips an
// allocation failure (or any other throw) past the guards above must come
// back as an error code, never std::terminate in the host process.
int32_t dsn_decode_image(const uint8_t* data, int64_t len, const DsnOps* ops,
                         int32_t expect_w, int32_t expect_h, float* out) {
  try {
    return decode_image_impl(data, static_cast<size_t>(len), ops, expect_w,
                             expect_h, out);
  } catch (...) {
    return DSN_ERR_DECODE;
  }
}

int32_t dsn_decode_image_file(const char* path, const DsnOps* ops,
                              int32_t expect_w, int32_t expect_h, float* out) {
  try {
    std::vector<uint8_t> buf;
    int rc = read_file(path, &buf);
    if (rc != DSN_OK) return rc;
    return decode_image_impl(buf.data(), buf.size(), ops, expect_w, expect_h,
                             out);
  } catch (...) {
    return DSN_ERR_DECODE;
  }
}

int32_t dsn_decode_label(const uint8_t* data, int64_t len, const DsnOps* ops,
                         int32_t map255_to, int32_t expect_w, int32_t expect_h,
                         int32_t* out) {
  try {
    return decode_label_impl(data, static_cast<size_t>(len), ops, map255_to,
                             expect_w, expect_h, out);
  } catch (...) {
    return DSN_ERR_DECODE;
  }
}

int32_t dsn_decode_label_file(const char* path, const DsnOps* ops,
                              int32_t map255_to, int32_t expect_w,
                              int32_t expect_h, int32_t* out) {
  try {
    std::vector<uint8_t> buf;
    int rc = read_file(path, &buf);
    if (rc != DSN_OK) return rc;
    return decode_label_impl(buf.data(), buf.size(), ops, map255_to, expect_w,
                             expect_h, out);
  } catch (...) {
    return DSN_ERR_DECODE;
  }
}

// Decode to raw uint8 (server wire path; no normalize).  channels 3 or 1.
int32_t dsn_decode_u8(const uint8_t* data, int64_t len, const DsnOps* ops,
                      int32_t channels, int32_t expect_w, int32_t expect_h,
                      uint8_t* out) {
  try {
    std::vector<uint8_t> px;
    int w = 0, h = 0;
    int rc = sniff_and_decode(data, static_cast<size_t>(len), channels, ops,
                              &px, &w, &h);
    if (rc != DSN_OK) return rc;
    rc = apply_ops(&px, &w, &h, channels, ops);
    if (rc != DSN_OK) return rc;
    if (w != expect_w || h != expect_h) return DSN_ERR_DIMS;
    std::memcpy(out, px.data(), px.size());
    return DSN_OK;
  } catch (...) {
    return DSN_ERR_DECODE;
  }
}

// Probe dims without decoding pixel data.  Returns 0 and fills w/h (and
// channels as seen on the wire) or a negative error.
int32_t dsn_probe(const uint8_t* data, int64_t len, int32_t* w, int32_t* h) {
  size_t n = static_cast<size_t>(len);
  if (n >= 2 && data[0] == 0xFF && data[1] == 0xD8) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_error_trap;
    jerr.pub.output_message = jpeg_silent_output;
    if (setjmp(jerr.jb)) {
      jpeg_destroy_decompress(&cinfo);
      return DSN_ERR_DECODE;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
                 static_cast<unsigned long>(n));
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
      jpeg_destroy_decompress(&cinfo);
      return DSN_ERR_DECODE;
    }
    *w = static_cast<int32_t>(cinfo.image_width);
    *h = static_cast<int32_t>(cinfo.image_height);
    jpeg_destroy_decompress(&cinfo);
    return DSN_OK;
  }
  if (n >= 24 && data[0] == 0x89 && data[1] == 'P') {
    // IHDR is always the first chunk: width/height big-endian at offset 16.
    // Shift via int64: data[16] >= 0x80 would overflow int32 << 24 (UB), and
    // a crafted header must not hand callers negative/absurd dimensions.
    int64_t pw = (int64_t{data[16]} << 24) | (data[17] << 16) |
                 (data[18] << 8) | data[19];
    int64_t ph = (int64_t{data[20]} << 24) | (data[21] << 16) |
                 (data[22] << 8) | data[23];
    if (!dims_ok(pw, ph)) return DSN_ERR_DECODE;
    *w = static_cast<int32_t>(pw);
    *h = static_cast<int32_t>(ph);
    return DSN_OK;
  }
  return DSN_ERR_FORMAT;
}

// Encode interleaved RGB8 (or gray8 with channels=1) to PNG.  level: zlib
// 0-9; levels <= 2 also disable filtering (fast serving path).  Returns the
// byte length written, or a negative error.  `cap` bounds the output buffer.
int64_t dsn_encode_png(const uint8_t* px, int32_t w, int32_t h,
                       int32_t channels, int32_t level, uint8_t* out,
                       int64_t cap) {
  if (!dims_ok(w, h) || (channels != 1 && channels != 3) || cap < 0)
    return DSN_ERR_DIMS;
  if (level < 0) level = 0;
  if (level > 9) level = 9;
  try {
  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, png_silent_error,
                              png_silent_warn);
  if (!png) return DSN_ERR_DECODE;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    return DSN_ERR_DECODE;
  }
  std::vector<uint8_t> buf;
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    return DSN_ERR_DECODE;
  }
  png_set_write_fn(png, &buf, png_mem_write, png_mem_flush);
  png_set_IHDR(png, info, w, h, 8,
               channels == 1 ? PNG_COLOR_TYPE_GRAY : PNG_COLOR_TYPE_RGB,
               PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
               PNG_FILTER_TYPE_DEFAULT);
  png_set_compression_level(png, level);
  if (level <= 2) png_set_filter(png, 0, PNG_FILTER_NONE);
  png_write_info(png, info);
  rows.resize(h);
  for (int y = 0; y < h; y++)
    rows[y] = const_cast<uint8_t*>(px) + static_cast<size_t>(y) * w * channels;
  png_write_image(png, rows.data());
  png_write_end(png, nullptr);
  png_destroy_write_struct(&png, &info);
  if (static_cast<int64_t>(buf.size()) > cap) return DSN_ERR_CAP;
  std::memcpy(out, buf.data(), buf.size());
  return static_cast<int64_t>(buf.size());
  } catch (...) {
    return DSN_ERR_DECODE;
  }
}

}  // extern "C"

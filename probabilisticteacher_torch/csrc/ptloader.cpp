// Native host data loader: JPEG/PNG decode + PIL-parity bilinear resampling +
// flip + canvas padding, exposed as a C ABI for ctypes.
//
// Replaces the reference's torch DataLoader worker path (PIL decode +
// detectron2 ResizeShortestEdge, pt/data/dataset_mapper.py:97-110). Python
// callers drive it from a thread pool: ctypes releases the GIL for the
// duration of the call, so decode overlaps the device step.
//
// Resampling parity: PIL's BILINEAR resize is a proper triangle-filter
// resampler (support scales with the downscale factor), NOT naive 2x2 bilinear
// sampling. We implement the same separable triangle filter in float, which
// matches PIL within +-1 intensity level (PIL uses 8-bit fixed-point tables).
//
// Build: probabilisticteacher_torch/data/native.py runs
// g++ -O3 -shared -fPIC -std=c++17 ... -ljpeg -lpng at first use.

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

struct Image {
  int h = 0, w = 0;
  std::vector<uint8_t> rgb;  // h * w * 3
};

// ----------------------------------------------------------------- JPEG decode
struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

bool decode_jpeg(FILE* f, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->rgb.resize(size_t(out->h) * out->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->rgb.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ------------------------------------------------------------------ PNG decode
bool decode_png(FILE* f, Image* out) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
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
  png_init_io(png, f);
  png_read_info(png, info);
  png_set_strip_16(png);
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  out->h = png_get_image_height(png, info);
  out->w = png_get_image_width(png, info);
  out->rgb.resize(size_t(out->h) * out->w * 3);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y)
    rows[y] = out->rgb.data() + size_t(y) * out->w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_file(const char* path, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  size_t got = fread(magic, 1, 8, f);
  rewind(f);
  bool ok = false;
  if (got >= 3 && magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, out);
  } else if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    ok = decode_png(f, out);
  }
  fclose(f);
  return ok;
}

// -------------------------------------------- PIL-parity triangle resampling
// One separable pass along an axis: in_size -> out_size with triangle filter.
void resample_axis(const float* src, float* dst, int count /*rows*/,
                   int in_size, int out_size, int stride_in, int stride_out,
                   int row_stride_in, int row_stride_out, int channels) {
  const double scale = double(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 1.0 * filterscale;  // bilinear support = 1

  std::vector<int> bounds(out_size * 2);
  std::vector<double> kk;
  int ksize = int(std::ceil(support)) * 2 + 1;
  kk.resize(size_t(out_size) * ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = std::max(0, int(center - support + 0.5));
    int xmax = std::min(in_size, int(center + support + 0.5)) - xmin;
    double* k = &kk[size_t(xx) * ksize];
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      double t = (x + xmin - center + 0.5) / filterscale;
      double wv = t < 0 ? (t > -1 ? 1 + t : 0) : (t < 1 ? 1 - t : 0);
      k[x] = wv;
      ww += wv;
    }
    for (int x = 0; x < xmax; ++x)
      if (ww != 0.0) k[x] /= ww;
    bounds[xx * 2] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }

  for (int r = 0; r < count; ++r) {
    const float* srow = src + size_t(r) * row_stride_in;
    float* drow = dst + size_t(r) * row_stride_out;
    for (int xx = 0; xx < out_size; ++xx) {
      int xmin = bounds[xx * 2], xmax = bounds[xx * 2 + 1];
      const double* k = &kk[size_t(xx) * ksize];
      for (int c = 0; c < channels; ++c) {
        double acc = 0.0;
        for (int x = 0; x < xmax; ++x)
          acc += srow[size_t(x + xmin) * stride_in + c] * k[x];
        drow[size_t(xx) * stride_out + c] = float(acc);
      }
    }
  }
}

void resize_bilinear(const Image& in, int out_h, int out_w, std::vector<float>* out) {
  // horizontal pass then vertical pass (PIL order)
  std::vector<float> tmp(size_t(in.h) * out_w * 3);
  std::vector<float> srcf(in.rgb.begin(), in.rgb.end());
  resample_axis(srcf.data(), tmp.data(), in.h, in.w, out_w,
                3, 3, in.w * 3, out_w * 3, 3);
  // vertical: treat columns as the resample axis; iterate over out_w "rows"
  out->assign(size_t(out_h) * out_w * 3, 0.f);
  // transpose-free: resample along rows of the transposed view
  // stride_in over y = out_w*3 ; row stride = 3 (per column)
  resample_axis(tmp.data(), out->data(), out_w, in.h, out_h,
                out_w * 3, out_w * 3, 3, 3, 3);
}

}  // namespace

extern "C" {

// Decode path, resize shortest edge (<= max_size), optional hflip, convert to
// BGR, paste into a zeroed canvas_h x canvas_w x 3 uint8 canvas.
// Returns 0 on success. out_hw = valid (h, w); out_scale = resize scale.
int ptl_load_image(const char* path, int short_edge, int max_size, int flip,
                   int canvas_h, int canvas_w, uint8_t* out_canvas,
                   int* out_hw, float* out_scale) {
  Image img;
  if (!decode_file(path, &img)) return 1;

  double scale = double(short_edge) / std::min(img.h, img.w);
  if (std::max(img.h, img.w) * scale > max_size)
    scale = double(max_size) / std::max(img.h, img.w);
  int nh = int(std::lround(img.h * scale));
  int nw = int(std::lround(img.w * scale));

  std::vector<float> resized;
  if (nh == img.h && nw == img.w) {
    resized.assign(img.rgb.begin(), img.rgb.end());
  } else {
    resize_bilinear(img, nh, nw, &resized);
  }

  int ph = std::min(nh, canvas_h), pw = std::min(nw, canvas_w);
  for (int y = 0; y < ph; ++y) {
    for (int x = 0; x < pw; ++x) {
      int sx = flip ? (nw - 1 - x) : x;
      const float* p = &resized[(size_t(y) * nw + sx) * 3];
      uint8_t* q = &out_canvas[(size_t(y) * canvas_w + x) * 3];
      // RGB -> BGR with PIL-style rounding + clamp
      for (int c = 0; c < 3; ++c) {
        float v = p[2 - c];
        v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
        q[c] = uint8_t(v + 0.5f);
      }
    }
  }
  out_hw[0] = ph;
  out_hw[1] = pw;
  *out_scale = float(scale);
  return 0;
}

// Decode only (no resize): out buffer must hold h*w*3; call ptl_image_size first.
int ptl_image_size(const char* path, int* out_hw) {
  Image img;
  if (!decode_file(path, &img)) return 1;
  out_hw[0] = img.h;
  out_hw[1] = img.w;
  return 0;
}

}  // extern "C"

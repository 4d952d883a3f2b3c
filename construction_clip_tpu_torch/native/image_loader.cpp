// Host-side JPEG ingest of the PyTorch port: decode + short-side scale +
// center crop, fused (a copy of native/image_loader.cpp, held equal to it from
// the first #include on by tests/test_torch_native_loader.py).
//
// Decode runs in C with libjpeg's DCT-domain scaling (scale_num/8 during
// decode), then a box downscale to the exact staging size and a center crop,
// written straight into a caller-provided buffer.
//
// C ABI (ctypes binding in construction_clip_tpu_torch/data/native_loader.py,
// which compiles this file with g++ -O3 -fPIC -shared ... -ljpeg into
// build/torch_native/ at first use):
//   int cctpu_decode_resize_crop(const uint8_t* data, long len, int out_size,
//                                uint8_t* out /* out_size*out_size*3 */);
//   int cctpu_jpeg_dims(const uint8_t* data, long len, int* w, int* h);
//   both return 0 on success, negative error codes otherwise.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <vector>
#include <algorithm>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Box-filter downscale from (w, h) to (tw, th), RGB interleaved.
void box_resize(const uint8_t* src, int w, int h, uint8_t* dst, int tw, int th) {
  for (int y = 0; y < th; ++y) {
    const int y0 = static_cast<int>(static_cast<long>(y) * h / th);
    int y1 = static_cast<int>(static_cast<long>(y + 1) * h / th);
    if (y1 <= y0) y1 = y0 + 1;
    for (int x = 0; x < tw; ++x) {
      const int x0 = static_cast<int>(static_cast<long>(x) * w / tw);
      int x1 = static_cast<int>(static_cast<long>(x + 1) * w / tw);
      if (x1 <= x0) x1 = x0 + 1;
      unsigned sum[3] = {0, 0, 0};
      for (int yy = y0; yy < y1; ++yy) {
        const uint8_t* row = src + (static_cast<long>(yy) * w + x0) * 3;
        for (int xx = x0; xx < x1; ++xx) {
          sum[0] += row[0];
          sum[1] += row[1];
          sum[2] += row[2];
          row += 3;
        }
      }
      const unsigned n = static_cast<unsigned>((y1 - y0) * (x1 - x0));
      uint8_t* out = dst + (static_cast<long>(y) * tw + x) * 3;
      out[0] = static_cast<uint8_t>(sum[0] / n);
      out[1] = static_cast<uint8_t>(sum[1] / n);
      out[2] = static_cast<uint8_t>(sum[2] / n);
    }
  }
}

}  // namespace

extern "C" {

// Decode header only: fills *w, *h. Returns 0 on success.
int cctpu_jpeg_dims(const uint8_t* data, long len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode + short-side scale to out_size + center crop -> out [out_size, out_size, 3].
int cctpu_decode_resize_crop(const uint8_t* data, long len, int out_size,
                             uint8_t* out) {
  if (out_size <= 0) return -2;
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  // Declared BEFORE setjmp: longjmp skips destructors of anything constructed
  // after it, so the decode buffers must already be in scope when the error
  // branch returns (their destructors then run at normal scope exit).
  std::vector<uint8_t> full, rowbuf, scaled;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  // DCT-domain prescale: the largest num/8 whose short side stays >= out_size.
  const int short_side = std::min(static_cast<int>(cinfo.image_width),
                                  static_cast<int>(cinfo.image_height));
  int num = 8;
  while (num > 1 && (static_cast<long>(short_side) * (num - 1)) / 8 >= out_size) {
    --num;
  }
  cinfo.scale_num = static_cast<unsigned>(num);
  cinfo.scale_denom = 8;

  jpeg_start_decompress(&cinfo);
  const int w = static_cast<int>(cinfo.output_width);
  const int h = static_cast<int>(cinfo.output_height);
  const int comps = cinfo.output_components;
  if (comps != 3) {  // grayscale fallback: expand below
    if (comps != 1) {
      jpeg_destroy_decompress(&cinfo);
      return -3;
    }
  }

  full.resize(static_cast<size_t>(w) * h * 3);
  rowbuf.resize(static_cast<size_t>(w) * comps);
  JSAMPROW rowptr = rowbuf.data();
  for (int y = 0; y < h; ++y) {
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
    uint8_t* dst = full.data() + static_cast<size_t>(y) * w * 3;
    if (comps == 3) {
      std::memcpy(dst, rowbuf.data(), static_cast<size_t>(w) * 3);
    } else {
      for (int x = 0; x < w; ++x) {
        dst[x * 3] = dst[x * 3 + 1] = dst[x * 3 + 2] = rowbuf[x];
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  // short-side scale target
  int th, tw;
  if (h <= w) {
    th = out_size;
    tw = std::max(out_size, static_cast<int>(
        (static_cast<long>(w) * out_size + h / 2) / h));
  } else {
    tw = out_size;
    th = std::max(out_size, static_cast<int>(
        (static_cast<long>(h) * out_size + w / 2) / w));
  }
  scaled.resize(static_cast<size_t>(tw) * th * 3);
  box_resize(full.data(), w, h, scaled.data(), tw, th);

  // torchvision CenterCrop margin = int(round(m / 2.0)) in Python, which is
  // banker's rounding: odd margins round the .5 to the EVEN half. Matches
  // data/pipeline.host_shape_unify and data/preprocess.center_crop.
  auto crop_off = [](int m) {
    int half = m / 2;
    if ((m & 1) && (half & 1)) ++half;  // x.5 rounds to even
    return half;
  };
  const int top = crop_off(th - out_size);
  const int left = crop_off(tw - out_size);
  for (int y = 0; y < out_size; ++y) {
    std::memcpy(out + static_cast<size_t>(y) * out_size * 3,
                scaled.data() + ((static_cast<size_t>(top + y) * tw) + left) * 3,
                static_cast<size_t>(out_size) * 3);
  }
  return 0;
}

}  // extern "C"

// The port's CPU JPEG decoder: libjpeg, full resolution, the stored planes.
//
// The CPU counterpart of jpeg_nvjpeg.cu, and the port's own copy of the
// libjpeg decode of the JAX package's native/decoder.cpp, without its DCT
// prescaling and bilinear resize. Both decoders stop at the image's
// component planes, each at its own subsampling (Y, Cb, Cr; the gray plane;
// R, G, B; C, M, Y, K; or Y, Cb, Cr, K): data/native_decoder.py upsamples
// them and converts to RGB as libjpeg does by default and PIL takes the
// result, on the CPU or the card alike.
//
// Plain C interface for ctypes (semanticlens_tpu_torch/data/native_decoder.py):
//   sl_jpeg_info(data, size, widths, heights, &components, &color_space, msg, msg_len) -> status
//   sl_jpeg_decode_planes(data, size, planes, msg, msg_len) -> status
// color_space is libjpeg's J_COLOR_SPACE as it reads the markers (JFIF,
// Adobe's APP14 transform, the component ids): JCS_GRAYSCALE, JCS_RGB,
// JCS_YCbCr, JCS_CMYK or JCS_YCCK.
// Status: 0 decoded; 1 libjpeg refused the data (its message is in msg);
// 2 another colour space or component count.

#include <algorithm>
#include <csetjmp>
#include <cstddef>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>
#include <jerror.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
  char message[JMSG_LENGTH_MAX];
};

void on_error(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, err->message);
  longjmp(err->jump, 1);
}

// Warnings are ignored as PIL ignores them, except a premature end of the
// data: libjpeg would fill the rest of the image, PIL refuses a truncated file.
void on_emit(j_common_ptr cinfo, int msg_level) {
  if (msg_level < 0 && cinfo->err->msg_code == JWRN_JPEG_EOF) on_error(cinfo);
}

void copy_message(const ErrorMgr& err, char* msg, int msg_len) {
  if (msg != nullptr && msg_len > 0) {
    std::strncpy(msg, err.message, static_cast<size_t>(msg_len) - 1);
    msg[msg_len - 1] = '\0';
  }
}

// Reads the header and sizes the planes; 0, 1 or 2 as above.
int open_header(jpeg_decompress_struct* cinfo, ErrorMgr* err, const unsigned char* data,
                unsigned long size) {
  cinfo->err = jpeg_std_error(&err->pub);
  err->pub.error_exit = on_error;
  err->pub.emit_message = on_emit;
  err->message[0] = '\0';
  jpeg_create_decompress(cinfo);
  jpeg_mem_src(cinfo, data, size);
  jpeg_read_header(cinfo, TRUE);
  const J_COLOR_SPACE space = cinfo->jpeg_color_space;
  const int n = cinfo->num_components;
  const bool known = (space == JCS_GRAYSCALE && n == 1) || ((space == JCS_YCbCr || space == JCS_RGB) && n == 3) ||
                     ((space == JCS_CMYK || space == JCS_YCCK) && n == 4);
  if (!known) {
    std::snprintf(err->message, sizeof(err->message), "colour space %d with %d components has no RGB decode",
                  static_cast<int>(space), n);
    return 2;
  }
  cinfo->raw_data_out = TRUE;
  jpeg_calc_output_dimensions(cinfo);
  return 0;
}

}  // namespace

extern "C" {

// Each component's plane size (downsampled width and height), the component
// count (1, 3 or 4) and libjpeg's colour space.
int sl_jpeg_info(const unsigned char* data, unsigned long size, int* widths, int* heights,
                 int* components, int* color_space, char* msg, int msg_len) {
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  if (setjmp(err.jump)) {
    copy_message(err, msg, msg_len);
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  const int status = open_header(&cinfo, &err, data, size);
  *components = cinfo.num_components;
  *color_space = static_cast<int>(cinfo.jpeg_color_space);
  if (status == 0) {
    for (int c = 0; c < cinfo.num_components; ++c) {
      widths[c] = static_cast<int>(cinfo.comp_info[c].downsampled_width);
      heights[c] = static_cast<int>(cinfo.comp_info[c].downsampled_height);
    }
  }
  copy_message(err, msg, msg_len);
  jpeg_destroy_decompress(&cinfo);
  return status;
}

// Decodes each component into planes[c] (row-major, the size sl_jpeg_info gave).
int sl_jpeg_decode_planes(const unsigned char* data, unsigned long size, unsigned char** planes,
                          char* msg, int msg_len) {
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  // Declared before setjmp, so that a longjmp out of libjpeg leaves them to their destructors.
  std::vector<std::vector<JSAMPLE>> buffers;
  std::vector<std::vector<JSAMPROW>> rows;
  std::vector<JSAMPARRAY> arrays;
  std::vector<int> done;
  if (setjmp(err.jump)) {
    copy_message(err, msg, msg_len);
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  const int status = open_header(&cinfo, &err, data, size);
  if (status != 0) {
    copy_message(err, msg, msg_len);
    jpeg_destroy_decompress(&cinfo);
    return status;
  }
  jpeg_start_decompress(&cinfo);
  const int n = cinfo.num_components;
  // One iMCU row per read: v_samp_factor · DCTSIZE rows of each component,
  // width_in_blocks · DCTSIZE wide (the planes' padding is dropped on copy).
  buffers.resize(n);
  rows.resize(n);
  arrays.resize(n);
  done.assign(n, 0);
  for (int c = 0; c < n; ++c) {
    const jpeg_component_info& comp = cinfo.comp_info[c];
    const size_t width = static_cast<size_t>(comp.width_in_blocks) * DCTSIZE;
    const int height = comp.v_samp_factor * DCTSIZE;
    buffers[c].resize(width * height);
    rows[c].resize(height);
    for (int r = 0; r < height; ++r) rows[c][r] = buffers[c].data() + width * r;
    arrays[c] = rows[c].data();
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    jpeg_read_raw_data(&cinfo, arrays.data(), cinfo.max_v_samp_factor * DCTSIZE);
    for (int c = 0; c < n; ++c) {
      const jpeg_component_info& comp = cinfo.comp_info[c];
      const int w = static_cast<int>(comp.downsampled_width);
      const int h = static_cast<int>(comp.downsampled_height);
      const int chunk = std::min(comp.v_samp_factor * DCTSIZE, h - done[c]);
      for (int r = 0; r < chunk; ++r) {
        std::memcpy(planes[c] + static_cast<size_t>(done[c] + r) * w, rows[c][r], static_cast<size_t>(w));
      }
      done[c] += std::max(chunk, 0);
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"

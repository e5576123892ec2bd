// JPEG decode (and encode) on the card through the CUDA toolkit's nvJPEG.
//
// Not a port of a TPU kernel: the JAX package decodes JPEGs on the host
// (libjpeg in native/decoder.cpp, or PIL). The card's machine has no
// libjpeg, so the port decodes there with nvJPEG, straight into device
// memory the caller allocated (a torch tensor), on the stream the caller
// passes. nvjpegCreateSimple picks nvJPEG's default backend: Huffman
// decoding on the host thread that calls, the IDCT on the card, so the
// decode rate follows the host's cores.
//
// The decoder stops at the component planes (Y, Cb, Cr at their own
// subsampling, or the planes as stored for RGB-coded, CMYK and YCCK files):
// nvJPEG's own chroma upsampling replicates samples, where
// libjpeg (PIL's decode, the JAX package's reference) interpolates, and
// differs by up to ~100 levels at colour edges. data/native_decoder.py
// upsamples and converts the planes as libjpeg does.
//
// A context holds one handle and one decode state and is used by one thread
// at a time (nvJPEG's decode state is not thread-safe); the encoder's state
// and parameters are made on first use. The encoder exists so that a
// machine without PIL can write JPEG files (chip_smoke.py); the package's
// decode path does not use it.
//
// Plain C interface for ctypes (semanticlens_tpu_torch/data/native_decoder.py).
// Every function returns an nvjpegStatus_t (0 = success), or -1 for a CUDA
// runtime error.

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

struct Context {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  nvjpegEncoderState_t enc_state = nullptr;
  nvjpegEncoderParams_t enc_params = nullptr;
};

}  // namespace

extern "C" {

int sl_nvjpeg_create(void** out) {
  auto* ctx = new Context();
  nvjpegStatus_t s = nvjpegCreateSimple(&ctx->handle);
  if (s == NVJPEG_STATUS_SUCCESS) s = nvjpegJpegStateCreate(ctx->handle, &ctx->state);
  if (s != NVJPEG_STATUS_SUCCESS) {
    if (ctx->handle != nullptr) nvjpegDestroy(ctx->handle);
    delete ctx;
    return s;
  }
  *out = ctx;
  return 0;
}

int sl_nvjpeg_destroy(void* p) {
  auto* ctx = static_cast<Context*>(p);
  if (ctx->enc_params != nullptr) nvjpegEncoderParamsDestroy(ctx->enc_params);
  if (ctx->enc_state != nullptr) nvjpegEncoderStateDestroy(ctx->enc_state);
  nvjpegJpegStateDestroy(ctx->state);
  const nvjpegStatus_t s = nvjpegDestroy(ctx->handle);
  delete ctx;
  return s;
}

// Each component's plane size (widths[c], heights[c], c < 4), the component
// count and the chroma subsampling (nvjpegChromaSubsampling_t).
int sl_nvjpeg_info(void* p, const unsigned char* data, size_t size, int* widths, int* heights,
                   int* components, int* subsampling) {
  auto* ctx = static_cast<Context*>(p);
  nvjpegChromaSubsampling_t css = NVJPEG_CSS_UNKNOWN;
  const nvjpegStatus_t s = nvjpegGetImageInfo(ctx->handle, data, size, components, &css, widths, heights);
  *subsampling = static_cast<int>(css);
  return s;
}

// Decodes the component planes into planes[c] on the card, rows pitches[c]
// bytes apart, on the given stream. `output` is an nvjpegOutputFormat_t:
// NVJPEG_OUTPUT_YUV (Y, Cb, Cr at their own subsampling), NVJPEG_OUTPUT_Y (the
// gray plane), or NVJPEG_OUTPUT_UNCHANGED (every component as stored: R, G, B
// of an RGB-coded file, the four planes of a CMYK or YCCK file, which
// NVJPEG_MAX_COMPONENT = 4 allows).
int sl_nvjpeg_decode_planes(void* p, const unsigned char* data, size_t size, int components, int output,
                            unsigned char** planes, const int* pitches, void* stream) {
  auto* ctx = static_cast<Context*>(p);
  nvjpegImage_t image = {};
  for (int c = 0; c < components && c < NVJPEG_MAX_COMPONENT; ++c) {
    image.channel[c] = planes[c];
    image.pitch[c] = static_cast<unsigned int>(pitches[c]);
  }
  const nvjpegStatus_t s = nvjpegDecode(ctx->handle, ctx->state, data, size, static_cast<nvjpegOutputFormat_t>(output),
                                        &image, static_cast<cudaStream_t>(stream));
  if (s != NVJPEG_STATUS_SUCCESS) return s;
  return cudaGetLastError() == cudaSuccess ? 0 : -1;
}

// Encodes interleaved RGB on the card (height × 3·width bytes, row-major) as a
// baseline JPEG with 4:2:0 chroma at the given quality. Waits for the stream
// and puts the size of the bitstream in *length; sl_nvjpeg_encoded copies it.
int sl_nvjpeg_encode(void* p, const unsigned char* rgb, int width, int height, int quality,
                     void* stream, size_t* length) {
  auto* ctx = static_cast<Context*>(p);
  auto st = static_cast<cudaStream_t>(stream);
  nvjpegStatus_t s = NVJPEG_STATUS_SUCCESS;
  if (ctx->enc_state == nullptr) {
    s = nvjpegEncoderStateCreate(ctx->handle, &ctx->enc_state, st);
    if (s != NVJPEG_STATUS_SUCCESS) return s;
  }
  if (ctx->enc_params == nullptr) {
    s = nvjpegEncoderParamsCreate(ctx->handle, &ctx->enc_params, st);
    if (s != NVJPEG_STATUS_SUCCESS) return s;
  }
  s = nvjpegEncoderParamsSetQuality(ctx->enc_params, quality, st);
  if (s == NVJPEG_STATUS_SUCCESS) s = nvjpegEncoderParamsSetSamplingFactors(ctx->enc_params, NVJPEG_CSS_420, st);
  if (s != NVJPEG_STATUS_SUCCESS) return s;
  nvjpegImage_t image = {};
  image.channel[0] = const_cast<unsigned char*>(rgb);
  image.pitch[0] = static_cast<unsigned int>(3 * width);
  s = nvjpegEncodeImage(ctx->handle, ctx->enc_state, ctx->enc_params, &image, NVJPEG_INPUT_RGBI,
                        width, height, st);
  if (s != NVJPEG_STATUS_SUCCESS) return s;
  s = nvjpegEncodeRetrieveBitstream(ctx->handle, ctx->enc_state, nullptr, length, st);
  if (s != NVJPEG_STATUS_SUCCESS) return s;
  return cudaStreamSynchronize(st) == cudaSuccess ? 0 : -1;
}

// Copies the last encoded bitstream into out (capacity *length bytes; the
// size sl_nvjpeg_encode gave), and puts the bytes written in *length.
int sl_nvjpeg_encoded(void* p, unsigned char* out, size_t* length, void* stream) {
  auto* ctx = static_cast<Context*>(p);
  return nvjpegEncodeRetrieveBitstream(ctx->handle, ctx->enc_state, out, length,
                                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"

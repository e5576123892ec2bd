// WebP lossy (VP8 key frame) decoding on the host, to Y, U and V planes.
//
// The entropy-coded steps of data/webp.py for a lossy image (RFC 6386): the
// boolean decoder, the frame header, the intra modes, the coefficient
// tokens, dequantization, the inverse transforms, intra prediction and the
// loop filter. Each macroblock is predicted from its decoded neighbours and
// each token's probability from the tokens before it, so the work is
// sequential and stays on the host, one image per call, in plain C++ with
// nothing outside the standard library. The cropped planes reach the device
// in one upload, where data/webp.py upsamples the chroma and converts to RGB.
//
// The decode follows libwebp, the decoder behind PIL's WebP plugin, where the
// format leaves room: intra prediction reads the unfiltered reconstruction
// (127 above the frame, 129 left of it), the loop filter runs after it on
// whole macroblocks in raster order, and the end of a partition is an error
// once a read starts with fewer than 8 bits of it left unread (libwebp's
// eof_, which fails the frame). Coefficients are held in 16 bits, as there.
//
// Plain C interface for ctypes (semanticlens_tpu_torch/data/webp.py):
//   sl_vp8_decode(data, len, y, u, v, width, height) -> status
//     `data` holds a VP8 chunk's payload (and its pad byte, as libwebp reads
//     it); `y` receives width·height bytes, `u` and `v` each
//     ceil(width/2)·ceil(height/2).
// Status: 0 done; 1 a broken or truncated bitstream; 2 a frame header other
// than the caller's (not a key frame, not shown, another size).

#include <cstddef>
#include <cstdint>
#include <algorithm>
#include <cstring>
#include <vector>

namespace {

// Default coefficient probabilities, [type][band][context][node] (RFC 6386, section 13.5).
const uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
// Probabilities that a coefficient probability is updated (RFC 6386, section 13.4).
const uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
// Key-frame subblock mode probabilities, [above mode][left mode][node] (RFC 6386, section 11.5),
// with the modes numbered as BMode below.
const uint8_t kBModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
};
// Dequantization: DC and AC step sizes by quantizer index (RFC 6386, section 14.1).
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};  // band of coefficient n
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// Intra modes, numbered as libwebp numbers them (kBModesProba is indexed so).
// The 16×16 and chroma modes share the first four numbers, so a macroblock
// predicted whole gives its neighbours' subblock-mode contexts directly.
enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
enum { DC_PRED = B_DC, TM_PRED = B_TM, V_PRED = B_VE, H_PRED = B_HE };

struct Failure {};

int clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

// --------------------------------------------------------------------------
// Boolean decoder (RFC 6386 section 7), with libwebp's end-of-data rule.
// --------------------------------------------------------------------------
struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  uint32_t range = 254;  // the range minus one
  int bits = -8;         // bits of `value` below the current 8-bit window (value keeps at most 64)
  bool eof = false;

  void init(const uint8_t* data, size_t n) {
    buf = data;
    end = data + n;
    value = 0;
    range = 254;
    bits = -8;
    eof = false;
    load();
  }
  void load() {  // 56 bits at a time while 8 bytes remain, then a byte at a time (libwebp's VP8LoadNewBytes)
    if (end - buf >= 8) {
      uint64_t in = 0;
      for (int i = 0; i < 7; ++i) in = (in << 8) | buf[i];
      buf += 7;
      value = (value << 56) | in;
      bits += 56;
    } else if (buf < end) {
      bits += 8;
      value = (value << 8) | *buf++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int get(int prob) {
    if (bits < 0) load();
    uint32_t r = range;
    const uint32_t split = (r * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t v = static_cast<uint32_t>(value >> bits);
    const int bit = v > split;
    if (bit) {
      r -= split;
      value -= static_cast<uint64_t>(split + 1) << bits;
    } else {
      r = split + 1;
    }
    const int shift = __builtin_clz(r) - 24;  // back to a range of 128–255
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  int value_bits(int n) {  // n bits, most significant first
    int v = 0;
    while (n-- > 0) v |= get(0x80) << n;
    return v;
  }
  int signed_value(int n) {
    const int v = value_bits(n);
    return get(0x80) ? -v : v;
  }
};

// --------------------------------------------------------------------------
// Frame state
// --------------------------------------------------------------------------
struct Quant {
  int y1[2], y2[2], uv[2];  // DC and AC factors
};

struct FilterInfo {
  int limit = 0, ilevel = 0, hev_thresh = 0;
  bool inner = false;
};

struct MBInfo {  // what one macroblock carries from parsing to reconstruction and filtering
  int segment = 0;
  bool skip = false, i4x4 = false;
  uint8_t modes[16];  // subblock modes, or the 16×16 mode in modes[0]
  uint8_t uv_mode = 0;
  int16_t coeffs[384];
};

struct Decoder {
  int mb_w = 0, mb_h = 0;
  // segmentation
  bool use_segment = false, update_map = false, absolute_delta = true;
  int seg_quant[4] = {0}, seg_filter[4] = {0};
  int seg_proba[3] = {255, 255, 255};
  // loop filter
  bool simple = false;
  int level = 0, sharpness = 0, filter_type = 0;
  bool use_lf_delta = false;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  FilterInfo fstrengths[4][2];
  // partitions and probabilities
  BoolReader br;
  std::vector<BoolReader> parts;
  Quant quant[4];
  uint8_t proba[4][8][3][11];
  bool use_skip_proba = false;
  int skip_proba = 0;
  // contexts
  std::vector<uint8_t> intra_t;  // 4 subblock modes per macroblock column
  uint8_t intra_l[4];
  std::vector<uint8_t> nz_top;   // per column: bits 0-3 Y, 4-5 U, 6-7 V
  std::vector<uint8_t> nz_dc_top;
  uint8_t nz_left = 0, nz_dc_left = 0;
  // planes (whole macroblocks), unfiltered until the end
  int y_stride = 0, uv_stride = 0;
  std::vector<uint8_t> y, u, v;
  std::vector<FilterInfo> finfo;
};

void parse_segment_header(Decoder& d) {
  BoolReader& br = d.br;
  d.use_segment = br.get(0x80);
  if (d.use_segment) {
    d.update_map = br.get(0x80);
    if (br.get(0x80)) {  // update data
      d.absolute_delta = br.get(0x80);
      for (int s = 0; s < 4; ++s) d.seg_quant[s] = br.get(0x80) ? br.signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) d.seg_filter[s] = br.get(0x80) ? br.signed_value(6) : 0;
    }
    if (d.update_map) {
      for (int s = 0; s < 3; ++s) d.seg_proba[s] = br.get(0x80) ? br.value_bits(8) : 255;
    }
  } else {
    d.update_map = false;
  }
  if (br.eof) throw Failure{};
}

void parse_filter_header(Decoder& d) {
  BoolReader& br = d.br;
  d.simple = br.get(0x80);
  d.level = br.value_bits(6);
  d.sharpness = br.value_bits(3);
  d.use_lf_delta = br.get(0x80);
  if (d.use_lf_delta && br.get(0x80)) {  // update the deltas
    for (int i = 0; i < 4; ++i)
      if (br.get(0x80)) d.ref_lf_delta[i] = br.signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br.get(0x80)) d.mode_lf_delta[i] = br.signed_value(6);
  }
  d.filter_type = d.level == 0 ? 0 : d.simple ? 1 : 2;
  if (br.eof) throw Failure{};
}

// The token partitions: 3-byte sizes, each clamped to what is left; the last
// partition takes the rest and must not be empty.
void parse_partitions(Decoder& d, const uint8_t* buf, size_t size) {
  const size_t last = (1u << d.br.value_bits(2)) - 1;
  if (size < 3 * last) throw Failure{};
  const uint8_t* sizes = buf;
  const uint8_t* start = buf + 3 * last;
  size_t left = size - 3 * last;
  d.parts.resize(last + 1);
  for (size_t p = 0; p < last; ++p) {
    size_t psize = sizes[0] | (sizes[1] << 8) | (sizes[2] << 16);
    if (psize > left) psize = left;
    d.parts[p].init(start, psize);
    start += psize;
    left -= psize;
    sizes += 3;
  }
  d.parts[last].init(start, left);
  if (left == 0) throw Failure{};
}

int clip_index(int v, int max) { return v < 0 ? 0 : v > max ? max : v; }

void parse_quant(Decoder& d) {
  BoolReader& br = d.br;
  const int base_q = br.value_bits(7);
  const int dy1_dc = br.get(0x80) ? br.signed_value(4) : 0;
  const int dy2_dc = br.get(0x80) ? br.signed_value(4) : 0;
  const int dy2_ac = br.get(0x80) ? br.signed_value(4) : 0;
  const int duv_dc = br.get(0x80) ? br.signed_value(4) : 0;
  const int duv_ac = br.get(0x80) ? br.signed_value(4) : 0;
  for (int s = 0; s < 4; ++s) {
    int q = base_q;
    if (d.use_segment) {
      q = d.seg_quant[s] + (d.absolute_delta ? 0 : base_q);
    } else if (s > 0) {
      d.quant[s] = d.quant[0];
      continue;
    }
    Quant& m = d.quant[s];
    m.y1[0] = kDcTable[clip_index(q + dy1_dc, 127)];
    m.y1[1] = kAcTable[clip_index(q, 127)];
    m.y2[0] = kDcTable[clip_index(q + dy2_dc, 127)] * 2;
    m.y2[1] = kAcTable[clip_index(q + dy2_ac, 127)] * 155 / 100;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip_index(q + duv_dc, 117)];
    m.uv[1] = kAcTable[clip_index(q + duv_ac, 127)];
  }
}

void parse_proba(Decoder& d) {
  BoolReader& br = d.br;
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          const int i = ((t * 8 + b) * 3 + c) * 11 + p;
          d.proba[t][b][c][p] = static_cast<uint8_t>(br.get(kCoeffsUpdateProba[i]) ? br.value_bits(8) : kCoeffsProba0[i]);
        }
  d.use_skip_proba = br.get(0x80);
  if (d.use_skip_proba) d.skip_proba = br.value_bits(8);
}

// Filter strength per segment and per "is 4×4" (libwebp's PrecomputeFilterStrengths).
void precompute_filter_strengths(Decoder& d) {
  if (d.filter_type == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base = d.level;
    if (d.use_segment) base = d.seg_filter[s] + (d.absolute_delta ? 0 : d.level);
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FilterInfo& info = d.fstrengths[s][i4x4];
      int level = base;
      if (d.use_lf_delta) {
        level += d.ref_lf_delta[0];
        if (i4x4) level += d.mode_lf_delta[0];
      }
      level = level < 0 ? 0 : level > 63 ? 63 : level;
      if (level > 0) {
        int ilevel = level;
        if (d.sharpness > 0) {
          ilevel >>= d.sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - d.sharpness) ilevel = 9 - d.sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = ilevel;
        info.limit = 2 * level + ilevel;
        info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      } else {
        info.limit = 0;
      }
      info.inner = i4x4;
    }
  }
}

// --------------------------------------------------------------------------
// Modes and tokens
// --------------------------------------------------------------------------
void parse_intra_mode(Decoder& d, int mb_x, MBInfo& mb) {
  BoolReader& br = d.br;
  uint8_t* top = &d.intra_t[4 * mb_x];
  uint8_t* left = d.intra_l;
  mb.segment = 0;
  if (d.update_map) mb.segment = !br.get(d.seg_proba[0]) ? br.get(d.seg_proba[1]) : br.get(d.seg_proba[2]) + 2;
  mb.skip = d.use_skip_proba ? br.get(d.skip_proba) : false;
  mb.i4x4 = !br.get(145);
  if (!mb.i4x4) {
    const int ymode = br.get(156) ? (br.get(128) ? TM_PRED : H_PRED) : (br.get(163) ? V_PRED : DC_PRED);
    mb.modes[0] = static_cast<uint8_t>(ymode);
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
  } else {
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
        ymode = !br.get(prob[0])   ? B_DC
                : !br.get(prob[1]) ? B_TM
                : !br.get(prob[2]) ? B_VE
                : !br.get(prob[3]) ? (!br.get(prob[4]) ? B_HE : (!br.get(prob[5]) ? B_RD : B_VR))
                                   : (!br.get(prob[6]) ? B_LD
                                                       : (!br.get(prob[7]) ? B_VL : (!br.get(prob[8]) ? B_HD : B_HU)));
        top[x] = static_cast<uint8_t>(ymode);
      }
      std::memcpy(mb.modes + 4 * y, top, 4);
      left[y] = static_cast<uint8_t>(ymode);
    }
  }
  mb.uv_mode = !br.get(142) ? DC_PRED : !br.get(114) ? V_PRED : br.get(183) ? TM_PRED : H_PRED;
}

int large_value(BoolReader& br, const uint8_t* p) {
  if (!br.get(p[3])) {
    if (!br.get(p[4])) return 2;
    return 3 + br.get(p[5]);
  }
  if (!br.get(p[6])) {
    if (!br.get(p[7])) return 5 + br.get(159);
    int v = 7 + 2 * br.get(165);
    return v + br.get(145);
  }
  const int bit1 = br.get(p[8]);
  const int bit0 = br.get(p[9 + bit1]);
  const int cat = 2 * bit1 + bit0;
  int v = 0;
  for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get(*tab);
  return v + 3 + (8 << cat);
}

// The tokens of one 4×4 block from coefficient n on; returns the position
// after the last token read (libwebp's GetCoeffs), which drives the contexts.
int get_coeffs(BoolReader& br, const uint8_t (*prob)[3][11], int ctx, const int* dq, int n, int16_t* out) {
  const uint8_t* p = prob[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get(p[0])) return n;  // end of block
    while (!br.get(p[1])) {       // zeros
      p = prob[kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    if (!br.get(p[2])) {
      v = 1;
      p = prob[kBands[n + 1]][1];
    } else {
      v = large_value(br, p);
      p = prob[kBands[n + 1]][2];
    }
    out[kZigzag[n]] = static_cast<int16_t>((br.get(0x80) ? -v : v) * dq[n > 0]);
  }
  return 16;
}

void transform_wht(const int16_t* in, int16_t* out) {  // inverse Walsh-Hadamard: DC of each 4×4 block
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// Parses one macroblock's coefficients (libwebp's ParseResiduals); returns
// whether any block has a coefficient, by libwebp's count of positions read.
bool parse_residuals(Decoder& d, int mb_x, MBInfo& mb, BoolReader& br) {
  const Quant& q = d.quant[mb.segment];
  int16_t* dst = mb.coeffs;
  std::memset(dst, 0, sizeof(mb.coeffs));
  bool nonzero = false;
  int first;
  const uint8_t(*ac_proba)[3][11];
  if (!mb.i4x4) {
    int16_t dc[16] = {0};
    const int ctx = d.nz_dc_top[mb_x] + d.nz_dc_left;
    const int nz = get_coeffs(br, d.proba[1], ctx, q.y2, 0, dc);
    d.nz_dc_top[mb_x] = d.nz_dc_left = nz > 0;
    transform_wht(dc, dst);
    first = 1;
    ac_proba = d.proba[0];
  } else {
    first = 0;
    ac_proba = d.proba[3];
  }
  uint8_t tnz = d.nz_top[mb_x] & 0x0f, lnz = d.nz_left & 0x0f;
  uint8_t out_t = 0, out_l = 0;
  for (int y = 0; y < 4; ++y) {
    int l = (lnz >> y) & 1;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + ((tnz >> x) & 1);
      const int nz = get_coeffs(br, ac_proba, ctx, q.y1, first, dst);
      l = nz > first;
      tnz = static_cast<uint8_t>((tnz & ~(1 << x)) | (l << x));
      nonzero = nonzero || nz > 1 || dst[0] != 0;
      dst += 16;
    }
    out_l |= static_cast<uint8_t>(l << y);
  }
  out_t = tnz;
  for (int ch = 0; ch < 2; ++ch) {  // U then V: 2×2 blocks each
    const int shift = 4 + 2 * ch;
    uint8_t t = (d.nz_top[mb_x] >> shift) & 3, lf = (d.nz_left >> shift) & 3;
    for (int y = 0; y < 2; ++y) {
      int l = (lf >> y) & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + ((t >> x) & 1);
        const int nz = get_coeffs(br, d.proba[2], ctx, q.uv, 0, dst);
        l = nz > 0;
        t = static_cast<uint8_t>((t & ~(1 << x)) | (l << x));
        nonzero = nonzero || nz > 1 || dst[0] != 0;
        dst += 16;
      }
      lf = static_cast<uint8_t>((lf & ~(1 << y)) | (l << y));
    }
    out_t |= static_cast<uint8_t>(t << shift);
    out_l |= static_cast<uint8_t>(lf << shift);
  }
  d.nz_top[mb_x] = out_t;
  d.nz_left = out_l;
  return nonzero;
}

// --------------------------------------------------------------------------
// Reconstruction, in a work buffer laid out as libwebp's: 32-byte rows, the
// row above and the column left of each block in place around it.
// --------------------------------------------------------------------------
constexpr int BPS = 32;
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int WORK_SIZE = BPS * 17 + BPS * 9;
constexpr int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS, 0 + 4 * BPS,  4 + 4 * BPS,
                           8 + 4 * BPS,  12 + 4 * BPS, 0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                           0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

int mul1(int a) { return ((a * 20091) >> 16) + a; }
int mul2(int a) { return (a * 35468) >> 16; }

void transform_one(const int16_t* in, uint8_t* dst) {  // inverse DCT, added to the prediction
  int c[16];
  int* tmp = c;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8], b = in[0] - in[8];
    const int cc = mul2(in[4]) - mul1(in[12]), dd = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + dd;
    tmp[1] = b + cc;
    tmp[2] = b - cc;
    tmp[3] = a - dd;
    tmp += 4;
    ++in;
  }
  tmp = c;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8], b = dc - tmp[8];
    const int cc = mul2(tmp[4]) - mul1(tmp[12]), dd = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = static_cast<uint8_t>(clip8(dst[0] + ((a + dd) >> 3)));
    dst[1] = static_cast<uint8_t>(clip8(dst[1] + ((b + cc) >> 3)));
    dst[2] = static_cast<uint8_t>(clip8(dst[2] + ((b - cc) >> 3)));
    dst[3] = static_cast<uint8_t>(clip8(dst[3] + ((a - dd) >> 3)));
    ++tmp;
    dst += BPS;
  }
}

void add_residual(const int16_t* coeffs, uint8_t* dst) {
  for (int i = 0; i < 16; ++i) {
    if (coeffs[i]) {
      transform_one(coeffs, dst);
      return;
    }
  }
}

#define AVG3(a, b, c) (static_cast<uint8_t>(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)
#define DST(x, y) dst[(x) + (y) * BPS]

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y, dst += BPS)
    for (int x = 0; x < size; ++x) dst[x] = static_cast<uint8_t>(clip8(top[x] + dst[-1] - top[-1]));
}

void predict4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS], X = top[-1];
  const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, dc >> 3, 4);
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const uint8_t vals[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D), AVG3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE: {
      std::memset(dst, AVG3(X, I, J), 4);
      std::memset(dst + BPS, AVG3(I, J, K), 4);
      std::memset(dst + 2 * BPS, AVG3(J, K, L), 4);
      std::memset(dst + 3 * BPS, AVG3(K, L, L), 4);
      break;
    }
    case B_RD:
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    case B_LD:
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    case B_VL:
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
    default:  // B_HU
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
}

// 16×16 luma or 8×8 chroma prediction; DC without the row above or the column
// left of the frame averages what there is, or is 128 with neither.
void predict_block(int mode, uint8_t* dst, int size, bool has_top, bool has_left) {
  const int log2 = size == 16 ? 4 : 3;
  switch (mode) {
    case DC_PRED: {
      int dc;
      if (has_top && has_left) {
        dc = size;
        for (int i = 0; i < size; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
        dc >>= log2 + 1;
      } else if (has_left) {
        dc = size >> 1;
        for (int i = 0; i < size; ++i) dc += dst[-1 + i * BPS];
        dc >>= log2;
      } else if (has_top) {
        dc = size >> 1;
        for (int i = 0; i < size; ++i) dc += dst[i - BPS];
        dc >>= log2;
      } else {
        dc = 0x80;
      }
      for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dc, size);
      break;
    }
    case TM_PRED: true_motion(dst, size); break;
    case V_PRED:
      for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
      break;
    default:  // H_PRED
      for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
  }
}

// Reconstructs one row of macroblocks into the planes (libwebp's ReconstructRow).
void reconstruct_row(Decoder& d, int mb_y, std::vector<MBInfo>& row, std::vector<uint8_t>& top_samples) {
  uint8_t work[WORK_SIZE];
  std::memset(work, 0, sizeof(work));
  uint8_t* const yd = work + Y_OFF;
  uint8_t* const ud = work + U_OFF;
  uint8_t* const vd = work + V_OFF;
  for (int j = 0; j < 16; ++j) yd[j * BPS - 1] = 129;
  for (int j = 0; j < 8; ++j) ud[j * BPS - 1] = vd[j * BPS - 1] = 129;
  if (mb_y > 0) {
    yd[-1 - BPS] = ud[-1 - BPS] = vd[-1 - BPS] = 129;
  } else {
    std::memset(yd - BPS - 1, 127, 16 + 4 + 1);
    std::memset(ud - BPS - 1, 127, 8 + 1);
    std::memset(vd - BPS - 1, 127, 8 + 1);
  }
  for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
    const MBInfo& mb = row[mb_x];
    if (mb_x > 0) {  // the previous block's right columns become this one's left
      for (int j = -1; j < 16; ++j) std::memcpy(yd + j * BPS - 4, yd + j * BPS + 12, 4);
      for (int j = -1; j < 8; ++j) {
        std::memcpy(ud + j * BPS - 4, ud + j * BPS + 4, 4);
        std::memcpy(vd + j * BPS - 4, vd + j * BPS + 4, 4);
      }
    }
    uint8_t* top_y = &top_samples[static_cast<size_t>(mb_x) * 32];  // 16 Y, 8 U, 8 V: the unfiltered row above
    if (mb_y > 0) {
      std::memcpy(yd - BPS, top_y, 16);
      std::memcpy(ud - BPS, top_y + 16, 8);
      std::memcpy(vd - BPS, top_y + 24, 8);
    }
    if (mb.i4x4) {
      uint8_t* top_right = yd - BPS + 16;
      if (mb_y > 0) {
        if (mb_x >= d.mb_w - 1) std::memset(top_right, top_y[15], 4);
        else std::memcpy(top_right, top_y + 32, 4);
      }
      // the subblocks of the right column take the block's top-right pixels as theirs
      for (int r = 1; r < 4; ++r) std::memcpy(top_right + 4 * r * BPS, top_right, 4);
      for (int n = 0; n < 16; ++n) {
        uint8_t* dst = yd + kScan[n];
        predict4(mb.modes[n], dst);
        add_residual(mb.coeffs + n * 16, dst);
      }
    } else {
      predict_block(mb.modes[0], yd, 16, mb_y > 0, mb_x > 0);
      for (int n = 0; n < 16; ++n) add_residual(mb.coeffs + n * 16, yd + kScan[n]);
    }
    predict_block(mb.uv_mode, ud, 8, mb_y > 0, mb_x > 0);
    predict_block(mb.uv_mode, vd, 8, mb_y > 0, mb_x > 0);
    for (int n = 0; n < 4; ++n) {
      const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
      add_residual(mb.coeffs + 256 + n * 16, ud + off);
      add_residual(mb.coeffs + 320 + n * 16, vd + off);
    }
    std::memcpy(top_y, yd + 15 * BPS, 16);
    std::memcpy(top_y + 16, ud + 7 * BPS, 8);
    std::memcpy(top_y + 24, vd + 7 * BPS, 8);
    for (int j = 0; j < 16; ++j)
      std::memcpy(&d.y[static_cast<size_t>(mb_y * 16 + j) * d.y_stride + mb_x * 16], yd + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      std::memcpy(&d.u[static_cast<size_t>(mb_y * 8 + j) * d.uv_stride + mb_x * 8], ud + j * BPS, 8);
      std::memcpy(&d.v[static_cast<size_t>(mb_y * 8 + j) * d.uv_stride + mb_x * 8], vd + j * BPS, 8);
    }
  }
}

// --------------------------------------------------------------------------
// Loop filter (RFC 6386 section 15)
// --------------------------------------------------------------------------
int abs0(int v) { return v < 0 ? -v : v; }
int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020] → [-128, 127]
int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112] → [-16, 15]

void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = static_cast<uint8_t>(clip8(p0 + a2));
  p[0] = static_cast<uint8_t>(clip8(q0 - a1));
}

void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * step] = static_cast<uint8_t>(clip8(p1 + a3));
  p[-step] = static_cast<uint8_t>(clip8(p0 + a2));
  p[0] = static_cast<uint8_t>(clip8(q0 - a1));
  p[step] = static_cast<uint8_t>(clip8(q1 - a3));
}

void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = static_cast<uint8_t>(clip8(p2 + a3));
  p[-2 * step] = static_cast<uint8_t>(clip8(p1 + a2));
  p[-step] = static_cast<uint8_t>(clip8(p0 + a1));
  p[0] = static_cast<uint8_t>(clip8(q0 - a1));
  p[step] = static_cast<uint8_t>(clip8(q1 - a2));
  p[2 * step] = static_cast<uint8_t>(clip8(q2 - a3));
}

bool hev(const uint8_t* p, int step, int thresh) {
  return abs0(p[-2 * step] - p[-step]) > thresh || abs0(p[step] - p[0]) > thresh;
}

bool needs_filter(const uint8_t* p, int step, int t) {
  return 4 * abs0(p[-step] - p[0]) + abs0(p[-2 * step] - p[step]) <= t;
}

bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  int m = std::max(abs0(p3 - p2), abs0(p2 - p1));
  m = std::max(m, std::max(abs0(p1 - p0), abs0(q3 - q2)));
  m = std::max(m, std::max(abs0(q2 - q1), abs0(q1 - q0)));
  return (4 * abs0(p0 - q0) + abs0(p1 - q1) <= t) & (m <= it);
}

// `hstride` steps across the edge, `vstride` along it.
void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, thresh2)) do_filter2(p, hstride);
}

void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_thresh, bool edge) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, thresh2, ithresh)) continue;
    if (hev(p, hstride, hev_thresh)) do_filter2(p, hstride);
    else if (edge) do_filter6(p, hstride);
    else do_filter4(p, hstride);
  }
}

void filter_mb(Decoder& d, int mb_x, int mb_y) {
  const FilterInfo& f = d.finfo[static_cast<size_t>(mb_y) * d.mb_w + mb_x];
  if (f.limit == 0) return;
  const int ys = d.y_stride, uvs = d.uv_stride;
  uint8_t* y = &d.y[static_cast<size_t>(mb_y) * 16 * ys + mb_x * 16];
  if (d.filter_type == 1) {
    if (mb_x > 0) simple_filter(y, 1, ys, f.limit + 4);
    if (f.inner)
      for (int k = 1; k < 4; ++k) simple_filter(y + 4 * k, 1, ys, f.limit);
    if (mb_y > 0) simple_filter(y, ys, 1, f.limit + 4);
    if (f.inner)
      for (int k = 1; k < 4; ++k) simple_filter(y + 4 * k * ys, ys, 1, f.limit);
    return;
  }
  uint8_t* u = &d.u[static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8];
  uint8_t* v = &d.v[static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8];
  const int il = f.ilevel, hev_t = f.hev_thresh;
  if (mb_x > 0) {
    filter_loop(y, 1, ys, 16, f.limit + 4, il, hev_t, true);
    filter_loop(u, 1, uvs, 8, f.limit + 4, il, hev_t, true);
    filter_loop(v, 1, uvs, 8, f.limit + 4, il, hev_t, true);
  }
  if (f.inner) {
    for (int k = 1; k < 4; ++k) filter_loop(y + 4 * k, 1, ys, 16, f.limit, il, hev_t, false);
    filter_loop(u + 4, 1, uvs, 8, f.limit, il, hev_t, false);
    filter_loop(v + 4, 1, uvs, 8, f.limit, il, hev_t, false);
  }
  if (mb_y > 0) {
    filter_loop(y, ys, 1, 16, f.limit + 4, il, hev_t, true);
    filter_loop(u, uvs, 1, 8, f.limit + 4, il, hev_t, true);
    filter_loop(v, uvs, 1, 8, f.limit + 4, il, hev_t, true);
  }
  if (f.inner) {
    for (int k = 1; k < 4; ++k) filter_loop(y + 4 * k * ys, ys, 1, 16, f.limit, il, hev_t, false);
    filter_loop(u + 4 * uvs, uvs, 1, 8, f.limit, il, hev_t, false);
    filter_loop(v + 4 * uvs, uvs, 1, 8, f.limit, il, hev_t, false);
  }
}

// --------------------------------------------------------------------------
// The frame
// --------------------------------------------------------------------------
int decode_frame(const uint8_t* data, size_t len, uint8_t* y_out, uint8_t* u_out, uint8_t* v_out, int width,
                 int height) {
  if (len < 10) return 1;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  const bool key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7, show = (bits >> 4) & 1;
  const size_t first_size = bits >> 5;
  if (!key_frame || profile > 3 || !show) return 2;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return 2;
  const int w = (data[6] | (data[7] << 8)) & 0x3fff, h = (data[8] | (data[9] << 8)) & 0x3fff;
  if (w != width || h != height) return 2;
  const uint8_t* buf = data + 10;
  const size_t size = len - 10;
  if (first_size > size) return 1;

  Decoder d;
  d.mb_w = (width + 15) >> 4;
  d.mb_h = (height + 15) >> 4;
  d.br.init(buf, first_size);
  d.br.get(0x80);  // colour space
  d.br.get(0x80);  // clamping type: the decoder always clamps
  parse_segment_header(d);
  parse_filter_header(d);
  parse_partitions(d, buf + first_size, size - first_size);
  parse_quant(d);
  d.br.get(0x80);  // refresh the entropy probabilities: one frame only
  parse_proba(d);
  precompute_filter_strengths(d);

  d.y_stride = d.mb_w * 16;
  d.uv_stride = d.mb_w * 8;
  d.y.assign(static_cast<size_t>(d.y_stride) * d.mb_h * 16, 0);
  d.u.assign(static_cast<size_t>(d.uv_stride) * d.mb_h * 8, 0);
  d.v.assign(d.u.size(), 0);
  d.finfo.resize(static_cast<size_t>(d.mb_w) * d.mb_h);
  d.intra_t.assign(static_cast<size_t>(4) * d.mb_w, B_DC);
  d.nz_top.assign(d.mb_w, 0);
  d.nz_dc_top.assign(d.mb_w, 0);
  std::vector<MBInfo> row(d.mb_w);
  std::vector<uint8_t> top_samples(static_cast<size_t>(32) * (d.mb_w + 1), 0);
  const size_t num_parts = d.parts.size();
  for (int mb_y = 0; mb_y < d.mb_h; ++mb_y) {
    std::memset(d.intra_l, B_DC, sizeof(d.intra_l));
    d.nz_left = d.nz_dc_left = 0;
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) parse_intra_mode(d, mb_x, row[mb_x]);
    if (d.br.eof) return 1;  // premature end of partition 0
    BoolReader& tokens = d.parts[mb_y & (num_parts - 1)];
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
      MBInfo& mb = row[mb_x];
      bool skip = mb.skip;
      if (!skip) {
        skip = !parse_residuals(d, mb_x, mb, tokens);
      } else {
        std::memset(mb.coeffs, 0, sizeof(mb.coeffs));
        d.nz_left = 0;
        d.nz_top[mb_x] = 0;
        if (!mb.i4x4) d.nz_dc_left = d.nz_dc_top[mb_x] = 0;
      }
      if (d.filter_type > 0) {
        FilterInfo f = d.fstrengths[mb.segment][mb.i4x4];
        f.inner = f.inner || !skip;
        d.finfo[static_cast<size_t>(mb_y) * d.mb_w + mb_x] = f;
      }
      if (tokens.eof) return 1;  // premature end of a token partition
    }
    reconstruct_row(d, mb_y, row, top_samples);
  }
  if (d.filter_type > 0)
    for (int mb_y = 0; mb_y < d.mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) filter_mb(d, mb_x, mb_y);

  for (int j = 0; j < height; ++j) std::memcpy(y_out + static_cast<size_t>(j) * width, &d.y[static_cast<size_t>(j) * d.y_stride], width);
  const int uw = (width + 1) / 2, uh = (height + 1) / 2;
  for (int j = 0; j < uh; ++j) {
    std::memcpy(u_out + static_cast<size_t>(j) * uw, &d.u[static_cast<size_t>(j) * d.uv_stride], uw);
    std::memcpy(v_out + static_cast<size_t>(j) * uw, &d.v[static_cast<size_t>(j) * d.uv_stride], uw);
  }
  return 0;
}

}  // namespace

extern "C" {

int sl_vp8_decode(const uint8_t* data, size_t len, uint8_t* y, uint8_t* u, uint8_t* v, int width, int height) {
  try {
    return decode_frame(data, len, y, u, v, width, height);
  } catch (const Failure&) {
    return 1;
  }
}

}  // extern "C"

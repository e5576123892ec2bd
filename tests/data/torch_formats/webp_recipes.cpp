// Writes the WebP fixtures whose encoder settings Pillow's save cannot choose:
// the simple loop filter, filter sharpness and strength, one segment, 2, 4 and
// 8 token partitions, raw (uncompressed) alpha and each alpha filtering
// effort. libwebp writes one token partition whenever method ≥ 3, so the
// partition recipes use methods 0 and 2. Their content is drawn here from a
// fixed seed (gradients, discs, texture and an alpha ramp with a transparent
// band), so the files are the same on every run of the same libwebp.
//
// Built against libwebp's encoder, which only this program uses; the port
// decodes the files without it. From the repository root:
//
//   g++ -O2 -o /tmp/webp_recipes tests/data/torch_formats/webp_recipes.cpp -lwebp
//   /tmp/webp_recipes tests/data/torch_formats
//
// then `python tests/data/torch_formats/webp_fixtures.py` records PIL's
// arrays of every WebP fixture.

#include <webp/encode.h>

#include <cstdint>
#include <cstdio>
#include <string>
#include <vector>

namespace {

struct Image {
  int width, height;
  std::vector<uint8_t> rgba;
};

Image draw(int width, int height, uint32_t seed) {
  Image im{width, height, std::vector<uint8_t>(static_cast<size_t>(width) * height * 4)};
  uint32_t state = seed * 2654435761u + 1;
  auto noise = [&state]() {
    state = state * 1664525u + 1013904223u;
    return static_cast<int>((state >> 24) % 41) - 20;
  };
  for (int y = 0; y < height; ++y) {
    for (int x = 0; x < width; ++x) {
      uint8_t* p = &im.rgba[(static_cast<size_t>(y) * width + x) * 4];
      const int dx = x - width / 3, dy = y - height / 2;
      const bool disc = dx * dx + dy * dy < (height / 4) * (height / 4);
      const int texture = ((x / 3 + y / 5) % 7) * 9;
      int r = 255 * x / (width > 1 ? width - 1 : 1), g = 255 * y / (height > 1 ? height - 1 : 1);
      int b = disc ? 230 : (x + y) * 3 % 256;
      r += texture + noise();
      g += noise();
      b -= texture / 2;
      p[0] = static_cast<uint8_t>(r < 0 ? 0 : r > 255 ? 255 : r);
      p[1] = static_cast<uint8_t>(g < 0 ? 0 : g > 255 ? 255 : g);
      p[2] = static_cast<uint8_t>(b < 0 ? 0 : b > 255 ? 255 : b);
      const int a = y < height / 5 ? 0 : 255 * x / (width > 1 ? width - 1 : 1);
      p[3] = static_cast<uint8_t>(a);
    }
  }
  return im;
}

struct Recipe {
  const char* name;
  int width, height;
  bool alpha;
  void (*set)(WebPConfig&);
};

const Recipe kRecipes[] = {
    {"simple_filter", 67, 45, false, [](WebPConfig& c) { c.filter_type = 0; c.filter_strength = 70; }},
    {"strong_sharpness7", 67, 45, false, [](WebPConfig& c) { c.filter_type = 1; c.filter_sharpness = 7; c.filter_strength = 80; }},
    {"simple_sharpness3", 67, 45, false, [](WebPConfig& c) { c.filter_type = 0; c.filter_sharpness = 3; c.filter_strength = 50; }},
    {"filter_strength0", 67, 45, false, [](WebPConfig& c) { c.filter_strength = 0; }},
    {"filter_strength100", 67, 45, false, [](WebPConfig& c) { c.filter_strength = 100; c.filter_type = 1; }},
    {"segments1", 67, 45, false, [](WebPConfig& c) { c.segments = 1; }},
    {"segments4_sns100", 67, 45, false, [](WebPConfig& c) { c.segments = 4; c.sns_strength = 100; }},
    {"partitions2", 96, 136, false, [](WebPConfig& c) { c.partitions = 1; c.method = 2; }},
    {"partitions4", 96, 136, false, [](WebPConfig& c) { c.partitions = 2; c.method = 2; }},
    {"partitions8", 96, 136, false, [](WebPConfig& c) { c.partitions = 3; c.method = 0; c.filter_type = 0; }},
    {"alpha_raw", 67, 45, true, [](WebPConfig& c) { c.alpha_compression = 0; }},
    {"alpha_raw_filter_best", 67, 45, true, [](WebPConfig& c) { c.alpha_compression = 0; c.alpha_filtering = 2; }},
    {"alpha_lossless_nofilter", 67, 45, true, [](WebPConfig& c) { c.alpha_filtering = 0; }},
    {"alpha_lossless_filter_best", 67, 45, true, [](WebPConfig& c) { c.alpha_filtering = 2; c.alpha_quality = 60; }},
};

}  // namespace

int main(int argc, char** argv) {
  if (argc != 2) {
    std::fprintf(stderr, "usage: %s OUTPUT_DIR\n", argv[0]);
    return 2;
  }
  for (const Recipe& r : kRecipes) {
    const Image im = draw(r.width, r.height, static_cast<uint32_t>(r.width * 131 + r.height));
    WebPConfig config;
    WebPPicture pic;
    if (!WebPConfigInit(&config) || !WebPPictureInit(&pic)) return 1;
    config.quality = 70;
    config.method = 4;
    r.set(config);
    if (!WebPValidateConfig(&config)) {
      std::fprintf(stderr, "%s: invalid configuration\n", r.name);
      return 1;
    }
    pic.width = r.width;
    pic.height = r.height;
    pic.use_argb = 0;
    const bool ok = r.alpha ? WebPPictureImportRGBA(&pic, im.rgba.data(), r.width * 4)
                            : WebPPictureImportRGBX(&pic, im.rgba.data(), r.width * 4);
    if (!ok) return 1;
    WebPMemoryWriter writer;
    WebPMemoryWriterInit(&writer);
    pic.writer = WebPMemoryWrite;
    pic.custom_ptr = &writer;
    if (!WebPEncode(&config, &pic)) {
      std::fprintf(stderr, "%s: encode failed (%d)\n", r.name, pic.error_code);
      return 1;
    }
    const std::string path = std::string(argv[1]) + "/webp_recipe_" + r.name + "_" + std::to_string(r.width) + "x" +
                             std::to_string(r.height) + ".webp";
    FILE* f = std::fopen(path.c_str(), "wb");
    if (!f || std::fwrite(writer.mem, 1, writer.size, f) != writer.size) return 1;
    std::fclose(f);
    std::printf("%s: %zu bytes\n", path.c_str(), writer.size);
    WebPMemoryWriterClear(&writer);
    WebPPictureFree(&pic);
  }
  return 0;
}

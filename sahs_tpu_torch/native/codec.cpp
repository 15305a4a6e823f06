// The parse-map palette codec of the data path, host C++ loaded with ctypes
// (the port's own copy of sahs_tpu/native/codec.cpp; native/__init__.py
// builds it). Per pixel, an exact match of the BGR-read pixel against the
// 12-class RGB palette (reference nerf-pytorch/nerf/utils.py:27-66 and
// nerface_dataloader.py:180-183): one pass, where the numpy version
// (data/common.palette_labels) builds an (H*W, 12, 3) comparison.
//
// The interface is plain C.

#include <cstdint>
#include <cstring>

namespace {

// RGB palette (reference utils.py:29-45); pixels on disk are BGR-matched.
constexpr uint8_t kPalette[12][3] = {
    {0, 0, 0},       {204, 0, 0},    {76, 153, 0},  {204, 204, 0},
    {51, 51, 255},   {0, 255, 255},  {102, 51, 0},  {102, 204, 0},
    {255, 255, 0},   {0, 0, 204},    {255, 153, 51}, {0, 204, 0},
};

inline uint32_t pack(uint8_t r, uint8_t g, uint8_t b) {
  return (uint32_t(r) << 16) | (uint32_t(g) << 8) | uint32_t(b);
}

}  // namespace

extern "C" {

// bgr: (n, 3) uint8 pixels as cv2 reads them (the files store the palette's
// values in BGR byte order, the reference's quirk); labels: (n,) uint8 out,
// the first palette entry a pixel equals, 0 for a pixel that equals none.
void palette_to_labels(const uint8_t* bgr, int64_t n, uint8_t* labels) {
  uint32_t keys[12];
  for (int c = 0; c < 12; ++c) keys[c] = pack(kPalette[c][0], kPalette[c][1], kPalette[c][2]);
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = bgr + 3 * i;
    const uint32_t k = pack(p[0], p[1], p[2]);
    uint8_t label = 0;
    for (int c = 0; c < 12; ++c) {
      if (k == keys[c]) {
        label = static_cast<uint8_t>(c);
        break;
      }
    }
    labels[i] = label;
  }
}

// labels: (n,) uint8 -> onehot: (n, 12) float32.
void labels_to_onehot(const uint8_t* labels, int64_t n, float* onehot) {
  std::memset(onehot, 0, sizeof(float) * n * 12);
  for (int64_t i = 0; i < n; ++i) onehot[i * 12 + labels[i]] = 1.0f;
}

// labels: (n,) uint8 -> (n, 3) uint8 colours, the palette reversed per
// pixel (label2color's BGR order, reference utils.py:138).
void labels_to_colors_bgr(const uint8_t* labels, int64_t n, uint8_t* bgr) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* c = kPalette[labels[i]];
    bgr[3 * i + 0] = c[2];
    bgr[3 * i + 1] = c[1];
    bgr[3 * i + 2] = c[0];
  }
}

}  // extern "C"

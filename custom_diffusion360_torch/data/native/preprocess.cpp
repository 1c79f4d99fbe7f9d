// Native host-side image preprocessing for the data pipeline.
//
// The reference's loader leans on torchvision/PIL native code for its hot
// per-item work (bicubic resize, crops, mask dilation — data_co3d.py:332-352,
// 470-471). This library provides the same primitives as a dependency-free
// C++ shared object (built with g++ at first use by wrapper.py), consumed
// through ctypes with a numpy fallback when unavailable.
//
// All functions operate on contiguous row-major buffers, parallelized over
// rows with std::thread.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

inline float cubic_kernel(float x) {
  // Catmull-Rom (a = -0.5), the convention PIL/torchvision use for bicubic
  const float a = -0.5f;
  x = std::fabs(x);
  if (x < 1.0f) return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  if (x < 2.0f) return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
  return 0.0f;
}

struct Weights {
  std::vector<int> lo;          // first source index per output position
  std::vector<int> len;         // taps per output position
  std::vector<float> w;         // flattened weights
  int max_len;
};

// PIL-style antialiased resampling weights (support scales by the
// downsampling factor, weights normalized).
Weights build_weights(int in_size, int out_size) {
  Weights out;
  out.lo.resize(out_size);
  out.len.resize(out_size);
  const float scale = static_cast<float>(in_size) / out_size;
  const float filterscale = std::max(scale, 1.0f);
  const float support = 2.0f * filterscale;
  out.max_len = static_cast<int>(std::ceil(support)) * 2 + 1;
  out.w.assign(static_cast<size_t>(out_size) * out.max_len, 0.0f);
  for (int i = 0; i < out_size; ++i) {
    const float center = (i + 0.5f) * scale;
    int lo = std::max(0, static_cast<int>(center - support + 0.5f));
    int hi = std::min(in_size, static_cast<int>(center + support + 0.5f));
    float total = 0.0f;
    for (int j = lo; j < hi; ++j) {
      float ww = cubic_kernel((j + 0.5f - center) / filterscale);
      out.w[static_cast<size_t>(i) * out.max_len + (j - lo)] = ww;
      total += ww;
    }
    if (total != 0.0f) {
      for (int j = 0; j < hi - lo; ++j)
        out.w[static_cast<size_t>(i) * out.max_len + j] /= total;
    }
    out.lo[i] = lo;
    out.len[i] = hi - lo;
  }
  return out;
}

void parallel_rows(int rows, const std::function<void(int, int)>& fn) {
  unsigned n = std::max(1u, std::min(std::thread::hardware_concurrency(), 16u));
  if (rows < 64) n = 1;
  std::vector<std::thread> ts;
  int chunk = (rows + n - 1) / n;
  for (unsigned t = 0; t < n; ++t) {
    int r0 = t * chunk;
    int r1 = std::min(rows, r0 + chunk);
    if (r0 >= r1) break;
    ts.emplace_back(fn, r0, r1);
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Antialiased bicubic resize, u8 HWC -> f32 HWC scaled to [-1, 1]
// (torchvision Resize(BICUBIC) + ToTensor + *2-1, data_co3d.py:332-338).
void resize_bicubic_u8_to_pm1(const uint8_t* src, int in_h, int in_w, int ch,
                              float* dst, int out_h, int out_w) {
  Weights wx = build_weights(in_w, out_w);
  Weights wy = build_weights(in_h, out_h);

  // horizontal pass: (in_h, out_w, ch) f32
  std::vector<float> tmp(static_cast<size_t>(in_h) * out_w * ch);
  parallel_rows(in_h, [&](int r0, int r1) {
    for (int y = r0; y < r1; ++y) {
      const uint8_t* row = src + static_cast<size_t>(y) * in_w * ch;
      float* trow = tmp.data() + static_cast<size_t>(y) * out_w * ch;
      for (int x = 0; x < out_w; ++x) {
        const float* w = wx.w.data() + static_cast<size_t>(x) * wx.max_len;
        for (int c = 0; c < ch; ++c) {
          float acc = 0.0f;
          for (int k = 0; k < wx.len[x]; ++k)
            acc += w[k] * row[(wx.lo[x] + k) * ch + c];
          trow[x * ch + c] = acc;
        }
      }
    }
  });

  // vertical pass + normalize
  parallel_rows(out_h, [&](int r0, int r1) {
    for (int y = r0; y < r1; ++y) {
      const float* w = wy.w.data() + static_cast<size_t>(y) * wy.max_len;
      float* drow = dst + static_cast<size_t>(y) * out_w * ch;
      for (int x = 0; x < out_w; ++x) {
        for (int c = 0; c < ch; ++c) {
          float acc = 0.0f;
          for (int k = 0; k < wy.len[y]; ++k)
            acc += w[k] *
                   tmp[(static_cast<size_t>(wy.lo[y] + k) * out_w + x) * ch + c];
          float v = acc / 255.0f * 2.0f - 1.0f;
          drow[x * ch + c] = std::min(1.0f, std::max(-1.0f, v));
        }
      }
    }
  });
}

// 7x7 binary dilation with 'same' zero padding (data_co3d.py:470-471).
void dilate7_f32(const float* src, int h, int w, float* dst) {
  // horizontal max then vertical max (separable)
  std::vector<float> tmp(static_cast<size_t>(h) * w);
  parallel_rows(h, [&](int r0, int r1) {
    for (int y = r0; y < r1; ++y) {
      const float* row = src + static_cast<size_t>(y) * w;
      float* trow = tmp.data() + static_cast<size_t>(y) * w;
      for (int x = 0; x < w; ++x) {
        float m = 0.0f;
        int lo = std::max(0, x - 3), hi = std::min(w - 1, x + 3);
        for (int k = lo; k <= hi; ++k) m = std::max(m, row[k]);
        trow[x] = m;
      }
    }
  });
  parallel_rows(h, [&](int r0, int r1) {
    for (int y = r0; y < r1; ++y) {
      float* drow = dst + static_cast<size_t>(y) * w;
      int lo = std::max(0, y - 3), hi = std::min(h - 1, y + 3);
      for (int x = 0; x < w; ++x) {
        float m = 0.0f;
        for (int k = lo; k <= hi; ++k)
          m = std::max(m, tmp[static_cast<size_t>(k) * w + x]);
        drow[x] = std::min(1.0f, m);
      }
    }
  });
}

// Crop (with zero padding outside bounds) from u8 HWC into u8 HWC.
void crop_u8(const uint8_t* src, int h, int w, int ch, int x0, int y0,
             int out_h, int out_w, uint8_t* dst) {
  std::memset(dst, 0, static_cast<size_t>(out_h) * out_w * ch);
  parallel_rows(out_h, [&](int r0, int r1) {
    for (int y = r0; y < r1; ++y) {
      int sy = y + y0;
      if (sy < 0 || sy >= h) continue;
      int sx0 = std::max(0, x0);
      int sx1 = std::min(w, x0 + out_w);
      if (sx0 >= sx1) continue;
      std::memcpy(dst + (static_cast<size_t>(y) * out_w + (sx0 - x0)) * ch,
                  src + (static_cast<size_t>(sy) * w + sx0) * ch,
                  static_cast<size_t>(sx1 - sx0) * ch);
    }
  });
}

}  // extern "C"

// Native host-side preprocessing core for the CT data pipeline.
//
// The reference's input layer runs inside torch/MONAI C++ kernels via 12
// DataLoader workers (train3D.py:184-187). This library supplies the
// equivalent native hot paths for our loader: HU windowing/normalisation,
// strided volume crops, and foreground-biased crop-centre sampling
// (RandCropByPosNegLabeld's core, dataset/CT_pancreas_ids.py:114-121).
//
// Exposed as a plain C ABI consumed through ctypes (no pybind11 in the
// image). All functions are thread-safe and GIL-free by construction.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

// Clip to [low, high] then standardise: x = (clip(x) - mean) / std.
// In-place over n float32 values. Mirrors CT_pancreas_ids.py:150-152.
void hu_window_normalize(float* data, int64_t n, float low, float high,
                         float mean, float inv_std) {
  for (int64_t i = 0; i < n; ++i) {
    float v = data[i];
    v = v < low ? low : (v > high ? high : v);
    data[i] = (v - mean) * inv_std;
  }
}

// MONAI ScaleIntensityRanged (CT_pancreas_monai.py:41-46).
void scale_intensity_range(float* data, int64_t n, float a_min, float a_max,
                           float b_min, float b_max, int clip) {
  const float scale = (b_max - b_min) / (a_max - a_min);
  const float lo = b_min < b_max ? b_min : b_max;
  const float hi = b_min < b_max ? b_max : b_min;
  for (int64_t i = 0; i < n; ++i) {
    float v = (data[i] - a_min) * scale + b_min;
    if (clip) v = v < lo ? lo : (v > hi ? hi : v);
    data[i] = v;
  }
}

// Copy a (sh, sw, sd) crop starting at (x, y, z) out of a (H, W, D) volume.
// Row-contiguous memcpy over the D axis.
void crop3d_f32(const float* src, int64_t H, int64_t W, int64_t D,
                int64_t x, int64_t y, int64_t z,
                int64_t sh, int64_t sw, int64_t sd, float* dst) {
  for (int64_t i = 0; i < sh; ++i) {
    for (int64_t j = 0; j < sw; ++j) {
      const float* s = src + ((x + i) * W + (y + j)) * D + z;
      float* d = dst + (i * sw + j) * sd;
      std::memcpy(d, s, sizeof(float) * sd);
    }
  }
}

void crop3d_u8(const uint8_t* src, int64_t H, int64_t W, int64_t D,
               int64_t x, int64_t y, int64_t z,
               int64_t sh, int64_t sw, int64_t sd, uint8_t* dst) {
  for (int64_t i = 0; i < sh; ++i) {
    for (int64_t j = 0; j < sw; ++j) {
      const uint8_t* s = src + ((x + i) * W + (y + j)) * D + z;
      uint8_t* d = dst + (i * sw + j) * sd;
      std::memcpy(d, s, sizeof(uint8_t) * sd);
    }
  }
}

// Foreground-biased crop-centre sampling (RandCropByPosNegLabeld core).
// label: (H, W, D) uint8; writes n_samples (x, y, z) centres, each drawn
// from foreground voxels with probability pos/(pos+neg), else background,
// clamped so a (sh, sw, sd) crop fits. Returns 0 on success.
int sample_crop_centers(const uint8_t* label, int64_t H, int64_t W, int64_t D,
                        int64_t sh, int64_t sw, int64_t sd,
                        double pos, double neg, int64_t n_samples,
                        uint64_t seed, int64_t* centers_out) {
  std::vector<int64_t> fg;
  fg.reserve(4096);
  const int64_t n = H * W * D;
  for (int64_t i = 0; i < n; ++i) {
    if (label[i] > 0) fg.push_back(i);
  }
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  const double p_pos = pos / (pos + neg);

  for (int64_t s = 0; s < n_samples; ++s) {
    int64_t flat;
    const bool use_fg = !fg.empty() && unif(rng) < p_pos;
    if (use_fg) {
      flat = fg[std::uniform_int_distribution<int64_t>(
          0, static_cast<int64_t>(fg.size()) - 1)(rng)];
    } else {
      // rejection-free: any voxel; bias to background by resampling a few
      // times if it lands on foreground (background dominates CT volumes).
      flat = std::uniform_int_distribution<int64_t>(0, n - 1)(rng);
      for (int tries = 0; tries < 4 && label[flat] > 0; ++tries) {
        flat = std::uniform_int_distribution<int64_t>(0, n - 1)(rng);
      }
    }
    int64_t x = flat / (W * D);
    int64_t y = (flat / D) % W;
    int64_t z = flat % D;
    x = std::min(std::max<int64_t>(x - sh / 2, 0), std::max<int64_t>(H - sh, 0));
    y = std::min(std::max<int64_t>(y - sw / 2, 0), std::max<int64_t>(W - sw, 0));
    z = std::min(std::max<int64_t>(z - sd / 2, 0), std::max<int64_t>(D - sd, 0));
    centers_out[s * 3 + 0] = x;
    centers_out[s * 3 + 1] = y;
    centers_out[s * 3 + 2] = z;
  }
  return 0;
}

}  // extern "C"

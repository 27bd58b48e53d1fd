// Device helpers shared by the origVal samplers: kernel B1
// (sample_image.cu) and kernel B4 (sample_tiled.cu). They mirror the plain
// versions' helpers in kernels/sample_image.py tap for tap.

#pragma once

#include <cuda_runtime.h>

namespace mm_sampler {

enum { INTERP_NEAREST = 0, INTERP_BILINEAR = 1, INTERP_BICUBIC = 2 };
enum { EDGE_COLOR = 0, EDGE_WRAP = 1, EDGE_REFLECT = 2 };

// floor() result -> int: clamped into int32 range first (2147483520 is the
// largest float below 2^31), so a non-finite or huge coordinate gives an
// index the edge behaviour can map. fmaxf/fminf return the non-NaN operand,
// so NaN goes to the low end.
__device__ __forceinline__ int to_index(float f) {
  return static_cast<int>(fminf(fmaxf(f, -2147483520.0f), 2147483520.0f));
}

// i mod n with the sign of n. Most indices are already in [0, n): they
// skip the integer division (tens of instructions on the card).
__device__ __forceinline__ int floored_mod(int i, int n) {
  if (static_cast<unsigned>(i) < static_cast<unsigned>(n)) return i;
  const int m = i % n;
  return m < 0 ? m + n : m;
}

// Valid index in [0, n); clears `inside` when the color edge substitutes.
__device__ __forceinline__ int edge_index(int i, int n, int mode,
                                          bool& inside) {
  if (mode == EDGE_WRAP) return floored_mod(i, n);
  if (mode == EDGE_REFLECT) {
    const int j = floored_mod(i, 2 * n);
    return j < n ? j : 2 * n - 1 - j;
  }
  inside = inside && i >= 0 && i < n;
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float f) {
  return make_float4(a.x + f * (b.x - a.x), a.y + f * (b.y - a.y),
                     a.z + f * (b.z - a.z), a.w + f * (b.w - a.w));
}

__device__ __forceinline__ float4 scale4(float4 a, float f) {
  return make_float4(f * a.x, f * a.y, f * a.z, f * a.w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Catmull-Rom weights of kernels/sample_image.py::_catmull_rom_weights, same
// order.
__device__ __forceinline__ void catmull_rom(float f, float w[4]) {
  const float f2 = f * f;
  const float f3 = f2 * f;
  w[0] = -0.5f * f3 + f2 - 0.5f * f;
  w[1] = 1.5f * f3 - 2.5f * f2 + 1.0f;
  w[2] = -1.5f * f3 + 2.0f * f2 + 0.5f * f;
  w[3] = 0.5f * f3 - 0.5f * f2;
}

// Integer taps per axis: 1 (nearest), 2 (bilinear) or 4 (bicubic).
template <int INTERP>
constexpr int kTaps = INTERP == INTERP_NEAREST    ? 1
                      : INTERP == INTERP_BILINEAR ? 2
                                                  : 4;

// The first integer tap along one axis at continuous pixel-centre
// coordinate p (the taps are first, first + 1, ..., first + kTaps - 1),
// and the fraction `f` of p past floor(p) (0 for nearest).
template <int INTERP>
__device__ __forceinline__ int first_tap(float p, float& f) {
  if (INTERP == INTERP_NEAREST) {
    f = 0.0f;
    return to_index(floorf(p + 0.5f));
  }
  const float p0 = floorf(p);
  f = p - p0;
  return to_index(p0) - (INTERP == INTERP_BICUBIC ? 1 : 0);
}

// Nearest, bilinear or 4x4 Catmull-Rom bicubic of the taps `tap(dx, dy)`,
// dx, dy in [0, kTaps) counted from the first tap of each axis, at the
// fractions (fx, fy), in the plain version's order of operations.
template <int INTERP, typename Tap>
__device__ __forceinline__ float4 blend(float fx, float fy, const Tap& tap) {
  if (INTERP == INTERP_NEAREST) return tap(0, 0);
  if (INTERP == INTERP_BILINEAR) {
    const float4 top = lerp4(tap(0, 0), tap(1, 0), fx);
    const float4 bot = lerp4(tap(0, 1), tap(1, 1), fx);
    return lerp4(top, bot, fy);
  }
  float wx[4], wy[4];
  catmull_rom(fx, wx);
  catmull_rom(fy, wy);
  float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int dy = 0; dy < 4; ++dy) {
    float4 row = scale4(tap(0, dy), wx[0]);
#pragma unroll
    for (int dx = 1; dx < 4; ++dx) {
      row = add4(row, scale4(tap(dx, dy), wx[dx]));
    }
    c = dy == 0 ? scale4(row, wy[0]) : add4(c, scale4(row, wy[dy]));
  }
  return c;
}

// Nearest, bilinear or bicubic at continuous pixel-centre coordinates
// (px, py). `tap(ix, iy)` gives the float4 texel of one integer tap with
// the edge behaviour applied.
template <int INTERP, typename Tap>
__device__ __forceinline__ float4 interpolate(float px, float py,
                                              const Tap& tap) {
  float fx, fy;
  const int x0 = first_tap<INTERP>(px, fx);
  const int y0 = first_tap<INTERP>(py, fy);
  return blend<INTERP>(fx, fy,
                       [&](int dx, int dy) { return tap(x0 + dx, y0 + dy); });
}

}  // namespace mm_sampler

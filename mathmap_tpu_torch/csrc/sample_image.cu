// Kernel B1: the origVal sampler for Hopper (sm_90a).
//
// Replaces mathmap_tpu/pallas_kernels/sample_kernel.py::sample_image_pallas.
// The semantics are those of the plain sampler,
// mathmap_tpu_torch/kernels/sample_image.py::sample_image_reference (the port
// of the reference's runtime/sampling._sample_xla): world coordinates go to
// pixel centres, each integer tap is edge-mapped (wrap = floored mod,
// reflect = mirror with period 2n, color = clamp plus an inside mask that
// substitutes edge_color), and RGBA is interpolated: nearest, bilinear, or
// 4x4 Catmull-Rom bicubic, all in fp32 and in the plain version's order of
// operations.
//
// What bounds it on the card: memory. Per output pixel it reads 8 B of
// coordinates and writes 16 B of output, plus 1-16 taps of 16 B (float32
// source) or 4 B (uint8 source); for smooth warps neighbouring threads read
// neighbouring texels, so most taps hit L1/L2. The design answers that with
// one thread per output pixel in a 2-D grid (coalesced coordinate loads and
// planar output stores), one 16-byte float4 or 4-byte uchar4 load per tap
// through the read-only path, and no load at all for taps the color edge
// replaces. It is a simple direct gather: staging source tiles in shared
// memory, or texture/L2-friendly block shapes, is later work.
//
// Non-finite coordinates: floor() results are clamped into int32 range
// before conversion (NaN goes to the low end), so no tap ever reads out of
// bounds. Under the color edge such a tap is outside and yields edge_color;
// under wrap/reflect its index is folded into the image like any other.
//
// C interface (loaded with ctypes by kernels/sample_image.py): launches on
// the given stream, never synchronises, returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

enum { INTERP_NEAREST = 0, INTERP_BILINEAR = 1, INTERP_BICUBIC = 2 };
enum { EDGE_COLOR = 0, EDGE_WRAP = 1, EDGE_REFLECT = 2 };

// Largest float below 2^31. fmaxf/fminf return the non-NaN operand.
__device__ __forceinline__ int to_index(float f) {
  return static_cast<int>(fminf(fmaxf(f, -2147483520.0f), 2147483520.0f));
}

__device__ __forceinline__ int floored_mod(int i, int n) {
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

__device__ __forceinline__ float4 load_texel(const float4* src, int idx) {
  return __ldg(src + idx);
}

// u8 taps convert by IEEE division (nvcc's default -prec-div=true), the
// same values as the plain version's u8 -> float32 / 255.
__device__ __forceinline__ float4 load_texel(const uchar4* src, int idx) {
  const uchar4 u = __ldg(src + idx);
  return make_float4(static_cast<float>(u.x) / 255.0f,
                     static_cast<float>(u.y) / 255.0f,
                     static_cast<float>(u.z) / 255.0f,
                     static_cast<float>(u.w) / 255.0f);
}

struct Source {
  int hi, wi, edge_x, edge_y;
  float4 edge_color;
};

template <typename T>
__device__ __forceinline__ float4 tap(const T* __restrict__ src,
                                      const Source& s, int ix, int iy) {
  bool inside = true;
  const int jx = edge_index(ix, s.wi, s.edge_x, inside);
  const int jy = edge_index(iy, s.hi, s.edge_y, inside);
  if (!inside) return s.edge_color;
  return load_texel(src, jy * s.wi + jx);
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

template <typename T, int INTERP>
__global__ void sample_image_kernel(const T* __restrict__ src, Source s,
                                    const float* __restrict__ xs,
                                    const float* __restrict__ ys,
                                    float* __restrict__ out, int h, int w) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= h || j >= w) return;
  const long long p = static_cast<long long>(i) * w + j;
  const long long plane = static_cast<long long>(h) * w;

  // world_to_pixel: one f32 add each, so floor() agrees with the plain
  // version bit for bit
  const float px = xs[p] + (s.wi * 0.5f - 0.5f);
  const float py = (s.hi * 0.5f - 0.5f) - ys[p];

  float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (INTERP == INTERP_NEAREST) {
    c = tap(src, s, to_index(floorf(px + 0.5f)), to_index(floorf(py + 0.5f)));
  } else {
    const float x0f = floorf(px);
    const float y0f = floorf(py);
    const float fx = px - x0f;
    const float fy = py - y0f;
    const int x0 = to_index(x0f);
    const int y0 = to_index(y0f);
    if (INTERP == INTERP_BILINEAR) {
      const float4 top = lerp4(tap(src, s, x0, y0), tap(src, s, x0 + 1, y0), fx);
      const float4 bot =
          lerp4(tap(src, s, x0, y0 + 1), tap(src, s, x0 + 1, y0 + 1), fx);
      c = lerp4(top, bot, fy);
    } else {
      float wx[4], wy[4];
      catmull_rom(fx, wx);
      catmull_rom(fy, wy);
#pragma unroll
      for (int dy = 0; dy < 4; ++dy) {
        float4 row = scale4(tap(src, s, x0 - 1, y0 + dy - 1), wx[0]);
#pragma unroll
        for (int dx = 1; dx < 4; ++dx) {
          row = add4(row, scale4(tap(src, s, x0 + dx - 1, y0 + dy - 1), wx[dx]));
        }
        c = dy == 0 ? scale4(row, wy[0]) : add4(c, scale4(row, wy[dy]));
      }
    }
  }
  out[p] = c.x;
  out[plane + p] = c.y;
  out[2 * plane + p] = c.z;
  out[3 * plane + p] = c.w;
}

template <typename T>
cudaError_t launch(const void* pixels, Source s, const float* xs,
                   const float* ys, float* out, int h, int w, int interp,
                   cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  const T* src = static_cast<const T*>(pixels);
  switch (interp) {
    case INTERP_NEAREST:
      sample_image_kernel<T, INTERP_NEAREST>
          <<<grid, block, 0, stream>>>(src, s, xs, ys, out, h, w);
      break;
    case INTERP_BILINEAR:
      sample_image_kernel<T, INTERP_BILINEAR>
          <<<grid, block, 0, stream>>>(src, s, xs, ys, out, h, w);
      break;
    case INTERP_BICUBIC:
      sample_image_kernel<T, INTERP_BICUBIC>
          <<<grid, block, 0, stream>>>(src, s, xs, ys, out, h, w);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int mm_sample_image(const void* pixels, int src_u8, int hi, int wi,
                               const float* xs, const float* ys, float* out,
                               int h, int w, int interp, int edge_x,
                               int edge_y, float c0, float c1, float c2,
                               float c3, void* stream) {
  const Source s{hi, wi, edge_x, edge_y, make_float4(c0, c1, c2, c3)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      src_u8 ? launch<uchar4>(pixels, s, xs, ys, out, h, w, interp, st)
             : launch<float4>(pixels, s, xs, ys, out, h, w, interp, st);
  return static_cast<int>(err);
}

extern "C" const char* mm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

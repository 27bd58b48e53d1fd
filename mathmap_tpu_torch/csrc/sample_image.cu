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

#include "sampler_common.cuh"

namespace {

using namespace mm_sampler;

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
  const float4 c = interpolate<INTERP>(
      px, py, [&](int ix, int iy) { return tap(src, s, ix, iy); });
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

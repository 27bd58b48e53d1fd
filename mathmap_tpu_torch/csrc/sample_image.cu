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
// What bounds it on the card: bytes. Per output pixel it reads 8 B of
// coordinates and writes 16 B of output, each touched once; the taps
// (16 B of float32 or 4 B of uint8 source) mostly hit L1 and L2 for smooth
// warps, and a 4K uint8 source (33 MB) fits in the 50 MB L2. So the floor is
// the coordinates and the output. The design:
//
// - Exact uint8 taps without a division. A channel u becomes u / 255
//   correctly rounded in three operations: q = u * r with r = 1/255 rounded
//   to float, e = fma(-q, 255, u) (the exact residual), q = fma(e, r, q).
//   It gives the IEEE quotient for all 256 values (proved with rational
//   arithmetic in tests/test_torch_sampler_design.py, and bit for bit on the
//   card by chip_smoke.py's 256-value ramp). It was taken over a 256-entry
//   table in shared memory because it needs no shared memory, no barrier
//   and no bank traffic: three FP32 instructions per channel. The IEEE
//   division it replaces (nvcc's -prec-div=true: a reciprocal, Newton steps
//   and a slow-path branch, 4 per tap) made the uint8 path instruction-bound.
// - V = 4 horizontally adjacent pixels a thread for nearest and bilinear:
//   one 16-byte load each of x and y, one 16-byte store per output plane,
//   the index arithmetic once a thread, and up to 16 bilinear taps in
//   flight. Bicubic (16 taps a pixel) and any row width that is not a
//   multiple of 4, or coordinate or output pointer that is not 16-byte
//   aligned, take the V = 1 instantiation of the same template: the wrapper
//   chooses (kernels/sample_image.py::vector_width), and the C interface
//   refuses V = 4 where the wrapper would not choose it, so no V = 4
//   bicubic kernel is built. Bicubic at V = 4 measured slower (PERF.md).
// - Edge mapping per axis: a pixel maps its 1, 2 or 4 columns and rows once
//   (8 edge_index calls for bicubic instead of 32), then blends the taps
//   (sampler_common.cuh::blend, the order of operations B4 uses too). A tap
//   the color edge replaces loads nothing.
// - Cache policy: the taps go through the read-only path (__ldg), so the
//   reused source texels keep L1 and L2. The single-use coordinates and
//   output take the default operators: the streaming ones (__ldcs, __stcs)
//   measured slower on the H100 (PERF.md).
// - Launch: one kernel template, held to 40 registers a thread by
//   __launch_bounds__(256, 6) (6 blocks of 256 threads an SM), which
//   measured 4-7% faster for uint8 bilinear and for bicubic than ptxas's
//   own count (float32 bilinear pays 1.4%); thread blocks of 8x16 threads
//   at V = 4 (level with 16x16 on the renders' bilinear fields, ahead of
//   32x8) and 32x8 at V = 1 (PERF.md).
//
// Non-finite coordinates: floor() results are clamped into int32 range
// before conversion (NaN goes to the low end), so no tap ever reads out of
// bounds. Under the color edge such a tap is outside and yields edge_color;
// under wrap/reflect its index is folded into the image like any other.
//
// C interface (loaded with ctypes by kernels/sample_image.py): launches on
// the given stream, never synchronises, returns cudaGetLastError() or
// cudaErrorInvalidValue for arguments the kernel does not take.

#include <cuda_runtime.h>

#include <cstdint>

#include "sampler_common.cuh"

namespace {

using namespace mm_sampler;

// the launch bounds: threads a block, and blocks an SM must hold (the
// register cap: 65536 registers over 6 blocks of 256 threads)
constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 6;

// thread block (x, y) of the instantiation with V pixels a thread
template <int V>
constexpr int kBlockX = V == 4 ? 8 : 32;
template <int V>
constexpr int kBlockY = V == 4 ? 16 : 8;
static_assert(kBlockX<4> * kBlockY<4> <= kMaxThreads &&
              kBlockX<1> * kBlockY<1> <= kMaxThreads);

// 1/255 rounded to float32
constexpr float kInv255 = 0x1.010102p-8f;

// float(u) / 255.0f correctly rounded, for u in [0, 255]. Intrinsics, so
// that nvcc neither contracts nor reorders the three steps.
__device__ __forceinline__ float unit(unsigned char u) {
  const float a = static_cast<float>(u);
  const float q = __fmul_rn(a, kInv255);
  const float e = __fmaf_rn(-q, 255.0f, a);
  return __fmaf_rn(e, kInv255, q);
}

__device__ __forceinline__ float4 load_texel(const float4* src, int idx) {
  return __ldg(src + idx);
}

__device__ __forceinline__ float4 load_texel(const uchar4* src, int idx) {
  const uchar4 u = __ldg(src + idx);
  return make_float4(unit(u.x), unit(u.y), unit(u.z), unit(u.w));
}

struct Source {
  int hi, wi, edge_x, edge_y;
  float4 edge_color;
};

// One output pixel at world coordinates (x, y).
template <typename T, int INTERP>
__device__ __forceinline__ float4 sample_pixel(const T* __restrict__ src,
                                               const Source& s, float x,
                                               float y) {
  // world_to_pixel: one f32 add each, so floor() agrees with the plain
  // version bit for bit
  const float px = x + (s.wi * 0.5f - 0.5f);
  const float py = (s.hi * 0.5f - 0.5f) - y;
  float fx, fy;
  const int x0 = first_tap<INTERP>(px, fx);
  const int y0 = first_tap<INTERP>(py, fy);
  constexpr int N = kTaps<INTERP>;
  int col[N], row[N];
  bool in_x[N], in_y[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    in_x[k] = in_y[k] = true;
    col[k] = edge_index(x0 + k, s.wi, s.edge_x, in_x[k]);
    row[k] = edge_index(y0 + k, s.hi, s.edge_y, in_y[k]) * s.wi;
  }
  return blend<INTERP>(fx, fy, [&](int dx, int dy) {
    if (!(in_x[dx] && in_y[dy])) return s.edge_color;
    return load_texel(src, row[dy] + col[dx]);
  });
}

// V coordinates from p: one float4 load when V == 4.
template <int V>
__device__ __forceinline__ void load_coords(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

// V outputs to p: one float4 store when V == 4.
template <int V>
__device__ __forceinline__ void store_plane(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// Each thread samples V adjacent pixels of one row: (i, j .. j + V - 1).
template <typename T, int INTERP, int V>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    sample_image_kernel(const T* __restrict__ src, Source s,
                        const float* __restrict__ xs,
                        const float* __restrict__ ys, float* __restrict__ out,
                        int h, int w) {
  const int j = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= h || j >= w) return;
  const long long p = static_cast<long long>(i) * w + j;
  const long long plane = static_cast<long long>(h) * w;
  float x[V], y[V];
  load_coords<V>(xs + p, x);
  load_coords<V>(ys + p, y);
  float c[4][V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float4 t = sample_pixel<T, INTERP>(src, s, x[v], y[v]);
    c[0][v] = t.x;
    c[1][v] = t.y;
    c[2][v] = t.z;
    c[3][v] = t.w;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) store_plane<V>(out + k * plane + p, c[k]);
}

template <typename T, int INTERP, int V>
cudaError_t launch(const T* src, const Source& s, const float* xs,
                   const float* ys, float* out, int h, int w,
                   cudaStream_t stream) {
  const dim3 block(kBlockX<V>, kBlockY<V>);
  const unsigned vectors = (static_cast<unsigned>(w) + V - 1) / V;
  const dim3 grid((vectors + block.x - 1) / block.x,
                  (h + block.y - 1) / block.y);
  sample_image_kernel<T, INTERP, V>
      <<<grid, block, 0, stream>>>(src, s, xs, ys, out, h, w);
  return cudaGetLastError();
}

// The instantiation of `interp` with 4 pixels a thread (nearest and
// bilinear only) or 1.
template <typename T>
cudaError_t launch(const void* pixels, const Source& s, const float* xs,
                   const float* ys, float* out, int h, int w, int interp,
                   bool v4, cudaStream_t stream) {
  const T* src = static_cast<const T*>(pixels);
  switch (interp) {
    case INTERP_NEAREST:
      return v4 ? launch<T, INTERP_NEAREST, 4>(src, s, xs, ys, out, h, w, stream)
                : launch<T, INTERP_NEAREST, 1>(src, s, xs, ys, out, h, w, stream);
    case INTERP_BILINEAR:
      return v4 ? launch<T, INTERP_BILINEAR, 4>(src, s, xs, ys, out, h, w, stream)
                : launch<T, INTERP_BILINEAR, 1>(src, s, xs, ys, out, h, w, stream);
    case INTERP_BICUBIC:
      return launch<T, INTERP_BICUBIC, 1>(src, s, xs, ys, out, h, w, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

// vec: pixels a thread, 1 or 4; 4 takes nearest or bilinear on a width that
// divides by 4 with x, y and out 16-byte aligned.
extern "C" int mm_sample_image(const void* pixels, int src_u8, int hi, int wi,
                               const float* xs, const float* ys, float* out,
                               int h, int w, int vec, int interp, int edge_x,
                               int edge_y, float c0, float c1, float c2,
                               float c3, void* stream) {
  const bool v4 = vec == 4;
  if ((!v4 && vec != 1) ||
      (v4 && (interp == INTERP_BICUBIC || w % 4 || !aligned16(xs) ||
              !aligned16(ys) || !aligned16(out)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Source s{hi, wi, edge_x, edge_y, make_float4(c0, c1, c2, c3)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      src_u8 ? launch<uchar4>(pixels, s, xs, ys, out, h, w, interp, v4, st)
             : launch<float4>(pixels, s, xs, ys, out, h, w, interp, v4, st);
  return static_cast<int>(err);
}

extern "C" const char* mm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Kernel B5: a frame's finish for Hopper (sm_90a): scale, clamp and
// interleave four channel planes into RGBA, packed to uint8 or not.
//
// It replaces no TPU kernel: the JAX package leaves this step to XLA, which
// fuses it. It was added because the eager chain it takes the place of
// (runtime/render.py::render_frame: four `plane * inv`, `torch.stack` along
// the last axis, `torch.clamp`, and for uint8 output `pack_uint8`'s four
// more kernels) was the port's largest device op: the stack alone took 0.77
// ms of a 4K frame, about a tenth of the speed of the card's memory. The
// semantics are mathmap_tpu_torch/kernels/finish_rgba.py's
// finish_rgba_reference, per element and bit for bit in float32:
//
//   v = plane[c] * inv;  v = isnan(v) ? v : min(max(v, 0), 1)   (torch.clamp)
//   uint8: q = floor(v * 255 + 0.5);  out = (uint8)(int64)q     (torch's cast)
//
// each step one rounding (intrinsics, so nvcc contracts nothing into an FMA),
// NaN kept through the clamp as torch.clamp keeps it, and the uint8 cast
// through int64 as c10's static_cast_with_inter_type does it.
//
// What bounds it on the card: bytes. It reads four float32 planes once and
// writes the RGBA frame once: at 3840x2160 and float32 out 132.7 MB in and
// 132.7 MB out, 0.079 ms at the H100's 3.35 TB/s; uint8 out writes 33 MB.
// The design moves each byte once, in whole sectors:
//
// - A warp finishes 128 pixels of a row, each thread 4 of them, 32 apart:
//   every load instruction of a warp reads 128 contiguous bytes of a plane,
//   and every store writes 512 contiguous bytes of float32 RGBA (one
//   16-byte store a pixel) or 128 of uint8 (one 4-byte store a pixel). The
//   first version took 4 adjacent pixels a thread (one 16-byte load a
//   plane, four 16-byte pixel stores 64 bytes apart across the warp); its
//   stores half-filled each sector they touched and reached 65% of the
//   bound at 4K float32 out, 45% on moire's planes (PERF.md).
// - Each plane is read through its strides, so the evaluator's layouts
//   need no copy: contiguous (a sampler's or LUT's unbound output), stride
//   0 along the row (a column, or a constant channel: every lane of a warp
//   reads one address) or between rows (a row of the x grid), or any view.
//   A plane with both strides nonzero is read once: streaming loads
//   (__ldcs). A broadcast plane is reread by every row or pixel: the
//   read-only path (__ldg), so it stays cached. The frame is written once:
//   streaming stores (__stcs).
// - A 2-D grid, rows on blockIdx.y: no division by the width. The ragged
//   end of a row is masked per pixel.
// - An output whose pixels are not aligned to their store size (a view one
//   element into a buffer) takes the narrow instantiation, one store a
//   channel: the wrapper chooses (kernels/finish_rgba.py::wide_stores), and
//   the C interface refuses the wide one where the wrapper would not
//   choose it.
//
// Strides are in elements, each plane's (row, column) and the output's row
// (its pixel stride is 4 and its channel stride 1); offsets are 64-bit.
//
// C interface (loaded with ctypes by kernels/finish_rgba.py): launches on
// the given stream, never synchronises, returns cudaGetLastError() or
// cudaErrorInvalidValue for arguments the kernel does not take.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
// pixels a thread, kWarp apart
constexpr int kPixels = 4;
// warps (rows) a block
constexpr int kRows = 8;

struct Plane {
  const float* p;
  long long row, col;  // strides in elements
};

struct Planes {
  Plane c[4];
};

// torch.clamp(a * inv, 0, 1), NaN kept
__device__ __forceinline__ float finish(float a, float inv) {
  const float v = __fmul_rn(a, inv);
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// pack_uint8 of a finished value: floor(v * 255 + 0.5), cast through int64
__device__ __forceinline__ unsigned int pack(float v) {
  const float q = floorf(__fadd_rn(__fmul_rn(v, 255.0f), 0.5f));
  return static_cast<unsigned char>(static_cast<long long>(q));
}

// Each thread finishes pixels (y, x0 + kWarp * v), v < kPixels, of a row.
// WIDE: one store a pixel (16 bytes of float32, 4 of uint8), else one a
// channel.
template <bool U8, bool WIDE>
__global__ void __launch_bounds__(kWarp * kRows)
    finish_rgba_kernel(const Planes planes, void* __restrict__ out,
                       long long out_row, int h, int w, float inv) {
  const int y = blockIdx.y * kRows + threadIdx.y;
  if (y >= h) return;
  const int x0 = blockIdx.x * (kWarp * kPixels) + threadIdx.x;
  float c[4][kPixels];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const Plane pl = planes.c[k];
    const float* p = pl.p + y * pl.row;
    const bool once = pl.row != 0 && pl.col != 0;
#pragma unroll
    for (int v = 0; v < kPixels; ++v) {
      const int x = x0 + kWarp * v;
      const float* src = p + x * pl.col;
      c[k][v] = x >= w ? 0.0f : once ? __ldcs(src) : __ldg(src);
    }
  }
#pragma unroll
  for (int v = 0; v < kPixels; ++v) {
    const int x = x0 + kWarp * v;
    if (x >= w) break;
    const long long o = y * out_row + 4LL * x;
    if constexpr (U8) {
      const unsigned int px =
          pack(finish(c[0][v], inv)) | pack(finish(c[1][v], inv)) << 8 |
          pack(finish(c[2][v], inv)) << 16 | pack(finish(c[3][v], inv)) << 24;
      unsigned char* dst = static_cast<unsigned char*>(out) + o;
      if constexpr (WIDE) {
        __stcs(reinterpret_cast<unsigned int*>(dst), px);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          __stcs(dst + k, static_cast<unsigned char>(px >> (8 * k) & 0xff));
        }
      }
    } else {
      float* dst = static_cast<float*>(out) + o;
      const float4 px = make_float4(finish(c[0][v], inv), finish(c[1][v], inv),
                                    finish(c[2][v], inv), finish(c[3][v], inv));
      if constexpr (WIDE) {
        __stcs(reinterpret_cast<float4*>(dst), px);
      } else {
        __stcs(dst, px.x);
        __stcs(dst + 1, px.y);
        __stcs(dst + 2, px.z);
        __stcs(dst + 3, px.w);
      }
    }
  }
}

template <bool U8, bool WIDE>
cudaError_t launch(const Planes& planes, void* out, long long out_row, int h,
                   int w, float inv, cudaStream_t stream) {
  const dim3 block(kWarp, kRows);
  const unsigned span = kWarp * kPixels;
  const dim3 grid((static_cast<unsigned>(w) + span - 1) / span,
                  (h + kRows - 1) / kRows);
  finish_rgba_kernel<U8, WIDE>
      <<<grid, block, 0, stream>>>(planes, out, out_row, h, w, inv);
  return cudaGetLastError();
}

}  // namespace

// u8: out is uint8, else float32; out_row: the output's row stride in
// elements; wide: one store a pixel, which takes an output and rows aligned
// to a pixel's bytes (16 for float32, 4 for uint8).
extern "C" int mm_finish_rgba(const float* p0, long long r0, long long c0,
                              const float* p1, long long r1, long long c1,
                              const float* p2, long long r2, long long c2,
                              const float* p3, long long r3, long long c3,
                              void* out, long long out_row, int h, int w,
                              int u8, float inv, int wide, void* stream) {
  const Planes planes{{{p0, r0, c0}, {p1, r1, c1}, {p2, r2, c2}, {p3, r3, c3}}};
  const long long pixel = u8 ? 4 : 16;
  const long long row_bytes = out_row * (u8 ? 1 : 4);
  if (h <= 0 || w <= 0 ||
      (wide && (reinterpret_cast<std::uintptr_t>(out) % pixel || row_bytes % pixel))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (u8) {
    err = wide ? launch<true, true>(planes, out, out_row, h, w, inv, st)
               : launch<true, false>(planes, out, out_row, h, w, inv, st);
  } else {
    err = wide ? launch<false, true>(planes, out, out_row, h, w, inv, st)
               : launch<false, false>(planes, out, out_row, h, w, inv, st);
  }
  return static_cast<int>(err);
}

// Kernel B4: the origVal sampler of one tile of the input-sharded renderer,
// for Hopper (sm_90a).
//
// Replaces mathmap_tpu/runtime/sampling.py::_sample_pallas_tiled, which
// sends a halo-extended block through the TPU sampler with pre-mapped
// coordinates and "clamp" aprons on a padded copy. This kernel computes
// what the reference's exact gather route computes instead
// (runtime/sampling._sample_xla with value.TiledInput.make_gather), whose
// plain PyTorch version is
// mathmap_tpu_torch/kernels/sample_tiled.py::sample_tiled_reference:
//
//   1. world coordinates -> pixel centres of the GLOBAL frame (gh, gw);
//   2. each integer tap is edge-mapped globally (wrap, reflect, or color
//      with its inside mask), then localised to the block (l = j - base,
//      moved by one period only for a true wrap-seam overflow), clamped to
//      the block (the bounded-displacement contract's check=False
//      behaviour) and read as one float4, or replaced by edge_color;
//   3. nearest / bilinear / bicubic in fp32, the plain version's order.
//
// The violation excess (how far past the block the furthest tap reached,
// mod the global period: floored_mod(j - base, n) - (ext - 1)) is measured
// when `excess` is non-null, for EVERY tap, those the color edge replaces
// included (the reference measures the clamped index before substitution).
// Each block reduces its maximum (warp shuffles, then shared memory) and
// does at most one atomicMax: one atomic per warp on a single address would
// serialise some 65,000 of them per 4K tile.
//
// What bounds it on the card: memory. Per output pixel it reads 8 B of
// coordinates and writes 16 B of output; the block (16 B per texel) is read
// once when the warp is smooth, its taps mostly hitting L1/L2. One thread
// per output pixel in a 2-D grid, as B1: coalesced coordinate loads and
// planar stores, one 16-byte load per tap, none for a replaced tap. Blocks
// are float32: the tiled renderer converts u8 inputs before the halo
// exchange, as the reference does.
//
// C interface (loaded with ctypes by kernels/sample_tiled.py): launches on
// the given stream, never synchronises, returns cudaGetLastError().

#include <cuda_runtime.h>

#include "sampler_common.cuh"

namespace {

using namespace mm_sampler;

struct Block {
  int ext_h, ext_w;        // the block's rows and columns
  int gh, gw;              // the global frame
  int row_base, col_base;  // global row/col of local (0, 0)
  int col_sharded;         // 0: the block spans the full width
  int edge_x, edge_y;
  float4 edge_color;
};

// The reference's value.localize_period on one index.
__device__ __forceinline__ int localize(int g, int base, int n, int ext_n) {
  const int l0 = g - base;
  if (l0 < 0) return l0 + n;
  return (l0 >= ext_n && l0 >= n) ? l0 - n : l0;
}

template <bool CHECK>
__device__ __forceinline__ float4 tiled_tap(const float4* __restrict__ src,
                                            const Block& b, int ix, int iy,
                                            int& excess) {
  bool inside = true;
  const int jx = edge_index(ix, b.gw, b.edge_x, inside);
  const int jy = edge_index(iy, b.gh, b.edge_y, inside);
  const int ly =
      min(max(localize(jy, b.row_base, b.gh, b.ext_h), 0), b.ext_h - 1);
  int lx = jx;
  if (b.col_sharded) {
    lx = min(max(localize(jx, b.col_base, b.gw, b.ext_w), 0), b.ext_w - 1);
  }
  if (CHECK) {
    excess = max(excess, floored_mod(jy - b.row_base, b.gh) - (b.ext_h - 1));
    if (b.col_sharded) {
      excess =
          max(excess, floored_mod(jx - b.col_base, b.gw) - (b.ext_w - 1));
    }
  }
  if (!inside) return b.edge_color;
  return __ldg(src + ly * b.ext_w + lx);
}

// the excess of a tile no tap reached (the reference's initial value)
constexpr int kNoExcess = -(1 << 30);
// the thread block is (32, kRows): one warp per row
constexpr int kRows = 8;

template <int INTERP, bool CHECK>
__global__ void sample_tiled_kernel(const float4* __restrict__ src, Block b,
                                    const float* __restrict__ xs,
                                    const float* __restrict__ ys,
                                    float* __restrict__ out, int h, int w,
                                    int* __restrict__ excess_out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  int excess = kNoExcess;
  if (i < h && j < w) {
    const long long p = static_cast<long long>(i) * w + j;
    const long long plane = static_cast<long long>(h) * w;
    // world_to_pixel on the GLOBAL size: one f32 add each, as the plain
    // version
    const float px = xs[p] + (b.gw * 0.5f - 0.5f);
    const float py = (b.gh * 0.5f - 0.5f) - ys[p];
    const float4 c = interpolate<INTERP>(px, py, [&](int ix, int iy) {
      return tiled_tap<CHECK>(src, b, ix, iy, excess);
    });
    out[p] = c.x;
    out[plane + p] = c.y;
    out[2 * plane + p] = c.z;
    out[3 * plane + p] = c.w;
  }
  if (CHECK) {
    // every thread of the block gets here (out-of-range ones with
    // kNoExcess). A warp is one row of the (32, kRows) block: each warp
    // reduces with one instruction, then thread (0, 0) takes the block's
    // maximum and does one atomic, skipped when the running maximum is
    // already as large (most blocks, once the first have landed)
    __shared__ int warp_max[kRows];
    const int m = __reduce_max_sync(0xffffffffu, excess);
    if (threadIdx.x == 0) warp_max[threadIdx.y] = m;
    __syncthreads();
    if (threadIdx.x == 0 && threadIdx.y == 0) {
      int block_max = warp_max[0];
#pragma unroll
      for (int k = 1; k < kRows; ++k) block_max = max(block_max, warp_max[k]);
      if (block_max > kNoExcess &&
          block_max > *static_cast<volatile int*>(excess_out)) {
        atomicMax(excess_out, block_max);
      }
    }
  }
}

template <int INTERP>
void launch_interp(const float4* src, const Block& b, const float* xs,
                   const float* ys, float* out, int h, int w, int* excess,
                   dim3 grid, dim3 block, cudaStream_t stream) {
  if (excess) {
    sample_tiled_kernel<INTERP, true>
        <<<grid, block, 0, stream>>>(src, b, xs, ys, out, h, w, excess);
  } else {
    sample_tiled_kernel<INTERP, false>
        <<<grid, block, 0, stream>>>(src, b, xs, ys, out, h, w, excess);
  }
}

}  // namespace

extern "C" int mm_sample_tiled(const void* ext, int ext_h, int ext_w, int gh,
                               int gw, int row_base, int col_base,
                               int col_sharded, const float* xs,
                               const float* ys, float* out, int h, int w,
                               int interp, int edge_x, int edge_y, float c0,
                               float c1, float c2, float c3, int* excess,
                               void* stream) {
  const Block b{ext_h,    ext_w,       gh,     gw,     row_base,
                col_base, col_sharded, edge_x, edge_y,
                make_float4(c0, c1, c2, c3)};
  const float4* src = static_cast<const float4*>(ext);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(32, kRows);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  switch (interp) {
    case INTERP_NEAREST:
      launch_interp<INTERP_NEAREST>(src, b, xs, ys, out, h, w, excess, grid,
                                    block, st);
      break;
    case INTERP_BILINEAR:
      launch_interp<INTERP_BILINEAR>(src, b, xs, ys, out, h, w, excess, grid,
                                     block, st);
      break;
    case INTERP_BICUBIC:
      launch_interp<INTERP_BICUBIC>(src, b, xs, ys, out, h, w, excess, grid,
                                    block, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel B6: Ken Perlin's improved noise (2002) for Hopper (sm_90a), one
// pass over memory for a `noise` call.
//
// It replaces no TPU kernel: the JAX package evaluates noise with a one-hot
// contraction on the MXU, a TPU formulation, and the port ran it as a chain
// of ~263 eager torch ops a call (mathmap_tpu_torch/kernels/perlin3.py::
// perlin3_reference), each reading and writing a whole plane: about 17 GB
// moved for a 4K call, 6.4 ms on the card. The semantics are that chain's,
// per point and bit for bit in float32:
//
//   xf = floor(x);  xi = |xf| < 2^31 ? (int)xf & 255 : 0       (lattice)
//   x = x - xf;  u = ((x*x)*x) * ((x*((x*6)-15))+10)           (_fade)
//   A = P[xi] + yi, AA = P[A] + zi, ... as Perlin's ImprovedNoise hashes
//   grad(h, x, y, z): h & 15 picks u, v and their signs, then u + v
//   lerp(t, a, b) = a + t*(b - a), seven of them in the published order
//
// every multiply, add and subtract one rounding: the library is built with
// FMA contraction on (kernels/build.py::NVCC_FLAGS), so the arithmetic is
// written with the _rn intrinsics, which nvcc never fuses. The lattice
// index maps NaN, ±inf and |f| >= 2^31 to 0 before the conversion, as the
// chain does to match NumPy's integer conversion.
//
// What bounds it on the card: bytes and single operations about equally.
// A 4K call reads at most three float32 planes and writes one (133 MB,
// 0.040 ms at 3.35 TB/s; the cells' calls read two planes and a 0-d z) and
// runs ~170 single operations a point (1.4e9 at 4K, ~0.04 ms at the card's
// single-op issue rate). The design:
//
// - The doubled 512-entry permutation is copied into shared memory at
//   block start (2 KB) from a 256-entry table in device memory, which stays
//   in L2. The 14 lookups a point are shared-memory loads: the lanes of a
//   warp look up different entries, which constant memory would serialise.
// - A warp evaluates 128 adjacent points of a row, each thread 4 of them:
//   one 16-byte store a thread where the output's rows are 16-byte aligned
//   (the wrapper chooses: kernels/perlin3.py::wide_stores), else one store a
//   point. The four points are independent work for the scheduler.
// - Each input is read through its own (job, row, column) strides, so the
//   evaluator's layouts need no copy: contiguous planes, a row or column
//   grid (stride 0 on one axis), a 0-d `t` or constant (stride 0 on all),
//   strided tile views. Loads go through the read-only path (__ldg): a
//   broadcast input is reread by every point. The output is written once:
//   streaming stores (__stcs).
// - A 2-D grid: columns on blockIdx.x, rows (job x row) on blockIdx.y, so
//   no division a point; a grid taller than 65535 blocks loops.
//
// C interface (loaded with ctypes by kernels/perlin3.py): launches on the
// given stream, never synchronises, returns cudaGetLastError() or
// cudaErrorInvalidValue for arguments the kernel does not take.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
// adjacent points a thread
constexpr int kPoints = 4;
// warps (rows) a block
constexpr int kRows = 8;
constexpr int kThreads = kWarp * kRows;
constexpr unsigned kMaxGridY = 65535;

// Ken Perlin's reference permutation of 0..255 (ops/noise.py's PERM)
__device__ const unsigned char kPerm[256] = {
    151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225,
    140, 36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148,
    247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32,
    57, 177, 33, 88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175,
    74, 165, 71, 134, 139, 48, 27, 166, 77, 146, 158, 231, 83, 111, 229, 122,
    60, 211, 133, 230, 220, 105, 92, 41, 55, 46, 245, 40, 244, 102, 143, 54,
    65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132, 187, 208, 89, 18, 169,
    200, 196, 135, 130, 116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3, 64,
    52, 217, 226, 250, 124, 123, 5, 202, 38, 147, 118, 126, 255, 82, 85, 212,
    207, 206, 59, 227, 47, 16, 58, 17, 182, 189, 28, 42, 223, 183, 170, 213,
    119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101, 155, 167, 43, 172, 9,
    129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185, 112, 104,
    218, 246, 97, 228, 251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241,
    81, 51, 145, 235, 249, 14, 239, 107, 49, 192, 214, 31, 181, 199, 106, 157,
    184, 84, 204, 176, 115, 121, 50, 45, 127, 4, 150, 254, 138, 236, 205, 93,
    222, 114, 67, 29, 24, 72, 243, 141, 128, 195, 78, 66, 215, 61, 156, 180,
};

// an input's pointer and (job, row, column) strides in elements
struct Input {
  const float* p;
  long long job, row, col;
};

__device__ __forceinline__ float load(const Input& in, long long j, long long r,
                                      long long c) {
  return __ldg(in.p + j * in.job + r * in.row + c * in.col);
}

// lattice(): NaN, ±inf and |f| >= 2^31 -> 0, else (int)f & 255
__device__ __forceinline__ int lattice(float f) {
  return fabsf(f) < 2147483648.0f ? static_cast<int>(f) & 255 : 0;
}

// _fade: ((t*t)*t) * ((t*((t*6)-15))+10)
__device__ __forceinline__ float fade(float t) {
  const float cube = __fmul_rn(__fmul_rn(t, t), t);
  const float poly =
      __fadd_rn(__fmul_rn(t, __fsub_rn(__fmul_rn(t, 6.0f), 15.0f)), 10.0f);
  return __fmul_rn(cube, poly);
}

// p0 + t*(p1 - p0)
__device__ __forceinline__ float lerp(float t, float p0, float p1) {
  return __fadd_rn(p0, __fmul_rn(t, __fsub_rn(p1, p0)));
}

// _grad: the dot product with the gradient hash h's low four bits pick
__device__ __forceinline__ float grad(int h, float x, float y, float z) {
  h &= 15;
  const float u = h < 8 ? x : y;
  const float v = h < 4 ? y : (h == 12 || h == 14) ? x : z;
  return __fadd_rn((h & 1) == 0 ? u : -u, (h & 2) == 0 ? v : -v);
}

__device__ __forceinline__ float perlin(const int* __restrict__ P, float x,
                                        float y, float z) {
  const float xf = floorf(x), yf = floorf(y), zf = floorf(z);
  const int xi = lattice(xf), yi = lattice(yf), zi = lattice(zf);
  x = __fsub_rn(x, xf);
  y = __fsub_rn(y, yf);
  z = __fsub_rn(z, zf);
  const float u = fade(x), v = fade(y), w = fade(z);
  const int a = P[xi] + yi;
  const int aa = P[a] + zi;
  const int ab = P[a + 1] + zi;
  const int b = P[xi + 1] + yi;
  const int ba = P[b] + zi;
  const int bb = P[b + 1] + zi;
  const float x1 = __fsub_rn(x, 1.0f), y1 = __fsub_rn(y, 1.0f),
              z1 = __fsub_rn(z, 1.0f);
  const float n000 = grad(P[aa], x, y, z);
  const float n100 = grad(P[ba], x1, y, z);
  const float n010 = grad(P[ab], x, y1, z);
  const float n110 = grad(P[bb], x1, y1, z);
  const float n001 = grad(P[aa + 1], x, y, z1);
  const float n101 = grad(P[ba + 1], x1, y, z1);
  const float n011 = grad(P[ab + 1], x, y1, z1);
  const float n111 = grad(P[bb + 1], x1, y1, z1);
  return lerp(w, lerp(v, lerp(u, n000, n100), lerp(u, n010, n110)),
              lerp(v, lerp(u, n001, n101), lerp(u, n011, n111)));
}

// Each thread evaluates points (row, x0 + v), v < kPoints, of the rows
// blockIdx.y * kRows + threadIdx.y + k * gridDim.y * kRows. WIDE: one
// 16-byte store a thread, else one a point.
template <bool WIDE>
__global__ void __launch_bounds__(kThreads)
    perlin3_kernel(const Input ix, const Input iy, const Input iz,
                   float* __restrict__ out, int h, int w, long long rows) {
  __shared__ int P[512];
  const int tid = threadIdx.y * kWarp + threadIdx.x;
  for (int i = tid; i < 256; i += kThreads) {
    const int p = kPerm[i];
    P[i] = p;
    P[i + 256] = p;
  }
  __syncthreads();
  const int x0 = (blockIdx.x * kWarp + threadIdx.x) * kPoints;
  if (x0 >= w) return;
  const long long step = static_cast<long long>(gridDim.y) * kRows;
  for (long long row = blockIdx.y * kRows + threadIdx.y; row < rows; row += step) {
    const long long j = row / h, r = row - j * h;
    float v[kPoints];
#pragma unroll
    for (int k = 0; k < kPoints; ++k) {
      const int c = x0 + k;
      v[k] = c < w ? perlin(P, load(ix, j, r, c), load(iy, j, r, c), load(iz, j, r, c))
                   : 0.0f;
    }
    float* dst = out + row * w + x0;
    if (WIDE && x0 + kPoints <= w) {
      __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int k = 0; k < kPoints; ++k) {
        if (x0 + k < w) __stcs(dst + k, v[k]);
      }
    }
  }
}

}  // namespace

// Inputs: pointer and (job, row, column) strides in elements each, all
// broadcast to (jobs, h, w); out: a contiguous float32 (jobs, h, w); wide:
// one 16-byte store a thread, which takes an output and rows (w % 4 == 0)
// aligned to 16 bytes.
extern "C" int mm_perlin3(const float* x, long long xj, long long xr, long long xc,
                          const float* y, long long yj, long long yr, long long yc,
                          const float* z, long long zj, long long zr, long long zc,
                          float* out, int jobs, int h, int w, int wide,
                          void* stream) {
  if (jobs <= 0 || h <= 0 || w <= 0 ||
      (wide && (reinterpret_cast<std::uintptr_t>(out) % 16 || w % 4))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Input ix{x, xj, xr, xc}, iy{y, yj, yr, yc}, iz{z, zj, zr, zc};
  const long long rows = static_cast<long long>(jobs) * h;
  const unsigned span = kWarp * kPoints;
  const long long blocks_y = (rows + kRows - 1) / kRows;
  const dim3 block(kWarp, kRows);
  const dim3 grid((static_cast<unsigned>(w) + span - 1) / span,
                  static_cast<unsigned>(blocks_y < kMaxGridY ? blocks_y : kMaxGridY));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide) {
    perlin3_kernel<true><<<grid, block, 0, st>>>(ix, iy, iz, out, h, w, rows);
  } else {
    perlin3_kernel<false><<<grid, block, 0, st>>>(ix, iy, iz, out, h, w, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

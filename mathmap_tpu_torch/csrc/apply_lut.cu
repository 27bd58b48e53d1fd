// Kernel B2: curve and gradient application (LUT lookup) for Hopper (sm_90a).
//
// Replaces mathmap_tpu/pallas_kernels/sample_kernel.py::apply_lut_pallas,
// which ran the LUT through the TPU's MXU sampler as a 1-row image. Here it
// is what the reference's oracle computes (ops/color_ops.py::_lut_take), the
// semantics of mathmap_tpu_torch/kernels/apply_lut.py::apply_lut_reference:
//
//   xf = clamp(pos, 0, 1) * (K - 1);  i0 = floor(xf);  frac = xf - i0;
//   i1 = min(i0 + 1, K - 1);  out[c] = v0[c] + frac * (v1[c] - v0[c])
//
// for a (K,) curve (1 channel) or a (K, 4) RGBA gradient (4 channels). The
// output is planar (C, H, W) float32, like kernel B1's.
//
// What bounds it on the card: memory. Per pixel it reads 4 B of position
// and writes 4 B (curve) or 16 B (gradient): at 3840x2160 RGBA that is
// 166 MB, 0.050 ms at the H100's 3.35 TB/s. The LUT itself is small and is
// read from shared memory: each block stages it once when it fits in the
// default 48 KB (K <= 3072 for RGBA, K <= 12288 for a curve) and then walks
// the pixels in a grid-stride loop, so the staging cost is paid by a few
// blocks per SM, not once per 256 pixels. Larger LUTs are read from global
// memory through the read-only path (__ldg).
//
// Exactness: the arithmetic uses __fmul_rn/__fsub_rn/__fadd_rn, so nvcc
// cannot contract it into an FMA and every value equals the plain version's
// (and the uint8-packed render equals the CPU's). The clamp propagates NaN
// like torch.clamp, and __float2int_rz maps NaN to 0 before the index is
// clamped into [0, K-1], so a NaN position never reads out of bounds: its
// output is NaN, as in the plain version.
//
// C interface (loaded with ctypes by kernels/apply_lut.py): launches on the
// given stream, never synchronises, returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedBytes = 48 * 1024;

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  return __fadd_rn(a, __fmul_rn(f, __fsub_rn(b, a)));
}

template <int C>
__device__ __forceinline__ void store(float* __restrict__ out, long long n,
                                      long long p, const float* table,
                                      bool from_global, int i0, int i1,
                                      float frac);

template <>
__device__ __forceinline__ void store<1>(float* __restrict__ out, long long n,
                                         long long p, const float* table,
                                         bool from_global, int i0, int i1,
                                         float frac) {
  const float v0 = from_global ? __ldg(table + i0) : table[i0];
  const float v1 = from_global ? __ldg(table + i1) : table[i1];
  out[p] = lerp_rn(v0, v1, frac);
}

template <>
__device__ __forceinline__ void store<4>(float* __restrict__ out, long long n,
                                         long long p, const float* table,
                                         bool from_global, int i0, int i1,
                                         float frac) {
  const float4* t4 = reinterpret_cast<const float4*>(table);
  const float4 v0 = from_global ? __ldg(t4 + i0) : t4[i0];
  const float4 v1 = from_global ? __ldg(t4 + i1) : t4[i1];
  out[p] = lerp_rn(v0.x, v1.x, frac);
  out[n + p] = lerp_rn(v0.y, v1.y, frac);
  out[2 * n + p] = lerp_rn(v0.z, v1.z, frac);
  out[3 * n + p] = lerp_rn(v0.w, v1.w, frac);
}

template <int C, bool SHARED>
__global__ void __launch_bounds__(kThreads)
    apply_lut_kernel(const float* __restrict__ lut, int k,
                     const float* __restrict__ pos, float* __restrict__ out,
                     long long n) {
  extern __shared__ float4 smem[];  // float4 for 16-byte alignment
  const float* table = lut;
  if (SHARED) {
    float* s = reinterpret_cast<float*>(smem);
    for (int e = threadIdx.x; e < k * C; e += blockDim.x) s[e] = lut[e];
    __syncthreads();
    table = s;
  }
  const float km1 = static_cast<float>(k - 1);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < n; p += stride) {
    float x = pos[p];
    x = x != x ? x : fminf(fmaxf(x, 0.0f), 1.0f);
    const float xf = __fmul_rn(x, km1);
    const float i0f = floorf(xf);
    const float frac = __fsub_rn(xf, i0f);
    const int i0 = min(max(__float2int_rz(i0f), 0), k - 1);
    const int i1 = min(i0 + 1, k - 1);
    store<C>(out, n, p, table, !SHARED, i0, i1, frac);
  }
}

template <int C>
cudaError_t launch(const float* lut, int k, const float* pos, float* out,
                   long long n, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return err;
  const long long wanted = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(wanted < 8LL * sms ? wanted : 8LL * sms);
  const size_t bytes = static_cast<size_t>(k) * C * sizeof(float);
  if (bytes <= kSharedBytes) {
    apply_lut_kernel<C, true><<<blocks, kThreads, bytes, stream>>>(lut, k, pos, out, n);
  } else {
    apply_lut_kernel<C, false><<<blocks, kThreads, 0, stream>>>(lut, k, pos, out, n);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int mm_apply_lut(const float* lut, int k, int channels,
                            const float* pos, float* out, long long n,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (channels == 1) err = launch<1>(lut, k, pos, out, n, st);
  if (channels == 4) err = launch<4>(lut, k, pos, out, n, st);
  return static_cast<int>(err);
}

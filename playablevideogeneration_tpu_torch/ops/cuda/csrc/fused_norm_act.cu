// Frozen-BatchNorm + LeakyReLU epilogue for NCHW tensors.
//
// Replaces the Pallas TPU kernel
// playablevideogeneration_tpu/ops/pallas/fused_norm_act.py::_kernel
// (pl.pallas_call in fused_scale_shift_leaky_relu).
//
// y = leaky_relu(x * a[ch] + b[ch], negative_slope) with x, y (B, C, H, W) in
// float or bf16 and the folded per-channel coefficients a, b (C,) in f32
// (already rounded to x's type by the caller, as the JAX path rounds them).
// The math is f32, with the product and the sum rounded separately as the
// plain PyTorch version rounds them, so the two agree bit for bit.
//
// Bound on an H100: memory.  x is read once and y written once: 4 bytes per
// element in bf16, 8.4 MB at the largest flagship shape (256x256x32),
// 2.5 us at 3.35 TB/s; the smaller shapes sit below the cost of a launch.
// Design: one thread per element in a grid-stride loop, coalesced in x and
// y; a and b (at most a few hundred floats) are read through the cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

__device__ __forceinline__ float load_f32(float v) { return v; }
__device__ __forceinline__ float load_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T store_as(float v);
template <>
__device__ __forceinline__ float store_as<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void scale_shift_leaky_relu_kernel(const T* __restrict__ x,
                                              const float* __restrict__ a,
                                              const float* __restrict__ b,
                                              T* __restrict__ y, int64_t n, int64_t hw,
                                              int64_t channels, float negative_slope) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int64_t ch = (e / hw) % channels;
    const float v = __fadd_rn(__fmul_rn(load_f32(x[e]), __ldg(a + ch)), __ldg(b + ch));
    y[e] = store_as<T>(v >= 0.0f ? v : __fmul_rn(v, negative_slope));
  }
}

template <typename T>
int launch(const void* x, const void* a, const void* b, void* y, int64_t n, int64_t hw,
           int64_t channels, float negative_slope, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const int threads = 256;
  const int64_t blocks = std::min<int64_t>((n + threads - 1) / threads, 1 << 20);
  scale_shift_leaky_relu_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<T*>(y), n, hw, channels, negative_slope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int scale_shift_leaky_relu_f32(const void* x, const void* a, const void* b, void* y,
                               int64_t n, int64_t hw, int64_t channels,
                               float negative_slope, int device, void* stream) {
  return launch<float>(x, a, b, y, n, hw, channels, negative_slope, device, stream);
}

int scale_shift_leaky_relu_bf16(const void* x, const void* a, const void* b, void* y,
                                int64_t n, int64_t hw, int64_t channels,
                                float negative_slope, int device, void* stream) {
  return launch<__nv_bfloat16>(x, a, b, y, n, hw, channels, negative_slope, device,
                               stream);
}

const char* pvg_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"

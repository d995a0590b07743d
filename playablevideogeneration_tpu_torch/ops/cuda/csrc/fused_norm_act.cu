// Frozen-BatchNorm + LeakyReLU for NCHW tensors, with the BatchNorm's fold.
//
// Replaces the Pallas TPU kernel
// playablevideogeneration_tpu/ops/pallas/fused_norm_act.py::_kernel
// (pl.pallas_call in fused_scale_shift_leaky_relu) together with the fold
// that its caller runs first (fold_batch_norm, then the rounding of a and b
// to x's type), which XLA fuses away on the TPU:
//   a = scale[ch] / sqrt(var[ch] + eps),  b = bias[ch] - mean[ch] * a,
//   both rounded to x's type,
//   y = leaky_relu(x * a + b, negative_slope)
// with x, y (B, C, H, W) in float or bf16 and the BatchNorm's raw f32
// vectors (C,).  The math is f32, every step rounded once in the plain
// PyTorch version's order (__fsqrt_rn, __fdiv_rn, __fmul_rn, __fadd_rn: no
// FMA contraction, no fast math), so the two agree bit for bit.
//
// Bound on an H100: memory.  x is read once and y written once, 4 bytes per
// element in bf16, plus 16 bytes per channel of statistics: 8.4 MB at the
// largest flagship shape (32x256x256), 2.5 us at 3.35 TB/s; the other
// flagship shapes sit at or below the cost of a launch.  Done in the
// kernel, the fold is a few instructions per thread instead of 9 small
// launches per call.  Design:
//   - a 2-D grid: blockIdx.y is the (batch, channel) plane, whose channel
//     each thread finds with one 32-bit remainder and whose coefficients it
//     folds in registers; blockIdx.x is a chunk of the H*W plane, with
//     32-bit offsets inside it;
//   - x's load is issued before the fold, whose square root and division
//     then run while it is in flight;
//   - one 16-byte pack per thread (8 bf16 or 4 floats) where H*W is a
//     multiple of the pack, x and y are 16-byte aligned and x holds at
//     least 512 KiB; otherwise the same kernel runs one element per
//     thread; the wrapper decides (build.vector_width) and passes the
//     width;
//   - the threads per block follow the plane (at most 256, whole warps),
//     and 32x256x256 launches 1024 blocks.
// At the launch-floor shapes the fold's dependent chain still shows: on an
// H100 80GB HBM3 at 700 W the kernel takes up to 8 % longer there than the
// earlier kernel that read folded coefficients, against the 9 launches it
// saves per call (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "packs.cuh"

namespace {

constexpr int kMaxThreads = 256;

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return load_f32(store_as<T>(v));
}

// N consecutive elements of one plane per thread: N == 1 or a 16-byte
// pack.  blockIdx.y is the (batch, channel) plane, gridDim.y planes at a
// time.
template <typename T, int N>
__global__ void __launch_bounds__(kMaxThreads)
    batch_norm_leaky_relu_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                                 const float* __restrict__ bias,
                                 const float* __restrict__ mean,
                                 const float* __restrict__ var, T* __restrict__ y, int planes,
                                 int channels, int hw, float eps, float negative_slope) {
  const int r = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) * N);
  if (r >= hw) return;
  for (int plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    // x's load goes out first, so that the fold's dependent chain (square
    // root, division) runs while it is in flight.
    const int64_t offset = static_cast<int64_t>(plane) * hw + r;
    Pack<T, N> in;
    in.load(x + offset);
    const int ch = plane % channels;
    const float a_f32 =
        __fdiv_rn(__ldg(scale + ch), __fsqrt_rn(__fadd_rn(__ldg(var + ch), eps)));
    const float a = round_to<T>(a_f32);
    const float b =
        round_to<T>(__fsub_rn(__ldg(bias + ch), __fmul_rn(__ldg(mean + ch), a_f32)));
    float v[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float t = __fadd_rn(__fmul_rn(in[j], a), b);
      v[j] = t >= 0.0f ? t : __fmul_rn(t, negative_slope);
    }
    store_pack<N>(y + offset, v);
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, const void* mean,
           const void* var, void* y, int64_t planes, int64_t channels, int64_t hw, float eps,
           float negative_slope, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (planes == 0 || hw == 0) return 0;
  constexpr int kPack = 16 / sizeof(T);
  const bool packed =
      vec == kPack && hw % kPack == 0 && aligned_for<T, kPack>(x) && aligned_for<T, kPack>(y);
  constexpr int64_t kLimit = int64_t{1} << 31;
  if (hw >= kLimit || planes >= kLimit || channels <= 0 || !(packed || vec == 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t per_plane = hw / vec;
  const int threads =
      static_cast<int>(std::min<int64_t>(kMaxThreads, (per_plane + 31) / 32 * 32));
  const dim3 grid(static_cast<unsigned>((per_plane + threads - 1) / threads),
                  static_cast<unsigned>(std::min(planes, kMaxGrid)));
  const auto kernel =
      packed ? batch_norm_leaky_relu_kernel<T, kPack> : batch_norm_leaky_relu_kernel<T, 1>;
  kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(mean),
      static_cast<const float*>(var), static_cast<T*>(y), static_cast<int>(planes),
      static_cast<int>(channels), static_cast<int>(hw), eps, negative_slope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int batch_norm_leaky_relu_f32(const void* x, const void* scale, const void* bias,
                              const void* mean, const void* var, void* y, int64_t planes,
                              int64_t channels, int64_t hw, float eps, float negative_slope,
                              int vec, int device, void* stream) {
  return launch<float>(x, scale, bias, mean, var, y, planes, channels, hw, eps,
                       negative_slope, vec, device, stream);
}

int batch_norm_leaky_relu_bf16(const void* x, const void* scale, const void* bias,
                               const void* mean, const void* var, void* y, int64_t planes,
                               int64_t channels, int64_t hw, float eps, float negative_slope,
                               int vec, int device, void* stream) {
  return launch<__nv_bfloat16>(x, scale, bias, mean, var, y, planes, channels, hw, eps,
                               negative_slope, vec, device, stream);
}

const char* pvg_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"

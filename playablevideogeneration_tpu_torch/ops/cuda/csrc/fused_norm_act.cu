// Frozen-BatchNorm + LeakyReLU, with the BatchNorm's fold, for tensors in
// channels-last storage, the model's.
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
// x and y are stored channels-last (NHWC in memory; the wrapper raises on
// any other strides): element (b, ch, p) of pixel p lies at b*H*W*C + p*C +
// ch, so a batch row is one run of H*W*C and a thread at row offset r finds
// ch = r % C.
//
// Bound on an H100: memory.  x is read once and y written once, 4 bytes per
// element in bf16, plus 16 bytes per channel of statistics: 8.4 MB at the
// largest flagship shape (32x256x256), 2.5 us at 3.35 TB/s; the other
// flagship shapes sit at or below the cost of a launch.  Done in the
// kernel, the fold is a few instructions per thread instead of 9 small
// launches per call.  Design:
//   - a 2-D grid: blockIdx.y is the batch row, blockIdx.x a chunk of its
//     H*W*C run, with 32-bit offsets inside it;
//   - one 16-byte pack per thread (8 bf16 or 4 floats) where C (so that a
//     pack stays inside one pixel's run) is a multiple of the pack, x and y
//     are 16-byte aligned and x holds at least 512 KiB; the wrapper decides
//     (build.vector_width) and passes the width.  The pack's N channels
//     ch .. ch+N-1 take the coefficients that the block folded once into
//     shared memory (2*C floats, so C is at most 6144), its threads taking
//     the channels in turn after issuing their own x loads, then a barrier;
//   - otherwise one element per thread (the 65 channels of E's last
//     BatchNorm, and the batch-1 play shapes under 512 KiB), which issues
//     x's load first and folds its one channel in registers while the load
//     is in flight (the square root and division), with no barrier;
//   - 256 threads per block, fewer for a row of fewer elements.
// At the launch-floor shapes the fold's dependent chain still shows: on an
// H100 80GB HBM3 at 700 W the kernel's earlier NCHW form took up to 8 %
// longer there than a kernel that read folded coefficients, against the 9
// launches it saves per call (PERF.md).  On the same card (PERF.md, bf16):
// a fold in registers for each of a pack's 8 channels took 27 % more at
// 8x32x256x256 than the block's fold, and two or four packs per thread, to
// spread the block's fold over more elements, gained nothing; the shared
// fold for one element per thread cost 0.1-0.2 us a launch at the play
// shapes.

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

// The fold of one channel: a = scale / sqrt(var + eps) and b = bias -
// mean * a, each rounded to T, as f32.
template <typename T>
__device__ __forceinline__ void fold(const float* __restrict__ scale,
                                     const float* __restrict__ bias,
                                     const float* __restrict__ mean,
                                     const float* __restrict__ var, int ch, float eps, float& a,
                                     float& b) {
  const float a_f32 =
      __fdiv_rn(__ldg(scale + ch), __fsqrt_rn(__fadd_rn(__ldg(var + ch), eps)));
  a = round_to<T>(a_f32);
  b = round_to<T>(__fsub_rn(__ldg(bias + ch), __fmul_rn(__ldg(mean + ch), a_f32)));
}

__device__ __forceinline__ float leaky_relu(float x, float a, float b, float negative_slope) {
  const float t = __fadd_rn(__fmul_rn(x, a), b);
  return t >= 0.0f ? t : __fmul_rn(t, negative_slope);
}

// N consecutive elements of one batch row per thread: N == 1 or a 16-byte
// pack.  A row holds hwc = H*W*C elements, blockIdx.y is the row, gridDim.y
// rows at a time; with packs the dynamic shared memory holds the C folded
// a, then the C folded b.
template <typename T, int N>
__global__ void __launch_bounds__(kMaxThreads)
    batch_norm_leaky_relu_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                                 const float* __restrict__ bias,
                                 const float* __restrict__ mean,
                                 const float* __restrict__ var, T* __restrict__ y, int rows,
                                 int channels, int hwc, float eps, float negative_slope) {
  if constexpr (N == 1) {
    // One element per thread: its channel's fold in registers.  x's load
    // goes out first, so that the fold's dependent chain (square root,
    // division) runs while it is in flight.
    const int r = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
    if (r >= hwc) return;
    const int ch = r % channels;
    for (int row = blockIdx.y; row < rows; row += gridDim.y) {
      const int64_t offset = static_cast<int64_t>(row) * hwc + r;
      Pack<T, 1> in;
      in.load(x + offset);
      float a, b;
      fold<T>(scale, bias, mean, var, ch, eps, a, b);
      float v[1] = {leaky_relu(in[0], a, b, negative_slope)};
      store_pack<1>(y + offset, v);
    }
  } else {
    // Packs: the block folds every channel once into shared memory.
    extern __shared__ float folded[];
    const int r = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) * N);
    Pack<T, N> in;
    // The first row's load goes out before the fold.
    if (r < hwc) in.load(x + static_cast<int64_t>(blockIdx.y) * hwc + r);
    for (int ch = threadIdx.x; ch < channels; ch += blockDim.x) {
      fold<T>(scale, bias, mean, var, ch, eps, folded[ch], folded[channels + ch]);
    }
    __syncthreads();
    if (r >= hwc) return;
    const int ch = r % channels;
    for (int row = blockIdx.y; row < rows; row += gridDim.y) {
      const int64_t offset = static_cast<int64_t>(row) * hwc + r;
      if (row != static_cast<int>(blockIdx.y)) in.load(x + offset);
      float v[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        v[j] = leaky_relu(in[j], folded[ch + j], folded[channels + ch + j], negative_slope);
      }
      store_pack<N>(y + offset, v);
    }
  }
}

// The largest C: its folded coefficients fill 48 KiB of shared memory.
constexpr int64_t kMaxChannels = 6144;

// rows and hwc as the kernel takes them.  A pack must divide C, so that it
// never straddles two pixels.
template <typename T>
int launch(const void* x, const void* scale, const void* bias, const void* mean,
           const void* var, void* y, int64_t rows, int64_t channels, int64_t hwc, float eps,
           float negative_slope, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0 || hwc == 0) return 0;
  constexpr int kPack = 16 / sizeof(T);
  const bool packed = vec == kPack && channels > 0 && channels % kPack == 0 &&
                      aligned_for<T, kPack>(x) && aligned_for<T, kPack>(y);
  constexpr int64_t kLimit = int64_t{1} << 31;
  if (hwc >= kLimit || rows >= kLimit || channels <= 0 || !(packed || vec == 1) ||
      channels > kMaxChannels || hwc % channels != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t per_run = hwc / vec;
  const int threads =
      static_cast<int>(std::min<int64_t>(kMaxThreads, (per_run + 31) / 32 * 32));
  const dim3 grid(static_cast<unsigned>((per_run + threads - 1) / threads),
                  static_cast<unsigned>(std::min(rows, kMaxGrid)));
  const size_t shared = packed ? 2 * channels * sizeof(float) : 0;
  const auto kernel = packed ? batch_norm_leaky_relu_kernel<T, kPack>
                             : batch_norm_leaky_relu_kernel<T, 1>;
  kernel<<<grid, threads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(mean),
      static_cast<const float*>(var), static_cast<T*>(y), static_cast<int>(rows),
      static_cast<int>(channels), static_cast<int>(hwc), eps, negative_slope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rows = B runs of hwc = H*W*C.
int batch_norm_leaky_relu_f32(const void* x, const void* scale, const void* bias,
                              const void* mean, const void* var, void* y, int64_t rows,
                              int64_t channels, int64_t hwc, float eps, float negative_slope,
                              int vec, int device, void* stream) {
  return launch<float>(x, scale, bias, mean, var, y, rows, channels, hwc, eps, negative_slope,
                       vec, device, stream);
}

int batch_norm_leaky_relu_bf16(const void* x, const void* scale, const void* bias,
                               const void* mean, const void* var, void* y, int64_t rows,
                               int64_t channels, int64_t hwc, float eps, float negative_slope,
                               int vec, int device, void* stream) {
  return launch<__nv_bfloat16>(x, scale, bias, mean, var, y, rows, channels, hwc, eps,
                               negative_slope, vec, device, stream);
}

const char* pvg_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"

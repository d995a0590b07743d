// ConvLSTM gate update, forward (K1) and backward (K2), for NCHW tensors.
//
// K1 replaces the Pallas TPU kernel
// playablevideogeneration_tpu/ops/pallas/convlstm_gates.py::_fwd_kernel
// (pl.pallas_call in _fwd_2d, reached through fused_lstm_gates); K2 replaces
// ::_bwd_kernel (pl.pallas_call in _bwd_2d, reached through the custom_vjp's
// _fused_gates_bwd).
//
// gates (B, 4C, H, W) holds the fused gate convolution's output in i, f, o, g
// order, so gate k of channel ch is channel k*C + ch; c is (B, C, H, W).
//   i, f, o = sigmoid(.), g = tanh(.)
//   c' = f*c + i*g,  h' = o*tanh(c')
// K2 recomputes i, f, o, g, c' and tanh(c') from (gates, c) instead of
// storing them, then takes the cotangents (dh, dc) of (h', c'):
//   d_c'   = dc + dh*o*(1 - tanh(c')^2)
//   dgates = [d_c'*g*i*(1-i), d_c'*c*f*(1-f), dh*tanh(c')*o*(1-o), d_c'*i*(1-g^2)]
//   dc_prev = d_c'*f
// Storage is float or bf16; the math is f32, with each product and sum
// rounded as the plain PyTorch versions round them, in their order (no FMA
// contraction), IEEE expf and tanhf and __frcp_rn (no fast math), so kernel
// and plain version agree bit for bit.
//
// K1 on an H100.  It moves 14 bytes per state element in bf16 (4 gates and
// c in, h' and c' out): 29 MB, 8.8 us at 3.35 TB/s, for the training
// batch's 16x128x32x32 state; at batch 1 (1.8 MB) a launch costs more than
// the traffic.  At the training shapes instruction issue binds it as much:
// three expf, three reciprocals and two tanhf per element come to about
// 148 SASS instructions per element (static count, chip_smoke.py), 9.3 us
// of issue at 16x128x32x32 on 132 SMs at 1.98 GHz, above the 8.8 us of
// memory.  So the design keeps both the memory system and the issue slots
// busy:
//   - a 2-D grid: blockIdx.y is the batch index, blockIdx.x a chunk of the
//     C*H*W slice, so gate k of slice offset r is at b*4*chw + k*chw + r,
//     with no divide per element and 32-bit offsets inside a slice (the
//     wrapper raises if 4*C*H*W >= 2^31);
//   - a pack of 4 consecutive elements per stream and thread (8-byte
//     accesses in bf16, 16-byte in f32), one step per thread: on an H100
//     80GB HBM3 at 700 W this beat 16-byte bf16 packs, which give half
//     the threads twice the math, and a loop of steps that loads the next
//     pack before computing the current one, at both training shapes;
//   - one element per thread where C*H*W is no multiple of 4, a pointer is
//     not aligned to a pack, or c holds under 512 KiB (the batch-1 play
//     shapes, where more threads cover the latency better); the wrapper
//     decides (build.vector_width) and passes 1, and the same kernel runs.
// K2 moves 24 bytes per state element in bf16 (4 gates, c, dh, dc in; 4
// dgates, dc_prev out), 50 MB (15 us) for the 16x128x32x32 state, and
// reaches half of that bound (H100 80GB HBM3, 700 W) with one thread per
// element in a grid-stride loop, neighbouring threads on neighbouring
// addresses in all 12 streams.
// The TPU kernels' 512-row tiling existed for VMEM and has no counterpart
// here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "packs.cuh"

namespace {

__device__ __forceinline__ float sigmoid(float v) {
  return __frcp_rn(__fadd_rn(1.0f, expf(-v)));
}

constexpr int kFwdThreads = 256;
// Elements per thread of K1's packed path.
constexpr int kFwdPack = 4;

// N consecutive elements of one batch slice per thread: N == 1 or a pack;
// gridDim.y batch rows at a time.
template <typename T, int N>
__global__ void __launch_bounds__(kFwdThreads)
    gates_fwd_kernel(const T* __restrict__ gates, const T* __restrict__ c,
                     T* __restrict__ h_out, T* __restrict__ c_out, int64_t batch, int chw) {
  const int r = static_cast<int>((blockIdx.x * kFwdThreads + threadIdx.x) * N);
  if (r >= chw) return;
  for (int64_t b = blockIdx.y; b < batch; b += gridDim.y) {
    const T* g = gates + b * 4 * chw + r;
    const int64_t s = b * chw + r;
    Pack<T, N> in[5];
    in[0].load(g);
    in[1].load(g + chw);
    in[2].load(g + 2 * chw);
    in[3].load(g + 3 * chw);
    in[4].load(c + s);
    float new_h[N], new_c[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float i = sigmoid(in[0][j]);
      const float f = sigmoid(in[1][j]);
      const float o = sigmoid(in[2][j]);
      const float u = tanhf(in[3][j]);
      new_c[j] = __fadd_rn(__fmul_rn(f, in[4][j]), __fmul_rn(i, u));
      new_h[j] = __fmul_rn(o, tanhf(new_c[j]));
    }
    store_pack<N>(c_out + s, new_c);
    store_pack<N>(h_out + s, new_h);
  }
}

template <typename T>
__global__ void gates_bwd_kernel(const T* __restrict__ gates, const T* __restrict__ c,
                                 const T* __restrict__ dh, const T* __restrict__ dc,
                                 T* __restrict__ dgates, T* __restrict__ dc_prev,
                                 int64_t n, int64_t chw) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int64_t base = e + 3 * (e / chw) * chw;
    const float i = sigmoid(load_f32(gates[base]));
    const float f = sigmoid(load_f32(gates[base + chw]));
    const float o = sigmoid(load_f32(gates[base + 2 * chw]));
    const float g = tanhf(load_f32(gates[base + 3 * chw]));
    const float cell = load_f32(c[e]);
    const float tanh_c = tanhf(__fadd_rn(__fmul_rn(f, cell), __fmul_rn(i, g)));
    const float d_h = load_f32(dh[e]);
    const float d_new_c = __fadd_rn(
        load_f32(dc[e]),
        __fmul_rn(__fmul_rn(d_h, o), __fsub_rn(1.0f, __fmul_rn(tanh_c, tanh_c))));
    dgates[base] = store_as<T>(
        __fmul_rn(__fmul_rn(__fmul_rn(d_new_c, g), i), __fsub_rn(1.0f, i)));
    dgates[base + chw] = store_as<T>(
        __fmul_rn(__fmul_rn(__fmul_rn(d_new_c, cell), f), __fsub_rn(1.0f, f)));
    dgates[base + 2 * chw] = store_as<T>(
        __fmul_rn(__fmul_rn(__fmul_rn(d_h, tanh_c), o), __fsub_rn(1.0f, o)));
    dgates[base + 3 * chw] = store_as<T>(
        __fmul_rn(__fmul_rn(d_new_c, i), __fsub_rn(1.0f, __fmul_rn(g, g))));
    dc_prev[e] = store_as<T>(__fmul_rn(d_new_c, f));
  }
}

int grid_for(int64_t n, int threads) {
  return static_cast<int>(std::min<int64_t>((n + threads - 1) / threads, 1 << 20));
}

template <typename T>
int launch(const void* gates, const void* c, void* h_out, void* c_out, int64_t batch,
           int64_t chw, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || chw == 0) return 0;
  const bool packed = vec == kFwdPack && chw % kFwdPack == 0 &&
                      aligned_for<T, kFwdPack>(gates) && aligned_for<T, kFwdPack>(c) &&
                      aligned_for<T, kFwdPack>(h_out) && aligned_for<T, kFwdPack>(c_out);
  if (4 * chw >= (int64_t{1} << 31) || !(packed || vec == 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((chw / vec + kFwdThreads - 1) / kFwdThreads),
                  static_cast<unsigned>(std::min(batch, kMaxGrid)));
  const auto kernel = packed ? gates_fwd_kernel<T, kFwdPack> : gates_fwd_kernel<T, 1>;
  kernel<<<grid, kFwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gates), static_cast<const T*>(c), static_cast<T*>(h_out),
      static_cast<T*>(c_out), batch, static_cast<int>(chw));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* gates, const void* c, const void* dh, const void* dc,
               void* dgates, void* dc_prev, int64_t n, int64_t chw, int device,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const int threads = 256;
  gates_bwd_kernel<T><<<grid_for(n, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gates), static_cast<const T*>(c), static_cast<const T*>(dh),
      static_cast<const T*>(dc), static_cast<T*>(dgates), static_cast<T*>(dc_prev), n,
      chw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int convlstm_gates_fwd_f32(const void* gates, const void* c, void* h_out, void* c_out,
                           int64_t batch, int64_t chw, int vec, int device, void* stream) {
  return launch<float>(gates, c, h_out, c_out, batch, chw, vec, device, stream);
}

int convlstm_gates_fwd_bf16(const void* gates, const void* c, void* h_out, void* c_out,
                            int64_t batch, int64_t chw, int vec, int device, void* stream) {
  return launch<__nv_bfloat16>(gates, c, h_out, c_out, batch, chw, vec, device, stream);
}

int convlstm_gates_bwd_f32(const void* gates, const void* c, const void* dh,
                           const void* dc, void* dgates, void* dc_prev, int64_t n,
                           int64_t chw, int device, void* stream) {
  return launch_bwd<float>(gates, c, dh, dc, dgates, dc_prev, n, chw, device, stream);
}

int convlstm_gates_bwd_bf16(const void* gates, const void* c, const void* dh,
                            const void* dc, void* dgates, void* dc_prev, int64_t n,
                            int64_t chw, int device, void* stream) {
  return launch_bwd<__nv_bfloat16>(gates, c, dh, dc, dgates, dc_prev, n, chw, device,
                                   stream);
}

const char* pvg_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"

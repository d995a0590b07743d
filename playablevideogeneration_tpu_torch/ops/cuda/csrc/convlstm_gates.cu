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
// contraction), so kernel and plain version agree to the last bit of f32
// apart from expf/tanhf.
//
// Bound on an H100: memory.  Every element is read or written once.  K1:
// 14 bytes per state element in bf16 (4 gates + c in, h' + c' out), about
// 1.8 MB for the flagship's 32x32x128 state at batch 1, 0.55 us at 3.35
// TB/s -- below the cost of a launch.  K2: 24 bytes per state element in
// bf16 (4 gates, c, dh, dc in; 4 dgates, dc_prev out), 50 MB (15 us) for
// the 32x32x128 state at the training batch of 16.
// Design: one thread per state element in a grid-stride loop; neighbouring
// threads touch neighbouring addresses in every stream (7 for K1, 12 for
// K2).  The TPU kernels' 512-row tiling existed for VMEM and has no
// counterpart here.

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

__device__ __forceinline__ float sigmoid(float v) {
  return __frcp_rn(__fadd_rn(1.0f, expf(-v)));
}

template <typename T>
__global__ void gates_fwd_kernel(const T* __restrict__ gates, const T* __restrict__ c,
                                 T* __restrict__ h_out, T* __restrict__ c_out,
                                 int64_t n, int64_t chw) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    // Element e = b*chw + r sits at b*4*chw + k*chw + r for gate k.
    const int64_t base = e + 3 * (e / chw) * chw;
    const float i = sigmoid(load_f32(gates[base]));
    const float f = sigmoid(load_f32(gates[base + chw]));
    const float o = sigmoid(load_f32(gates[base + 2 * chw]));
    const float g = tanhf(load_f32(gates[base + 3 * chw]));
    const float new_c = __fadd_rn(__fmul_rn(f, load_f32(c[e])), __fmul_rn(i, g));
    c_out[e] = store_as<T>(new_c);
    h_out[e] = store_as<T>(__fmul_rn(o, tanhf(new_c)));
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
int launch(const void* gates, const void* c, void* h_out, void* c_out, int64_t n,
           int64_t chw, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const int threads = 256;
  gates_fwd_kernel<T><<<grid_for(n, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gates), static_cast<const T*>(c), static_cast<T*>(h_out),
      static_cast<T*>(c_out), n, chw);
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
                           int64_t n, int64_t chw, int device, void* stream) {
  return launch<float>(gates, c, h_out, c_out, n, chw, device, stream);
}

int convlstm_gates_fwd_bf16(const void* gates, const void* c, void* h_out, void* c_out,
                            int64_t n, int64_t chw, int device, void* stream) {
  return launch<__nv_bfloat16>(gates, c, h_out, c_out, n, chw, device, stream);
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

// ConvLSTM gate update, forward (K1) and backward (K2), for tensors in
// channels-last storage, the model's.
//
// K1 replaces the Pallas TPU kernel
// playablevideogeneration_tpu/ops/pallas/convlstm_gates.py::_fwd_kernel
// (pl.pallas_call in _fwd_2d, reached through fused_lstm_gates); K2 replaces
// ::_bwd_kernel (pl.pallas_call in _bwd_2d, reached through the custom_vjp's
// _fused_gates_bwd).
//
// gates (B, 4C, H, W) holds the fused gate convolution's output in i, f, o, g
// order, so gate k of channel ch is channel k*C + ch; c is (B, C, H, W).
// Both are stored channels-last (NHWC in memory; the wrapper raises on any
// other strides): state element (b, ch, p) of pixel p = y*W + x lies at
// b*chw + p*C + ch, and its gate k at b*4*chw + p*4C + k*C + ch, so the four
// gates of a pixel lie in one run of 4C.  A thread at slice offset
// r = p*C + ch finds ch = r % C (one 32-bit remainder) and its gates at
// 4*r - 3*ch + k*C.
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
// K1 on an H100 (figures of the kernel's earlier NCHW form, which moved the
// same bytes with no remainder per thread).  It moves 14 bytes per state
// element in bf16 (4 gates and
// c in, h' and c' out): 29 MB, 8.8 us at 3.35 TB/s, for the training
// batch's 16x128x32x32 state; at batch 1 (1.8 MB) a launch costs more than
// the traffic.  At the training shapes instruction issue binds it as much:
// three expf, three reciprocals and two tanhf per element come to about
// 148 SASS instructions per element (static count, chip_smoke.py), 9.3 us
// of issue at 16x128x32x32 on 132 SMs at 1.98 GHz, above the 8.8 us of
// memory.  So the design keeps both the memory system and the issue slots
// busy:
//   - a 2-D grid: blockIdx.y is the batch index, blockIdx.x a chunk of the
//     C*H*W slice, so gate k of slice offset r is at b*4*chw + 4*r -
//     3*(r % C) + k*C, with one remainder and no divide per element and
//     32-bit offsets inside a slice (the wrapper raises if 4*C*H*W >= 2^31);
//   - a pack of 4 consecutive elements per stream and thread (8-byte
//     accesses in bf16, 16-byte in f32), one step per thread: on an H100
//     80GB HBM3 at 700 W this beat 16-byte bf16 packs, which give half
//     the threads twice the math, and a loop of steps that loads the next
//     pack before computing the current one, at both training shapes;
//   - one element per thread where C is no multiple of 4 (so that a pack
//     never straddles two gates), a pointer is not
//     aligned to a pack, or c holds under 512 KiB (the batch-1 play shapes,
//     where more threads cover the latency better); the wrapper decides
//     (build.vector_width) and passes 1, and the same kernel runs.
//
// K2 on an H100.  It moves 24 bytes per state element in bf16 (4 gates, c,
// dh and dc in; 4 gate gradients and dc_prev out): 50 MB, 15.0 us at 3.35
// TB/s, for the 16x128x32x32 state.  It does K1's transcendentals again
// plus 19 products and sums per element, so issue comes close to the
// memory time as well.  Its first design walked a flat index over the whole
// batch in a grid-stride loop, one element per thread: a 64-bit division
// per element to find the batch row (a software routine of dozens of
// instructions on this card), 64-bit arithmetic for all 12 addresses, and
// 2-byte accesses in bf16 (64 bytes per warp instruction); it reached half
// of its bound cold.  The design now follows K1's:
//   - the same 2-D grid (blockIdx.y the batch row, blockIdx.x a chunk of
//     the C*H*W slice; no divide, 32-bit offsets inside a slice);
//   - a pack of kBwdPack consecutive elements per stream and thread, all
//     seven input packs loaded before the math, one step per thread;
//   - one element per thread where the wrapper's build.vector_width says
//     so (sizes, alignment of any of the six pointers, launch size).
// On an H100 80GB HBM3 at 700 W (chip_gate_bwd_packs.py, cold in HBM),
// bf16 packs of 4 elements (8-byte accesses; 40 registers, 176.8 static
// SASS instructions per element, no spills) beat packs of 8 (16-byte; 64
// registers, 160.1 per element) at all four training shapes: 18.9 against
// 20.1 us at 16x128x32x32 (79 % of the bound), 10.4-10.5 against 11.9 at
// 16x256x16x16 and 8x128x32x32 (72 %), 7.5 against 8.1 at 8x256x16x16
// (50 %, where the launch floor of about 2.5 us is a third of the time).
// The likely reasons, not profiled: fewer registers keep more warps
// resident to cover the latency, and the grid has twice the blocks.
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

// Where gate 0 of slice offset r (pixel r / C, channel r % C) lies; gate k
// lies k*C further on.
__device__ __forceinline__ int gate_offset(int r, int channels) {
  return 4 * r - 3 * (r % channels);
}

// N consecutive elements of one batch slice per thread: N == 1 or a pack;
// gridDim.y batch rows at a time.
template <typename T, int N>
__global__ void __launch_bounds__(kFwdThreads)
    gates_fwd_kernel(const T* __restrict__ gates, const T* __restrict__ c,
                     T* __restrict__ h_out, T* __restrict__ c_out, int64_t batch, int chw,
                     int channels) {
  const int r = static_cast<int>((blockIdx.x * kFwdThreads + threadIdx.x) * N);
  if (r >= chw) return;
  const int gate = gate_offset(r, channels);
  for (int64_t b = blockIdx.y; b < batch; b += gridDim.y) {
    const T* g = gates + b * 4 * chw + gate;
    const int64_t s = b * chw + r;
    Pack<T, N> in[5];
    in[0].load(g);
    in[1].load(g + channels);
    in[2].load(g + 2 * channels);
    in[3].load(g + 3 * channels);
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

constexpr int kBwdThreads = 256;
// Elements per thread of K2's packed path in bf16 (chip_gate_bwd_packs.py
// builds it with 4 and with 8); in f32 a pack of 4 is 16 bytes already.
constexpr int kBwdPackBf16 = 4;
template <typename T>
constexpr int kBwdPack = sizeof(T) == 2 ? kBwdPackBf16 : 4;

// N consecutive elements of one batch slice per thread: N == 1 or a pack;
// gridDim.y batch rows at a time.
template <typename T, int N>
__global__ void __launch_bounds__(kBwdThreads)
    gates_bwd_kernel(const T* __restrict__ gates, const T* __restrict__ c,
                     const T* __restrict__ dh, const T* __restrict__ dc,
                     T* __restrict__ dgates, T* __restrict__ dc_prev, int64_t batch, int chw,
                     int channels) {
  const int r = static_cast<int>((blockIdx.x * kBwdThreads + threadIdx.x) * N);
  if (r >= chw) return;
  const int gate = gate_offset(r, channels);
  for (int64_t b = blockIdx.y; b < batch; b += gridDim.y) {
    const int64_t g = b * 4 * chw + gate;
    const int64_t s = b * chw + r;
    Pack<T, N> in[7];
    in[0].load(gates + g);
    in[1].load(gates + g + channels);
    in[2].load(gates + g + 2 * channels);
    in[3].load(gates + g + 3 * channels);
    in[4].load(c + s);
    in[5].load(dh + s);
    in[6].load(dc + s);
    float d_i[N], d_f[N], d_o[N], d_g[N], d_c[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float i = sigmoid(in[0][j]);
      const float f = sigmoid(in[1][j]);
      const float o = sigmoid(in[2][j]);
      const float u = tanhf(in[3][j]);
      const float cell = in[4][j];
      const float d_h = in[5][j];
      const float tanh_c = tanhf(__fadd_rn(__fmul_rn(f, cell), __fmul_rn(i, u)));
      const float d_new_c = __fadd_rn(
          in[6][j], __fmul_rn(__fmul_rn(d_h, o), __fsub_rn(1.0f, __fmul_rn(tanh_c, tanh_c))));
      d_i[j] = __fmul_rn(__fmul_rn(__fmul_rn(d_new_c, u), i), __fsub_rn(1.0f, i));
      d_f[j] = __fmul_rn(__fmul_rn(__fmul_rn(d_new_c, cell), f), __fsub_rn(1.0f, f));
      d_o[j] = __fmul_rn(__fmul_rn(__fmul_rn(d_h, tanh_c), o), __fsub_rn(1.0f, o));
      d_g[j] = __fmul_rn(__fmul_rn(d_new_c, i), __fsub_rn(1.0f, __fmul_rn(u, u)));
      d_c[j] = __fmul_rn(d_new_c, f);
    }
    store_pack<N>(dgates + g, d_i);
    store_pack<N>(dgates + g + channels, d_f);
    store_pack<N>(dgates + g + 2 * channels, d_o);
    store_pack<N>(dgates + g + 3 * channels, d_g);
    store_pack<N>(dc_prev + s, d_c);
  }
}

// A launch over C*H*W = chw per batch row with C = channels may take packs
// of `pack` where C is whole packs (and so chw too).
template <typename T>
int launch(const void* gates, const void* c, void* h_out, void* c_out, int64_t batch,
           int64_t chw, int64_t channels, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || chw == 0) return 0;
  const bool packed = vec == kFwdPack && channels % kFwdPack == 0 &&
                      aligned_for<T, kFwdPack>(gates) && aligned_for<T, kFwdPack>(c) &&
                      aligned_for<T, kFwdPack>(h_out) && aligned_for<T, kFwdPack>(c_out);
  if (4 * chw >= (int64_t{1} << 31) || channels <= 0 || chw % channels != 0 ||
      !(packed || vec == 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((chw / vec + kFwdThreads - 1) / kFwdThreads),
                  static_cast<unsigned>(std::min(batch, kMaxGrid)));
  const auto kernel = packed ? gates_fwd_kernel<T, kFwdPack> : gates_fwd_kernel<T, 1>;
  kernel<<<grid, kFwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gates), static_cast<const T*>(c), static_cast<T*>(h_out),
      static_cast<T*>(c_out), batch, static_cast<int>(chw), static_cast<int>(channels));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* gates, const void* c, const void* dh, const void* dc,
               void* dgates, void* dc_prev, int64_t batch, int64_t chw, int64_t channels,
               int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || chw == 0) return 0;
  constexpr int pack = kBwdPack<T>;
  const bool packed = vec == pack && channels % pack == 0 &&
                      aligned_for<T, pack>(gates) && aligned_for<T, pack>(c) &&
                      aligned_for<T, pack>(dh) && aligned_for<T, pack>(dc) &&
                      aligned_for<T, pack>(dgates) && aligned_for<T, pack>(dc_prev);
  if (4 * chw >= (int64_t{1} << 31) || channels <= 0 || chw % channels != 0 ||
      !(packed || vec == 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((chw / vec + kBwdThreads - 1) / kBwdThreads),
                  static_cast<unsigned>(std::min(batch, kMaxGrid)));
  const auto kernel = packed ? gates_bwd_kernel<T, pack> : gates_bwd_kernel<T, 1>;
  kernel<<<grid, kBwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gates), static_cast<const T*>(c), static_cast<const T*>(dh),
      static_cast<const T*>(dc), static_cast<T*>(dgates), static_cast<T*>(dc_prev), batch,
      static_cast<int>(chw), static_cast<int>(channels));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// chw = C*H*W per batch row and channels = C.
int convlstm_gates_fwd_f32(const void* gates, const void* c, void* h_out, void* c_out,
                           int64_t batch, int64_t chw, int64_t channels, int vec, int device,
                           void* stream) {
  return launch<float>(gates, c, h_out, c_out, batch, chw, channels, vec, device, stream);
}

int convlstm_gates_fwd_bf16(const void* gates, const void* c, void* h_out, void* c_out,
                            int64_t batch, int64_t chw, int64_t channels, int vec, int device,
                            void* stream) {
  return launch<__nv_bfloat16>(gates, c, h_out, c_out, batch, chw, channels, vec, device,
                               stream);
}

int convlstm_gates_bwd_f32(const void* gates, const void* c, const void* dh,
                           const void* dc, void* dgates, void* dc_prev, int64_t batch,
                           int64_t chw, int64_t channels, int vec, int device, void* stream) {
  return launch_bwd<float>(gates, c, dh, dc, dgates, dc_prev, batch, chw, channels, vec,
                           device, stream);
}

int convlstm_gates_bwd_bf16(const void* gates, const void* c, const void* dh,
                            const void* dc, void* dgates, void* dc_prev, int64_t batch,
                            int64_t chw, int64_t channels, int vec, int device, void* stream) {
  return launch_bwd<__nv_bfloat16>(gates, c, dh, dc, dgates, dc_prev, batch, chw, channels,
                                   vec, device, stream);
}

const char* pvg_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"

// Element access shared by the port's elementwise kernels: f32 math on
// float or bf16 storage, one element per access or a pack of N consecutive
// elements in one access (4 floats or 8 bf16 in 16 bytes, 4 bf16 in 8).
// A pack converts each of its elements exactly as the one-element path
// does, so a kernel gives the same bits either way.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// N consecutive elements of T as loaded (a pack through the read-only
// path); element j as f32 with pack[j], which a kernel calls with j known
// at compile time.
template <typename T, int N>
struct Pack;

template <typename T>
struct Pack<T, 1> {
  T raw;
  __device__ __forceinline__ void load(const T* p) { raw = *p; }
  __device__ __forceinline__ float operator[](int) const { return load_f32(raw); }
};

template <>
struct Pack<float, 4> {
  float4 raw;
  __device__ __forceinline__ void load(const float* p) {
    raw = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ float operator[](int j) const {
    return j == 0 ? raw.x : j == 1 ? raw.y : j == 2 ? raw.z : raw.w;
  }
};

// A bf16 is the upper half of the f32 with the same bits, so a 32-bit
// word holds elements 2j (low half) and 2j+1 (high half); the shifts are
// what __bfloat162float does.
__device__ __forceinline__ float bf16_low(unsigned word) { return __uint_as_float(word << 16); }
__device__ __forceinline__ float bf16_high(unsigned word) {
  return __uint_as_float(word & 0xffff0000u);
}

template <>
struct Pack<__nv_bfloat16, 4> {
  uint2 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ float operator[](int j) const {
    const unsigned word = j < 2 ? raw.x : raw.y;
    return j % 2 ? bf16_high(word) : bf16_low(word);
  }
};

template <>
struct Pack<__nv_bfloat16, 8> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float operator[](int j) const {
    const unsigned word = j < 2 ? raw.x : j < 4 ? raw.y : j < 6 ? raw.z : raw.w;
    return j % 2 ? bf16_high(word) : bf16_low(word);
  }
};

// Two values rounded to bf16 as store_as rounds them, in one word.
__device__ __forceinline__ unsigned bf16_word(float low, float high) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(low))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(high))) << 16);
}

// Stores N f32 values as T in one access, rounded as store_as rounds them.
template <int N, typename T>
__device__ __forceinline__ void store_pack(T* p, const float (&v)[N]) {
  if constexpr (N == 1) {
    *p = store_as<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(N == 4, "a float pack is 16 bytes");
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(bf16_word(v[0], v[1]), bf16_word(v[2], v[3]));
  } else {
    static_assert(N == 8, "a bf16 pack is 8 or 16 bytes");
    *reinterpret_cast<uint4*>(p) = make_uint4(bf16_word(v[0], v[1]), bf16_word(v[2], v[3]),
                                              bf16_word(v[4], v[5]), bf16_word(v[6], v[7]));
  }
}

// Is p aligned for a pack of N elements of T?
template <typename T, int N>
bool aligned_for(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % (N * sizeof(T)) == 0;
}

// gridDim.y's and gridDim.z's limit: a kernel whose blockIdx.y or .z walks
// more rows loops.
constexpr int64_t kMaxGrid = 65535;

}  // namespace

// Four-channel loads and stores shared by the channels-last kernels: a
// thread owns four neighbouring channels, one float4 or four bf16 in 8
// bytes, and computes on them in f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  // four bf16 in one 8-byte load; element 0 sits in the low half of .x
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ unsigned bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 t;
  t.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
  t.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
  *reinterpret_cast<uint2*>(p) = t;
}

}  // namespace

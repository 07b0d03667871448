// Four-channel loads and stores shared by the channels-last kernels: a
// thread owns four neighbouring channels, one float4 or four bf16 in 8
// bytes, and computes on them in f32. Beside them, plain reads of four or
// eight channels and of one byte a channel from shared memory (read4,
// read8, read_bytes), and eight bf16 in one 16-byte load or store (load8,
// store8).

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

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  // eight bf16 in one 16-byte load; element 0 sits in the low half of .x
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
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

// Plain reads of a thread's lanes, for data staged in shared memory: four
// f32 (16 bytes), four bf16 (8 bytes) or eight bf16 (16 bytes), and one
// byte a channel (4 or 8 bytes). The pointer is aligned to the read's size.
__device__ __forceinline__ void read4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void read4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}

__device__ __forceinline__ void read8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void read_bytes(const unsigned char* p, unsigned char (&b)[4]) {
  const unsigned t = *reinterpret_cast<const unsigned*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) b[k] = (unsigned char)(t >> (8 * k));
}

__device__ __forceinline__ void read_bytes(const unsigned char* p, unsigned char (&b)[8]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    b[k] = (unsigned char)(t.x >> (8 * k));
    b[4 + k] = (unsigned char)(t.y >> (8 * k));
  }
}

// eight bf16 in one 16-byte store, element 0 in the low half of .x
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 t;
  t.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
  t.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
  t.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
  t.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
  *reinterpret_cast<uint4*>(p) = t;
}

}  // namespace

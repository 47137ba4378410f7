// Shared helpers for the port's kernels: fp32 <-> storage-type conversion.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The layout shared by B4/B5's forwards and backwards under a gradient: the
// state checkpoint before every kCkptSteps-th step, and the channels (rows of
// partials) a B5 backward block takes. kernels/build.py holds the values and
// passes them as -D flags, so the kernels and the wrappers cannot disagree.
#if !defined(CKPT_STEPS) || !defined(SCAN_BWD_CHANNELS)
#error "build with -DCKPT_STEPS= -DSCAN_BWD_CHANNELS= (kernels/build.py)"
#endif
constexpr int kCkptSteps = CKPT_STEPS;
constexpr int kScanBwdChannels = SCAN_BWD_CHANNELS;

// dtype codes passed from the Python wrappers
enum DType : int { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2, kInt8 = 3 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch/XLA casts do
}

// four consecutive elements (16-byte aligned as fp32, 8-byte as bf16) as fp32
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

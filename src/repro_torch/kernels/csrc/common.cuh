// Device helpers shared by the port's CUDA kernels: the epilogue table and
// the conversions between the storage dtypes and f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

namespace {

// keep in step with ACTIVATIONS in kernels/bsr_matmul.py
enum Act {
  kNone = 0,
  kRelu = 1,
  kGelu = 2,
  kTanh = 3,
  kSigmoid = 4,
  kSilu = 5,
  kSquaredRelu = 6,
};

__device__ __forceinline__ float activate(float y, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(y, 0.f);
    case kGelu: {  // the tanh form, as jax.nn.gelu's default
      const float kSqrt2OverPi = 0.7978845608028654f;
      const float kKappa = 0.044715f;
      const float inner = kSqrt2OverPi * (y + kKappa * y * y * y);
      return 0.5f * y * (1.f + tanhf(inner));
    }
    case kTanh:
      return tanhf(y);
    case kSigmoid:
      return 1.f / (1.f + expf(-y));
    case kSilu:
      return y / (1.f + expf(-y));
    case kSquaredRelu: {
      const float r = fmaxf(y, 0.f);
      return r * r;
    }
    default:
      return y;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) {
  const __half_raw h = __nv_cvt_fp8_to_halfraw(v.__x, __NV_E4M3);
  return __half2float(__half(h));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// v rounded to T's precision and widened back: the value a T store and
// reload would give
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

}  // namespace

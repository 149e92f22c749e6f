// Complex FP32 arithmetic on float2 (x = re, y = im), shared by the kernels.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// conj(a) * b
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x += a.x * b.x - a.y * b.y;
  acc.y += a.x * b.y + a.y * b.x;
}
// acc += a b as four fused multiply-adds (cfma's two products, a difference
// and a sum round once more and take six instructions)
__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(-a.y, b.y, fmaf(a.x, b.x, acc.x));
  acc.y = fmaf(a.y, b.x, fmaf(a.x, b.y, acc.y));
}

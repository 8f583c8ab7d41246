// bf16 for the CPU stand-in of the CUDA runtime (cuda_runtime.h here).
#pragma once
#include "cuda_runtime.h"
struct __nv_bfloat16 { unsigned short x; };
inline float __bfloat162float(__nv_bfloat16 h) { return __uint_as_float((unsigned)h.x << 16); }
inline __nv_bfloat16 __float2bfloat16(float f) {
  unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(unsigned short)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)};
}
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __low2float(__nv_bfloat162 h) { return __bfloat162float(h.x); }
inline float __high2float(__nv_bfloat162 h) { return __bfloat162float(h.y); }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {__float2bfloat16(a), __float2bfloat16(b)}; }

// Device code shared by the GTAO kernels (gtao_main.cu: K3h, K3;
// gtao_denoise.cu: K4): NaN-propagating min, max and clip, the lpfloat
// rounding of the fp16 instantiations and the bent-normal term's encoding.
//
// LP is tpurt's fp16 (min16float) emulation: every lpfloat result goes
// through lp(x) = __half2float(__float2half_rn(x)) after its operation, and
// a literal that meets an lpfloat operand takes its f16 nearest (lit). With
// LP false both are the identity and the f32 operations are the exact
// path's. The plain PyTorch versions (kernels/gtao_main.py _Lp) round in
// the same places.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gtao {

// NaN-propagating min and max (jnp.minimum / torch.minimum semantics)
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return nmin(nmax(x, lo), hi);
}

// an lpfloat result: rounded to f16 (nearest even) with LP, else as is
template <bool LP>
__device__ __forceinline__ float lp(float x) {
  if constexpr (LP) return __half2float(__float2half_rn(x));
  return x;
}
// a double literal's f16 nearest (ties to even), numpy's float16(c): the
// value a weakly typed literal takes against an f16 operand in tpurt
__device__ __forceinline__ float h16(double c) {
  if (c == 0.0) return (float)c;
  int e;
  frexp(fabs(c), &e);                        // |c| = m 2^e, m in [0.5, 1)
  const double ulp = ldexp(1.0, max(e - 11, -24));
  return (float)(rint(c / ulp) * ulp);
}
// a literal of the lpfloat arithmetic: its f16 nearest with LP, else f32
template <bool LP>
__device__ __forceinline__ float lit(double c) {
  if constexpr (LP) return h16(c);
  return (float)c;
}

// XeGTAO_EncodeVisibilityBentNormal: RGBA8 of (bn * 0.5 + 0.5, vis), in
// tpurt's encode_visibility_bent_normal order (tpurt/passes/gtao.py:370)
template <bool LP>
__device__ __forceinline__ uint32_t u8_of(float x) {
  return (uint32_t)clip(
      lp<LP>(lp<LP>(x * lit<LP>(255.0)) + lit<LP>(0.5)), 0.0f, 255.0f);
}
template <bool LP>
__device__ __forceinline__ uint32_t encode_bent(float vis, float bx,
                                                float by, float bz) {
  auto half_up = [](float b) {
    return u8_of<LP>(lp<LP>(lp<LP>(b * lit<LP>(0.5)) + lit<LP>(0.5)));
  };
  return half_up(bx) | (half_up(by) << 8) | (half_up(bz) << 16) |
         (u8_of<LP>(clip(vis, 0.0f, 1.0f)) << 24);
}

}  // namespace gtao

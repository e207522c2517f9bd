// XeGTAO edge-aware denoise, one pass per launch, one thread per pixel.
//
// Replaces tpurt/kernels/gtao_pallas.py::_chain_kernel (K4,
// denoise_chain_pallas). The TPU kernel fuses all N passes over row blocks
// with an N-row halo and re-clamps the halo between passes. Here each pass
// is its own launch with a u8 image between passes, which is exactly the
// semantics of tpurt's XLA chain (passes/gtao.py:denoise_pass applied N
// times), so no halo re-clamping is needed. The last pass scales by 1.5 and
// stores u16 without a clamp (values reach ~383).
//
// What bounds it on an H100: bytes. A pass reads 9 AO texels and 5 edge
// texels (u8) and writes 1 or 2 bytes per pixel; neighbouring threads read
// neighbouring bytes, so the loads coalesce and mostly hit L1. Fusing the
// passes in shared memory is later work (the main path runs one pass).
//
// Exactness: the operation order of denoise_pass (edge symmetry, AO leak,
// diagonal weights, the 9 taps added in tpurt's order); --fmad=false.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float clip01(float x) {
  return nmin(nmax(x, 0.0f), 1.0f);
}

struct Edges {
  float l, r, t, b;
};

__device__ __forceinline__ Edges unpack(int p) {
  return {(float)((p >> 6) & 3) / 3.0f, (float)((p >> 4) & 3) / 3.0f,
          (float)((p >> 2) & 3) / 3.0f, (float)(p & 3) / 3.0f};
}

template <bool FINAL>
__global__ void __launch_bounds__(256)
gtao_denoise_kernel(const uint8_t* __restrict__ ao,
                    const uint8_t* __restrict__ edges, int h, int w,
                    float blur, void* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= h * w) return;
  const int y = idx / w, x = idx - (idx / w) * w;
  const int xl = max(x - 1, 0), xr = min(x + 1, w - 1);
  const int yt = max(y - 1, 0), yb = min(y + 1, h - 1);
  auto e_at = [&](int yy, int xx) { return unpack(edges[yy * w + xx]); };
  auto vis = [&](int yy, int xx) {
    return (float)ao[yy * w + xx] / 255.0f;
  };

  const Edges el = e_at(y, xl), er = e_at(y, xr), et = e_at(yt, x),
              eb = e_at(yb, x);
  Edges ec = e_at(y, x);
  // symmetry enforcement
  ec.l = ec.l * el.r;
  ec.r = ec.r * er.l;
  ec.t = ec.t * et.b;
  ec.b = ec.b * eb.t;
  // AO leak for pixels with 3-4 edges
  const float esum = ec.l + ec.r + ec.t + ec.b;
  const float edginess = (clip01(1.5f - esum) / 1.5f) * 0.5f;
  ec.l = clip01(ec.l + edginess);
  ec.r = clip01(ec.r + edginess);
  ec.t = clip01(ec.t + edginess);
  ec.b = clip01(ec.b + edginess);

  const float diag = 0.425f;
  const float w_tl = diag * (ec.l * el.t + ec.t * et.l);
  const float w_tr = diag * (ec.t * et.r + ec.r * er.t);
  const float w_bl = diag * (ec.b * eb.l + ec.l * el.b);
  const float w_br = diag * (ec.r * er.b + ec.b * eb.r);

  float sum_weight = blur;
  float total = vis(y, x) * sum_weight;
  total = total + vis(y, xl) * ec.l;
  sum_weight = sum_weight + ec.l;
  total = total + vis(y, xr) * ec.r;
  sum_weight = sum_weight + ec.r;
  total = total + vis(yt, x) * ec.t;
  sum_weight = sum_weight + ec.t;
  total = total + vis(yb, x) * ec.b;
  sum_weight = sum_weight + ec.b;
  total = total + vis(yt, xl) * w_tl;
  sum_weight = sum_weight + w_tl;
  total = total + vis(yt, xr) * w_tr;
  sum_weight = sum_weight + w_tr;
  total = total + vis(yb, xl) * w_bl;
  sum_weight = sum_weight + w_bl;
  total = total + vis(yb, xr) * w_br;
  sum_weight = sum_weight + w_br;

  const float o = total / sum_weight;
  if (FINAL) {
    const float s = o * 1.5f;
    static_cast<uint16_t*>(out)[idx] =
        (uint16_t)(int)(nmax(s, 0.0f) * 255.0f + 0.5f);
  } else {
    static_cast<uint8_t*>(out)[idx] =
        (uint8_t)(int)(clip01(o) * 255.0f + 0.5f);
  }
}

}  // namespace

extern "C" int tpurt_gtao_denoise(const uint8_t* ao, const uint8_t* edges,
                                  int h, int w, float blur, int final_pass,
                                  void* out, cudaStream_t stream) {
  const int n = h * w;
  if (n > 0) {
    const int blocks = (n + 255) / 256;
    if (final_pass) {
      gtao_denoise_kernel<true><<<blocks, 256, 0, stream>>>(ao, edges, h, w,
                                                            blur, out);
    } else {
      gtao_denoise_kernel<false><<<blocks, 256, 0, stream>>>(ao, edges, h,
                                                             w, blur, out);
    }
  }
  return (int)cudaGetLastError();
}

// The transcendental probe (P1), one thread per noise element.
//
// Replaces tools/trans_equiv_probe.py:104 mosaic_side, tpurt's probe of
// whether Mosaic lowers cos/sin/pow/mod as XLA does. It evaluates the
// noise-only expressions of the GTAO main pass (the slice angle's cos and
// sin, the sample-distribution pow of every step) on two noise planes:
// those of tpurt's probe kernel (:69-89), of _noise_hoist_kernel
// (tpurt/kernels/gtao_main_pallas.py:246-277) and of what K3 computes
// inline (gtao_main.cu). Here the question is whether CUDA's libm (cosf,
// sinf, fmodf, powf, built with --fmad=false and without fast math) gives
// PyTorch's bits: the plain version (kernels/trans_equiv.py) makes the
// same f32 arguments and calls torch.cos/sin/pow on them.
//
// What bounds it on an H100: nothing of note; 45 outputs per element of
// two (32, 128) planes, about 0.77 MB written, far below a microsecond of
// memory time. It launches once per probe; the design is the plain one,
// each thread writing its element of every output row (coalesced rows).
//
// Output layout (tpurt's): per slice the rows cos, sin, then pow of each
// step, so row (2 + steps) * s + k of (slices * (2 + steps), n).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float PI_F = 3.1415926535897932384626433832795f;
constexpr float GOLDEN_F = 0.6180339887498948482f;

__global__ void __launch_bounds__(128)
trans_equiv_kernel(const float* __restrict__ noise_slice,
                   const float* __restrict__ noise_sample, float sdp, int n,
                   int slices, int steps, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float a = noise_slice[i];
  const float b = noise_sample[i];
  size_t row = 0;
  for (int s = 0; s < slices; ++s) {
    const float sf = (float)s;
    const float phi = ((sf + a) / (float)slices) * PI_F;
    out[row++ * n + i] = cosf(phi);
    out[row++ * n + i] = sinf(phi);
    for (int st = 0; st < steps; ++st) {
      const float stf = (float)st;
      const float base = (sf + stf * (float)steps) * GOLDEN_F;
      const float s0 = (stf + fmodf(b + base, 1.0f)) / (float)steps;
      out[row++ * n + i] = powf(s0, sdp);
    }
  }
}

}  // namespace

// planes: noise_slice and noise_sample, n elements each; out
// (slices * (2 + steps), n) f32
extern "C" int tpurt_trans_equiv(const float* noise_slice,
                                 const float* noise_sample, float sdp, int n,
                                 int slices, int steps, float* out,
                                 cudaStream_t stream) {
  if (n > 0) {
    trans_equiv_kernel<<<(n + 127) / 128, 128, 0, stream>>>(
        noise_slice, noise_sample, sdp, n, slices, steps, out);
  }
  return (int)cudaGetLastError();
}

// The transcendental probe (P1), one thread per noise element and output
// row.
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
// memory time. What its time is made of is latency: each output is a libm
// call (cosf, sinf, powf) of some tens of dependent instructions, and one
// thread per element made 45 of them in a row on 32 blocks, a quarter of
// the SMs. So every output gets its own thread: a grid of (ceil(n / 128),
// slices * (2 + steps)) blocks, 1,440 for the probe's 4,096 elements at
// 9 slices of 3 steps, each thread one call on arguments built as before.
// One thread per element and slice (K3h's grid in gtao_main.cu: 288
// blocks, 2 + steps calls in a row) took 1.07x its time on an H100
// (PERF.md). Rows stay coalesced: a warp writes 32 consecutive elements
// of one row.
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
  const int r = blockIdx.y;
  if (i >= n) return;
  const int per = 2 + steps;
  const int s = r / per, k = r - s * per;
  const float sf = (float)s;
  float val;
  if (k < 2) {
    const float phi = ((sf + noise_slice[i]) / (float)slices) * PI_F;
    val = k == 0 ? cosf(phi) : sinf(phi);
  } else {
    const float stf = (float)(k - 2);
    const float base = (sf + stf * (float)steps) * GOLDEN_F;
    const float s0 =
        (stf + fmodf(noise_sample[i] + base, 1.0f)) / (float)steps;
    val = powf(s0, sdp);
  }
  out[(size_t)r * n + i] = val;
}

}  // namespace

// planes: noise_slice and noise_sample, n elements each; out
// (slices * (2 + steps), n) f32
extern "C" int tpurt_trans_equiv(const float* noise_slice,
                                 const float* noise_sample, float sdp, int n,
                                 int slices, int steps, float* out,
                                 cudaStream_t stream) {
  if (n > 0 && slices > 0) {
    const dim3 grid((n + 127) / 128, slices * (2 + steps));
    trans_equiv_kernel<<<grid, 128, 0, stream>>>(noise_slice, noise_sample,
                                                 sdp, n, slices, steps, out);
  }
  return (int)cudaGetLastError();
}

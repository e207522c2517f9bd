// XeGTAO main pass (K3) and its noise table (K3h), written for Hopper.
//
// Replaces tpurt/kernels/gtao_main_pallas.py::_kernel (K3, main_pass_pallas)
// and its noise pre-kernel _noise_hoist_kernel (K3h, _noise_hoist_planes).
// The TPU kernel re-expresses each depth fetch as a one-hot MXU matmul over
// per-tile mip windows with a hi/lo bf16 split, because Mosaic has no
// per-lane gather. A GPU thread loads any texel directly, so K3 follows
// tpurt's XLA main_pass (tpurt/passes/gtao.py:402-623): point sampling of
// the 5-level R16F pyramid with main_pass's mip selection (log2).
//
// K3h, gtao_noise_kernel: everything that depends only on the 64x64 noise
// texel and the slice / step index, computed once per texel instead of once
// per pixel: per slice cos(phi) and sin(phi), per slice and step
// powf(s, sample_distribution_power), with the expressions K3 used inline
// (the same slice_k, the double step noise, fmodf, the division by steps).
// Table layout: plane (2 + steps) * slice + {0: cos, 1: sin, 2 + step: pow}
// of (slices * (2 + steps), 4096) f32, texel (y & 63) * 64 + (x & 63); 45
// planes (0.74 MB, resident in L2) at ULTRA. It is built anew for every
// launch of K3: the noise index cycles through 64 values.
//
// K3, gtao_main_kernel: one thread per pixel in 16x8 blocks (a warp covers
// 16x2 pixels), so a block's samples, which cluster within 2^(m+4) texels
// of the pixel at mip m, share L1 lines. It computes a band of rows inside
// the image: output row i is image row row_start + i. tpurt's Pallas route
// computes a 32-row-aligned superset of a band and its XLA route clamps
// halo rows past the image's edges (tpurt/passes/gtao.py:736-774); the
// port's band + halo stops at the edges (passes/gtao.py compute_ao_band),
// so the grid covers just the band's rows. Every pixel reads the whole
// pyramid, normals and noise at its image position, so a band's rows carry
// the whole frame's bits. row_start = 0 with h rows is the whole frame.
// The slice and step counts are template parameters for the four presets
// (1,2), (2,2), (3,3), (9,3), so
// the step loop unrolls and the depth loads of both sides of every step of
// a slice issue together before any is used; other counts take the generic
// instantiation (0, 0) with runtime counts, one step at a time. The table
// is read through L1: staging a block's 128 texels of it in shared memory
// measured 1.10x slower (PERF.md).
//
// What bounds it on an H100: instruction issue, not bytes. A pixel at ULTRA
// takes 54 scattered depth loads (mostly L1/L2 hits) and, after the table,
// per slice 5 cosf/sinf and per step a log2f, with IEEE divides and sqrtf
// throughout; the bound in chip_smoke.py counts each as one operation.
//
// Variants (template flags, one instantiation each per preset; the exact
// path keeps its operations, so its bits are its parent's):
//   * BENT: XeGTAO "Algorithm 2" per slice in main_pass's order
//     (tpurt/passes/gtao.py:596-608): t0v, t1v, the local bent normal, its
//     rotation from -z to the view vector (precomputed per pixel), the
//     accumulator weighted by the projected normal's length; the output is
//     the packed RGBA8 of (visibility / 1.5, normalized bent normal) as
//     uint32. Edges are unchanged. It costs 3 accumulators and 10 sinf/cosf
//     per slice.
//   * HALF: every fetched horizon depth rounded to bf16 (round to nearest
//     even), tpurt's Pallas precision "half" (rec.astype(bfloat16) with
//     the recentering c = 0).
//   * LP: tpurt's fp16 (min16float) emulation. Every lpfloat intermediate
//     goes through lp(x) = __half2float(__float2half_rn(x)) after its
//     operation (csrc/gtao_common.cuh), in the plain version's order; dot products and norms sum
//     rounded products in f32 and round once (jnp.sum over f16); screen
//     and sample positions and their deltas stay f32; literals meeting an
//     lpfloat operand are their f16 nearest (h16); the cross product keeps
//     its first product unrounded, as XLA:CPU contracts tpurt's jnp.cross
//     into a fused multiply-subtract; the constants vector is
//     engine/convert.gtao_tensors' "vec16". K3h's LP table holds the
//     rounded cos, sin and pow.
//
// Exactness: the operation order is main_pass's (dot products and norms sum
// left to right; the scalar block arrives precomputed as
// engine/convert.gtao_tensors makes it); min/max/clamp propagate NaN; the
// library is built with --fmad=false and without fast math, so the plain
// PyTorch version (kernels/gtao_main.py) calls the same device math, and
// the table holds the bits the inline expressions gave.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gtao_common.cuh"

namespace {

using namespace gtao;

constexpr float PI_F = 3.1415926535897932384626433832795f;
constexpr float PI_HALF_F = 1.5707963267948966192313216916398f;
constexpr double PI_D = 3.1415926535897932384626433832795;
constexpr double PI_HALF_D = 1.5707963267948966192313216916398;
constexpr int NOISE_TEXELS = 4096;
constexpr int TILE_X = 16, TILE_Y = 8;

// constants vector layout: engine/convert.py GTAO_VEC
enum {
  C_PIX_X, C_PIX_Y, C_NDC_MUL_X, C_NDC_MUL_Y, C_NDC_ADD_X, C_NDC_ADD_Y,
  C_EFFECT_RADIUS, C_SDP, C_THIN_MUL, C_FALLOFF_MUL, C_FALLOFF_ADD,
  C_FINAL_POWER, C_MIP_OFFSET, C_NDC_MUL_X_PIX, C_COUNT
};

// the instantiations tpurt_gtao_main takes (kernels/gtao_main.py _MODES)
enum { MODE_EXACT, MODE_BENT, MODE_HALF, MODE_LP, MODE_BENT_LP };

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}
__device__ __forceinline__ float fast_sqrt(float x) {
  return __int_as_float(0x1FBD1DF5 + (__float_as_int(x) >> 1));
}

template <bool LP>
__device__ __forceinline__ float fast_acos(float x) {
  const float ax = fabsf(x);
  float res = lp<LP>(lp<LP>(lit<LP>(-0.156583) * ax) + lit<LP>(PI_HALF_D));
  // the bit-trick root and the result are f32 either way
  res = res * fast_sqrt(nmax(lp<LP>(lit<LP>(1.0) - ax), 0.0f));
  return x >= 0.0f ? res : PI_F - res;
}

// the five mips, passed by value
struct Mips {
  const float* level[5];
  int h[5], w[5];
};

// the level is picked by selects over constant indices: indexing the
// by-value struct at a runtime index would copy it to local memory
__device__ __forceinline__ float sample_mip(const Mips& m, int mip, float ux,
                                            float uy) {
  const float* level = m.level[0];
  int hm = m.h[0], wm = m.w[0];
#pragma unroll
  for (int i = 1; i < 5; ++i) {
    if (mip == i) {
      level = m.level[i];
      hm = m.h[i];
      wm = m.w[i];
    }
  }
  int x = (int)(ux * (float)wm);
  int y = (int)(uy * (float)hm);
  x = min(max(x, 0), wm - 1);
  y = min(max(y, 0), hm - 1);
  return __ldg(level + y * wm + x);
}

// K3h: one thread per noise texel and slice
template <bool LP>
__global__ void __launch_bounds__(128)
gtao_noise_kernel(const float* __restrict__ noise,
                  const float* __restrict__ cv, int slice_count, int steps,
                  float* __restrict__ table) {
  const int texel = blockIdx.x * blockDim.x + threadIdx.x;
  const int si = blockIdx.y;
  if (texel >= NOISE_TEXELS) return;
  const float noise_slice = lp<LP>(noise[texel]);
  const float noise_sample = lp<LP>(noise[NOISE_TEXELS + texel]);
  const float sdp = cv[C_SDP];
  float* out = table + (size_t)si * (2 + steps) * NOISE_TEXELS + texel;
  const float slice_k =
      lp<LP>(lp<LP>((float)si + noise_slice) / (float)slice_count);
  const float phi = lp<LP>(slice_k * lit<LP>(PI_D));
  out[0] = lp<LP>(cosf(phi));
  out[NOISE_TEXELS] = lp<LP>(sinf(phi));
  for (int st = 0; st < steps; ++st) {
    const float step_base_noise =
        lit<LP>((double)(si + st * steps) * 0.6180339887498948482);
    const float step_noise =
        fmodf(lp<LP>(noise_sample + step_base_noise), 1.0f);
    const float s = lp<LP>(lp<LP>((float)st + step_noise) / (float)steps);
    out[(2 + st) * NOISE_TEXELS] = lp<LP>(powf(s, sdp));
  }
}

// K3. SLICES / STEPS > 0 fix the counts at compile time; 0 reads the
// runtime counts. ao_out is u8, or uint32 with BENT.
template <int SLICES, int STEPS, bool BENT, bool HALF, bool LP>
__global__ void __launch_bounds__(TILE_X * TILE_Y)
gtao_main_kernel(const Mips m, const float* __restrict__ normal_enc,
                 const float* __restrict__ cv,
                 const float* __restrict__ table, int h, int w,
                 int row_start, int num_rows, int slice_count_rt,
                 int steps_rt, void* __restrict__ ao_out,
                 uint8_t* __restrict__ edges_out) {
  const int slice_count = SLICES > 0 ? SLICES : slice_count_rt;
  const int steps = STEPS > 0 ? STEPS : steps_rt;
  const int planes_per_slice = 2 + steps;
  const int x = blockIdx.x * TILE_X + threadIdx.x;
  // output row `row` of the band is image row y
  const int row = blockIdx.y * TILE_Y + threadIdx.y;
  if (x >= w || row >= num_rows) return;
  const int y = row_start + row;
  const int texel = (y & 63) * 64 + (x & 63);
  const int idx = y * w + x;
  const int out_idx = row * w + x;
  // jnp.maximum's 1e-20 guard in the lpfloat type (f16 flushes it to 0)
  const float eps = LP ? 0.0f : 1e-20f;
  // the projected normal's guard: the least f16 normal with LP
  const float pn_eps = LP ? h16(6.104e-05) : 1e-20f;

  float c[C_COUNT];
#pragma unroll
  for (int i = 0; i < C_COUNT; ++i) c[i] = __ldg(cv + i);

  const float sp_x = ((float)x + 0.5f) / (float)w;
  const float sp_y = ((float)y + 0.5f) / (float)h;

  // edges (XeGTAO_CalculateEdges + XeGTAO_PackEdges)
  const float* d0 = m.level[0];  // mip 0 is (h, w)
  float vz = __ldg(d0 + idx);
  const float e_l = lp<LP>(__ldg(d0 + y * w + max(x - 1, 0)) - vz);
  const float e_r = lp<LP>(__ldg(d0 + y * w + min(x + 1, w - 1)) - vz);
  const float e_t = lp<LP>(__ldg(d0 + max(y - 1, 0) * w + x) - vz);
  const float e_b = lp<LP>(__ldg(d0 + min(y + 1, h - 1) * w + x) - vz);
  const float slope_lr = lp<LP>(lp<LP>(e_r - e_l) * 0.5f);
  const float slope_tb = lp<LP>(lp<LP>(e_b - e_t) * 0.5f);
  const float denom = lp<LP>(vz * lit<LP>(0.011));
  auto edge_q = [&](float e, float adj) {
    const float em = nmin(fabsf(e), fabsf(adj));
    const float edge =
        clip(lp<LP>(lit<LP>(1.25) - lp<LP>(em / denom)), 0.0f, 1.0f);
    return rintf(lp<LP>(clip(edge, 0.0f, 1.0f) * lit<LP>(2.9)));
  };
  const float packed = edge_q(e_l, lp<LP>(e_l + slope_lr)) * 64.0f +
                       edge_q(e_r, lp<LP>(e_r - slope_lr)) * 16.0f +
                       edge_q(e_t, lp<LP>(e_t + slope_tb)) * 4.0f +
                       edge_q(e_b, lp<LP>(e_b - slope_tb));
  edges_out[out_idx] = (uint8_t)(int)packed;

  // decode the view normal (f32, then lpfloat)
  float nx = __ldg(normal_enc + 3 * idx) * 2.0f - 1.0f;
  float ny = __ldg(normal_enc + 3 * idx + 1) * 2.0f - 1.0f;
  float nz = __ldg(normal_enc + 3 * idx + 2) * 2.0f - 1.0f;
  const float nlen = nmax(sqrtf(nx * nx + ny * ny + nz * nz), 1e-20f);
  nx = lp<LP>(nx / nlen);
  ny = lp<LP>(ny / nlen);
  nz = lp<LP>(nz / nlen);

  vz = lp<LP>(vz * lit<LP>(0.99920));
  const float px = (c[C_NDC_MUL_X] * sp_x + c[C_NDC_ADD_X]) * vz;
  const float py = (c[C_NDC_MUL_Y] * sp_y + c[C_NDC_ADD_Y]) * vz;
  const float pz = vz;
  const float plen = nmax(sqrtf(px * px + py * py + pz * pz), 1e-20f);
  const float vx = lp<LP>(-px / plen), vy = lp<LP>(-py / plen),
              vzv = lp<LP>(-pz / plen);

  const float ssr =
      lp<LP>(c[C_EFFECT_RADIUS] / lp<LP>(vz * c[C_NDC_MUL_X_PIX]));
  float visibility = lp<LP>(
      clip(lp<LP>(lp<LP>(lit<LP>(10.0) - ssr) / lit<LP>(100.0)), 0.0f,
           1.0f) *
      lit<LP>(0.5));
  const float min_s = lp<LP>(lit<LP>(1.3) / ssr);

  // BENT: XeGTAO_RotFromToMatrix from (0, 0, -1) to the view vector, and
  // the bent normal's accumulator
  float rot[3][3] = {};
  bool near_identity = false;
  float bent[3] = {0.0f, 0.0f, 0.0f};
  if constexpr (BENT) {
    const float e = -vzv;
    const float rvx = vy, rvy = -vx;
    const float hr = lp<LP>(lit<LP>(1.0) /
                            nmax(lp<LP>(lit<LP>(1.0) + e), lit<LP>(1e-6)));
    const float m01 = lp<LP>(lp<LP>(hr * rvx) * rvy);
    rot[0][0] = lp<LP>(e + lp<LP>(lp<LP>(hr * rvx) * rvx));
    rot[0][1] = m01;
    rot[0][2] = rvy;
    rot[1][0] = m01;
    rot[1][1] = lp<LP>(e + lp<LP>(lp<LP>(hr * rvy) * rvy));
    rot[1][2] = -rvx;
    rot[2][0] = -rvy;
    rot[2][1] = rvx;
    rot[2][2] = e;
    near_identity = fabsf(e) > lit<LP>(1.0 - 0.0003);
  }

  // the steps issued together: all of a slice's with fixed counts
  constexpr int BATCH = STEPS > 0 ? STEPS : 1;

#pragma unroll 1
  for (int si = 0; si < slice_count; ++si) {
    const float* plane =
        table + (size_t)si * planes_per_slice * NOISE_TEXELS + texel;
    const float cos_phi = plane[0];
    const float sin_phi = plane[NOISE_TEXELS];
    const float omega_x = lp<LP>(cos_phi * ssr);
    const float omega_y = lp<LP>(-sin_phi * ssr);

    const float dd = lp<LP>(lp<LP>(cos_phi * vx) + lp<LP>(sin_phi * vy) +
                            lp<LP>(0.0f * vzv));
    const float ox = lp<LP>(cos_phi - lp<LP>(dd * vx)),
                oy = lp<LP>(sin_phi - lp<LP>(dd * vy)),
                oz = lp<LP>(0.0f - lp<LP>(dd * vzv));
    // the cross product as XLA:CPU runs tpurt's jnp.cross: a * b - c * d
    // contracted, so the first product stays unrounded (exact in f32 for
    // f16 operands)
    float ax = lp<LP>(oy * vzv - lp<LP>(oz * vy)),
          ay = lp<LP>(oz * vx - lp<LP>(ox * vzv)),
          az = lp<LP>(ox * vy - lp<LP>(oy * vx));
    const float alen = nmax(lp<LP>(sqrtf(lp<LP>(
                                lp<LP>(ax * ax) + lp<LP>(ay * ay) +
                                lp<LP>(az * az)))),
                            eps);
    ax = lp<LP>(ax / alen);
    ay = lp<LP>(ay / alen);
    az = lp<LP>(az / alen);

    const float na =
        lp<LP>(lp<LP>(nx * ax) + lp<LP>(ny * ay) + lp<LP>(nz * az));
    const float pnx = lp<LP>(nx - lp<LP>(ax * na)),
                pny = lp<LP>(ny - lp<LP>(ay * na)),
                pnz = lp<LP>(nz - lp<LP>(az * na));
    const float sign_norm = sign_of(
        lp<LP>(lp<LP>(ox * pnx) + lp<LP>(oy * pny) + lp<LP>(oz * pnz)));
    float pn_len = lp<LP>(sqrtf(
        lp<LP>(lp<LP>(pnx * pnx) + lp<LP>(pny * pny) + lp<LP>(pnz * pnz))));
    const float cos_norm = clip(
        lp<LP>(lp<LP>(lp<LP>(pnx * vx) + lp<LP>(pny * vy) +
                      lp<LP>(pnz * vzv)) /
               nmax(pn_len, pn_eps)),
        0.0f, 1.0f);
    const float n_angle = lp<LP>(sign_norm * lp<LP>(fast_acos<LP>(cos_norm)));

    const float low0 = lp<LP>(cosf(lp<LP>(n_angle + lit<LP>(PI_HALF_D))));
    const float low1 = lp<LP>(cosf(lp<LP>(n_angle - lit<LP>(PI_HALF_D))));
    float h0c = low0, h1c = low1;
    for (int st0 = 0; st0 < steps; st0 += BATCH) {
      // every step's sample positions and depth loads first ...
      float sx[BATCH][2], sy[BATCH][2], sz[BATCH][2];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int st = st0 + b;
        if (STEPS == 0 && st >= steps) break;
        const float s = lp<LP>(plane[(2 + st) * NOISE_TEXELS] + min_s);
        const float so_x = lp<LP>(s * omega_x), so_y = lp<LP>(s * omega_y);
        const float so_len =
            lp<LP>(sqrtf(lp<LP>(lp<LP>(so_x * so_x) + lp<LP>(so_y * so_y))));
        const float mip_level =
            clip(lp<LP>(lp<LP>(log2f(nmax(so_len, eps))) - c[C_MIP_OFFSET]),
                 0.0f, 5.0f);
        const int mip = min(max((int)rintf(mip_level), 0), 4);
        const float sox = lp<LP>(rintf(so_x) * c[C_PIX_X]);
        const float soy = lp<LP>(rintf(so_y) * c[C_PIX_Y]);
        sx[b][0] = sp_x + sox;
        sy[b][0] = sp_y + soy;
        sx[b][1] = sp_x - sox;
        sy[b][1] = sp_y - soy;
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          sz[b][side] = sample_mip(m, mip, clip(sx[b][side], 0.0f, 1.0f),
                                   clip(sy[b][side], 0.0f, 1.0f));
          if constexpr (HALF)
            sz[b][side] = __bfloat162float(__float2bfloat16_rn(sz[b][side]));
        }
      }
      // ... then the horizons, in step order
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        if (STEPS == 0 && st0 + b >= steps) break;
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          const float low = side == 0 ? low0 : low1;
          const float qx = (c[C_NDC_MUL_X] * sx[b][side] + c[C_NDC_ADD_X]) *
                           sz[b][side];
          const float qy = (c[C_NDC_MUL_Y] * sy[b][side] + c[C_NDC_ADD_Y]) *
                           sz[b][side];
          const float dx = qx - px, dy = qy - py, dz = sz[b][side] - pz;
          const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
          const float dmax = nmax(dist, 1e-20f);
          const float hx = lp<LP>(dx / dmax), hy = lp<LP>(dy / dmax),
                      hz = lp<LP>(dz / dmax);
          const float fx = lp<LP>(dx), fy = lp<LP>(dy),
                      fz = lp<LP>(dz * c[C_THIN_MUL]);
          const float falloff_base = lp<LP>(sqrtf(lp<LP>(
              lp<LP>(lp<LP>(fx * fx) + lp<LP>(fy * fy)) + lp<LP>(fz * fz))));
          const float weight = clip(
              lp<LP>(lp<LP>(falloff_base * c[C_FALLOFF_MUL]) +
                     c[C_FALLOFF_ADD]),
              0.0f, 1.0f);
          float shc =
              lp<LP>(lp<LP>(hx * vx) + lp<LP>(hy * vy) + lp<LP>(hz * vzv));
          shc = lp<LP>(low + lp<LP>(lp<LP>(shc - low) * weight));
          if (side == 0) h0c = nmax(h0c, shc);
          else h1c = nmax(h1c, shc);
        }
      }
    }

    pn_len = lp<LP>(pn_len + lp<LP>(lp<LP>(lit<LP>(1.0) - pn_len) *
                                    lit<LP>(0.05)));
    const float hh0 = -lp<LP>(fast_acos<LP>(clip(h1c, -1.0f, 1.0f)));
    const float hh1 = lp<LP>(fast_acos<LP>(clip(h0c, -1.0f, 1.0f)));
    const float sin_n = lp<LP>(sinf(n_angle));
    const float two0 = lp<LP>(lit<LP>(2.0) * hh0);
    const float two1 = lp<LP>(lit<LP>(2.0) * hh1);
    const float iarc0 = lp<LP>(
        lp<LP>(lp<LP>(cos_norm + lp<LP>(two0 * sin_n)) -
               lp<LP>(cosf(lp<LP>(two0 - n_angle)))) /
        lit<LP>(4.0));
    const float iarc1 = lp<LP>(
        lp<LP>(lp<LP>(cos_norm + lp<LP>(two1 * sin_n)) -
               lp<LP>(cosf(lp<LP>(two1 - n_angle)))) /
        lit<LP>(4.0));
    visibility = lp<LP>(visibility + lp<LP>(pn_len * lp<LP>(iarc0 + iarc1)));

    if constexpr (BENT) {
      // "Algorithm 2" directional component (XeGTAO.hlsli:548-554)
      const float three0 = lp<LP>(lp<LP>(lit<LP>(3.0) * hh0) - n_angle);
      const float three1 = lp<LP>(lp<LP>(lit<LP>(3.0) * hh1) - n_angle);
      const float plus0 = lp<LP>(hh0 + n_angle);
      const float plus1 = lp<LP>(hh1 + n_angle);
      float t0v = lp<LP>(lp<LP>(lit<LP>(6.0) *
                                lp<LP>(sinf(lp<LP>(hh0 - n_angle)))) -
                         lp<LP>(sinf(three0)));
      t0v = lp<LP>(t0v + lp<LP>(lit<LP>(6.0) *
                                lp<LP>(sinf(lp<LP>(hh1 - n_angle)))));
      t0v = lp<LP>(t0v - lp<LP>(sinf(three1)));
      t0v = lp<LP>(t0v + lp<LP>(lit<LP>(16.0) * sin_n));
      t0v = lp<LP>(t0v - lp<LP>(lit<LP>(3.0) *
                                lp<LP>(lp<LP>(sinf(plus0)) +
                                       lp<LP>(sinf(plus1)))));
      t0v = lp<LP>(t0v / lit<LP>(12.0));
      float t1v = lp<LP>(-lp<LP>(cosf(three0)) - lp<LP>(cosf(three1)));
      t1v = lp<LP>(t1v + lp<LP>(lit<LP>(8.0) * lp<LP>(cosf(n_angle))));
      t1v = lp<LP>(t1v - lp<LP>(lit<LP>(3.0) *
                                lp<LP>(lp<LP>(cosf(plus0)) +
                                       lp<LP>(cosf(plus1)))));
      t1v = lp<LP>(t1v / lit<LP>(12.0));
      const float local[3] = {lp<LP>(cos_phi * t0v), lp<LP>(sin_phi * t0v),
                              -t1v};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float ri = lp<LP>(lp<LP>(lp<LP>(rot[i][0] * local[0]) +
                                 lp<LP>(rot[i][1] * local[1])) +
                          lp<LP>(rot[i][2] * local[2]));
        if (near_identity) ri = local[i];
        bent[i] = lp<LP>(bent[i] + lp<LP>(ri * pn_len));
      }
    }
  }

  visibility = lp<LP>(visibility / (float)slice_count);
  visibility = lp<LP>(powf(nmax(visibility, 0.0f), c[C_FINAL_POWER]));
  visibility = nmax(visibility, lit<LP>(0.03));
  const float vis_packed =
      clip(lp<LP>(visibility / lit<LP>(1.5)), 0.0f, 1.0f);
  if constexpr (BENT) {
    const float blen = nmax(
        lp<LP>(sqrtf(lp<LP>(lp<LP>(bent[0] * bent[0]) +
                            lp<LP>(bent[1] * bent[1]) +
                            lp<LP>(bent[2] * bent[2])))),
        eps);
    static_cast<uint32_t*>(ao_out)[out_idx] = encode_bent<LP>(
        vis_packed, lp<LP>(bent[0] / blen), lp<LP>(bent[1] / blen),
        lp<LP>(bent[2] / blen));
  } else {
    static_cast<uint8_t*>(ao_out)[out_idx] =
        (uint8_t)(int)(vis_packed * 255.0f + 0.5f);
  }
}

template <int SLICES, int STEPS, bool BENT, bool HALF, bool LP>
int launch_main(const Mips& m, const float* normal_enc, const float* consts,
                const float* table, int h, int w, int row_start,
                int num_rows, int slice_count, int steps, void* ao_out,
                uint8_t* edges_out, cudaStream_t stream) {
  const dim3 block(TILE_X, TILE_Y);
  const dim3 grid((w + TILE_X - 1) / TILE_X,
                  (num_rows + TILE_Y - 1) / TILE_Y);
  gtao_main_kernel<SLICES, STEPS, BENT, HALF, LP>
      <<<grid, block, 0, stream>>>(m, normal_enc, consts, table, h, w,
                                   row_start, num_rows, slice_count, steps,
                                   ao_out, edges_out);
  return (int)cudaGetLastError();
}

template <bool BENT, bool HALF, bool LP>
int launch_preset(const Mips& m, const float* normal_enc, const float* consts,
                  const float* table, int h, int w, int row_start,
                  int num_rows, int slice_count, int steps, void* ao_out,
                  uint8_t* edges_out, cudaStream_t stream) {
#define TPURT_PRESET(S, T)                                                  \
  if (slice_count == S && steps == T)                                       \
    return launch_main<S, T, BENT, HALF, LP>(                               \
        m, normal_enc, consts, table, h, w, row_start, num_rows,            \
        slice_count, steps, ao_out, edges_out, stream);
  // tpurt/passes/gtao.py:53-56: LOW, MEDIUM, HIGH, ULTRA
  TPURT_PRESET(1, 2)
  TPURT_PRESET(2, 2)
  TPURT_PRESET(3, 3)
  TPURT_PRESET(9, 3)
#undef TPURT_PRESET
  return launch_main<0, 0, BENT, HALF, LP>(m, normal_enc, consts, table, h,
                                           w, row_start, num_rows,
                                           slice_count, steps, ao_out,
                                           edges_out, stream);
}

}  // namespace

extern "C" {

// K3h: noise (2, 64, 64) f32 -> table (slice_count * (2 + steps), 4096) f32;
// lp: the fp16 instantiation
int tpurt_gtao_noise_table(const float* noise, const float* consts,
                           int slice_count, int steps, int lp, float* table,
                           cudaStream_t stream) {
  if (slice_count <= 0 || steps <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((NOISE_TEXELS + 127) / 128, slice_count);
  if (lp)
    gtao_noise_kernel<true><<<grid, 128, 0, stream>>>(noise, consts,
                                                      slice_count, steps,
                                                      table);
  else
    gtao_noise_kernel<false><<<grid, 128, 0, stream>>>(noise, consts,
                                                       slice_count, steps,
                                                       table);
  return (int)cudaGetLastError();
}

// K3. mips: host array of the 5 device pointers; dims: host array of the 5
// heights then the 5 widths; table: K3h's output for the same counts and
// precision; mode: MODE_*; ao_out and edges_out: (num_rows, w), row i the
// image's row row_start + i, inside the image (row_start = 0, num_rows = h:
// the whole image); ao_out is u8, or uint32 for the bent modes.
int tpurt_gtao_main(const float* const* mips, const int* dims,
                    const float* normal_enc, const float* consts,
                    const float* table, int h, int w, int row_start,
                    int num_rows, int slice_count, int steps, int mode,
                    void* ao_out, uint8_t* edges_out, cudaStream_t stream) {
  if (slice_count <= 0 || steps <= 0 || row_start < 0 ||
      row_start + num_rows > h)
    return (int)cudaErrorInvalidValue;
  if (h <= 0 || w <= 0 || num_rows <= 0) return (int)cudaGetLastError();
  Mips m;
  for (int i = 0; i < 5; ++i) {
    m.level[i] = mips[i];
    m.h[i] = dims[i];
    m.w[i] = dims[5 + i];
  }
  switch (mode) {
    case MODE_EXACT:
      return launch_preset<false, false, false>(
          m, normal_enc, consts, table, h, w, row_start, num_rows,
          slice_count, steps, ao_out, edges_out, stream);
    case MODE_BENT:
      return launch_preset<true, false, false>(
          m, normal_enc, consts, table, h, w, row_start, num_rows,
          slice_count, steps, ao_out, edges_out, stream);
    case MODE_HALF:
      return launch_preset<false, true, false>(
          m, normal_enc, consts, table, h, w, row_start, num_rows,
          slice_count, steps, ao_out, edges_out, stream);
    case MODE_LP:
      return launch_preset<false, false, true>(
          m, normal_enc, consts, table, h, w, row_start, num_rows,
          slice_count, steps, ao_out, edges_out, stream);
    case MODE_BENT_LP:
      return launch_preset<true, false, true>(
          m, normal_enc, consts, table, h, w, row_start, num_rows,
          slice_count, steps, ao_out, edges_out, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

// XeGTAO main pass, one thread per pixel.
//
// Replaces tpurt/kernels/gtao_main_pallas.py::_kernel (K3, main_pass_pallas)
// together with its noise pre-kernel _noise_hoist_kernel (K3h,
// _noise_hoist_planes). The TPU kernel re-expresses each depth fetch as a
// one-hot MXU matmul over per-tile mip windows with a hi/lo bf16 split,
// because Mosaic has no per-lane gather; the hoist exists to give its
// noise-only transcendentals the same lowering. A GPU thread loads any texel
// directly, so this kernel follows tpurt's XLA main_pass
// (tpurt/passes/gtao.py:402-623) instead: point sampling of the 5-level R16F
// pyramid with main_pass's mip selection (log2), and the slice cos/sin and
// the sample-distribution pow computed inline per pixel.
//
// What bounds it on an H100: arithmetic and special functions, not bytes.
// At ULTRA (9 slices x 3 steps x 2 directions) a pixel takes 54 scattered
// depth loads (mostly L1/L2 hits: samples cluster within 2^(m+4) texels of
// the pixel at mip m) and ~40 transcendentals. The design keeps each thread
// independent and its state in registers; neighbouring threads fetch
// neighbouring texels, so the loads coalesce where the samples agree.
//
// Exactness: the operation order is main_pass's (dot products and norms sum
// left to right; the scalar block arrives precomputed as
// engine/convert.gtao_tensors makes it); min/max/clamp propagate NaN; the
// library is built with --fmad=false and without fast math, so the plain
// PyTorch version (kernels/gtao_main.py) calls the same device math.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float PI_F = 3.1415926535897932384626433832795f;
constexpr float PI_HALF_F = 1.5707963267948966192313216916398f;

// constants vector layout: engine/convert.py GTAO_VEC
enum {
  C_PIX_X, C_PIX_Y, C_NDC_MUL_X, C_NDC_MUL_Y, C_NDC_ADD_X, C_NDC_ADD_Y,
  C_EFFECT_RADIUS, C_SDP, C_THIN_MUL, C_FALLOFF_MUL, C_FALLOFF_ADD,
  C_FINAL_POWER, C_MIP_OFFSET, C_NDC_MUL_X_PIX, C_COUNT
};

__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return nmin(nmax(x, lo), hi);
}
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}
__device__ __forceinline__ float fast_sqrt(float x) {
  return __int_as_float(0x1FBD1DF5 + (__float_as_int(x) >> 1));
}
__device__ __forceinline__ float fast_acos(float x) {
  const float ax = fabsf(x);
  float res = -0.156583f * ax + PI_HALF_F;
  res = res * fast_sqrt(nmax(1.0f - ax, 0.0f));
  return x >= 0.0f ? res : PI_F - res;
}

struct Mips {
  const float* flat;
  int off[5], h[5], w[5];
};

__device__ __forceinline__ float sample_mip(const Mips& m, int mip, float ux,
                                            float uy) {
  const int hm = m.h[mip], wm = m.w[mip];
  int x = (int)(ux * (float)wm);
  int y = (int)(uy * (float)hm);
  x = min(max(x, 0), wm - 1);
  y = min(max(y, 0), hm - 1);
  return __ldg(m.flat + m.off[mip] + y * wm + x);
}

__global__ void __launch_bounds__(128)
gtao_main_kernel(const float* __restrict__ flat, const int* __restrict__ meta,
                 const float* __restrict__ normal_enc,
                 const float* __restrict__ cv, const float* __restrict__ noise,
                 int h, int w, int slice_count, int steps,
                 uint8_t* __restrict__ ao_out,
                 uint8_t* __restrict__ edges_out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= h * w) return;
  const int y = idx / w, x = idx - (idx / w) * w;

  Mips m;
  m.flat = flat;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    m.off[i] = meta[i];
    m.h[i] = meta[5 + i];
    m.w[i] = meta[10 + i];
  }
  float c[C_COUNT];
#pragma unroll
  for (int i = 0; i < C_COUNT; ++i) c[i] = __ldg(cv + i);

  const float sp_x = ((float)x + 0.5f) / (float)w;
  const float sp_y = ((float)y + 0.5f) / (float)h;

  // edges (XeGTAO_CalculateEdges + XeGTAO_PackEdges)
  const float* d0 = flat;  // mip 0 is (h, w) at offset 0
  float vz = d0[idx];
  const float e_l = d0[y * w + max(x - 1, 0)] - vz;
  const float e_r = d0[y * w + min(x + 1, w - 1)] - vz;
  const float e_t = d0[max(y - 1, 0) * w + x] - vz;
  const float e_b = d0[min(y + 1, h - 1) * w + x] - vz;
  const float slope_lr = (e_r - e_l) * 0.5f;
  const float slope_tb = (e_b - e_t) * 0.5f;
  const float denom = vz * 0.011f;
  auto edge_q = [&](float e, float adj) {
    const float em = nmin(fabsf(e), fabsf(adj));
    const float edge = clip(1.25f - em / denom, 0.0f, 1.0f);
    return rintf(clip(edge, 0.0f, 1.0f) * 2.9f);
  };
  const float packed = edge_q(e_l, e_l + slope_lr) * 64.0f +
                       edge_q(e_r, e_r - slope_lr) * 16.0f +
                       edge_q(e_t, e_t + slope_tb) * 4.0f +
                       edge_q(e_b, e_b - slope_tb);
  edges_out[idx] = (uint8_t)(int)packed;

  // decode the view normal
  float nx = normal_enc[3 * idx] * 2.0f - 1.0f;
  float ny = normal_enc[3 * idx + 1] * 2.0f - 1.0f;
  float nz = normal_enc[3 * idx + 2] * 2.0f - 1.0f;
  const float nlen = nmax(sqrtf(nx * nx + ny * ny + nz * nz), 1e-20f);
  nx = nx / nlen;
  ny = ny / nlen;
  nz = nz / nlen;

  vz = vz * 0.99920f;
  const float px = (c[C_NDC_MUL_X] * sp_x + c[C_NDC_ADD_X]) * vz;
  const float py = (c[C_NDC_MUL_Y] * sp_y + c[C_NDC_ADD_Y]) * vz;
  const float pz = vz;
  const float plen = nmax(sqrtf(px * px + py * py + pz * pz), 1e-20f);
  const float vx = -px / plen, vy = -py / plen, vzv = -pz / plen;

  const float ssr = c[C_EFFECT_RADIUS] / (vz * c[C_NDC_MUL_X_PIX]);
  float visibility = clip((10.0f - ssr) / 100.0f, 0.0f, 1.0f) * 0.5f;
  const float min_s = 1.3f / ssr;

  const float noise_slice = noise[(y & 63) * 64 + (x & 63)];
  const float noise_sample = noise[4096 + (y & 63) * 64 + (x & 63)];

  for (int si = 0; si < slice_count; ++si) {
    const float slice_k = ((float)si + noise_slice) / (float)slice_count;
    const float phi = slice_k * PI_F;
    const float cos_phi = cosf(phi);
    const float sin_phi = sinf(phi);
    const float omega_x = cos_phi * ssr;
    const float omega_y = -sin_phi * ssr;

    const float dd = cos_phi * vx + sin_phi * vy + 0.0f * vzv;
    const float ox = cos_phi - dd * vx, oy = sin_phi - dd * vy,
                oz = 0.0f - dd * vzv;
    float ax = oy * vzv - oz * vy, ay = oz * vx - ox * vzv,
          az = ox * vy - oy * vx;
    const float alen = nmax(sqrtf(ax * ax + ay * ay + az * az), 1e-20f);
    ax = ax / alen;
    ay = ay / alen;
    az = az / alen;

    const float na = nx * ax + ny * ay + nz * az;
    const float pnx = nx - ax * na, pny = ny - ay * na, pnz = nz - az * na;
    const float sign_norm = sign_of(ox * pnx + oy * pny + oz * pnz);
    float pn_len = sqrtf(pnx * pnx + pny * pny + pnz * pnz);
    const float cos_norm =
        clip((pnx * vx + pny * vy + pnz * vzv) / nmax(pn_len, 1e-20f), 0.0f,
             1.0f);
    const float n_angle = sign_norm * fast_acos(cos_norm);

    const float low0 = cosf(n_angle + PI_HALF_F);
    const float low1 = cosf(n_angle - PI_HALF_F);
    float h0c = low0, h1c = low1;
    for (int st = 0; st < steps; ++st) {
      const float step_base_noise =
          (float)((double)(si + st * steps) * 0.6180339887498948482);
      const float step_noise = fmodf(noise_sample + step_base_noise, 1.0f);
      float s = ((float)st + step_noise) / (float)steps;
      s = powf(s, c[C_SDP]) + min_s;

      const float so_x = s * omega_x, so_y = s * omega_y;
      const float so_len = sqrtf(so_x * so_x + so_y * so_y);
      const float mip_level =
          clip(log2f(nmax(so_len, 1e-20f)) - c[C_MIP_OFFSET], 0.0f, 5.0f);
      const int mip = min(max((int)rintf(mip_level), 0), 4);
      const float sox = rintf(so_x) * c[C_PIX_X];
      const float soy = rintf(so_y) * c[C_PIX_Y];

#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const float sx = side == 0 ? sp_x + sox : sp_x - sox;
        const float sy = side == 0 ? sp_y + soy : sp_y - soy;
        const float low = side == 0 ? low0 : low1;
        const float sz = sample_mip(m, mip, clip(sx, 0.0f, 1.0f),
                                    clip(sy, 0.0f, 1.0f));
        const float qx = (c[C_NDC_MUL_X] * sx + c[C_NDC_ADD_X]) * sz;
        const float qy = (c[C_NDC_MUL_Y] * sy + c[C_NDC_ADD_Y]) * sz;
        const float dx = qx - px, dy = qy - py, dz = sz - pz;
        const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
        const float dmax = nmax(dist, 1e-20f);
        const float hx = dx / dmax, hy = dy / dmax, hz = dz / dmax;
        const float dzt = dz * c[C_THIN_MUL];
        const float falloff_base = sqrtf(dx * dx + dy * dy + dzt * dzt);
        const float weight = clip(
            falloff_base * c[C_FALLOFF_MUL] + c[C_FALLOFF_ADD], 0.0f, 1.0f);
        float shc = hx * vx + hy * vy + hz * vzv;
        shc = low + (shc - low) * weight;
        if (side == 0) h0c = nmax(h0c, shc);
        else h1c = nmax(h1c, shc);
      }
    }

    pn_len = pn_len + (1.0f - pn_len) * 0.05f;
    const float hh0 = -fast_acos(clip(h1c, -1.0f, 1.0f));
    const float hh1 = fast_acos(clip(h0c, -1.0f, 1.0f));
    const float sin_n = sinf(n_angle);
    const float iarc0 =
        (cos_norm + 2.0f * hh0 * sin_n - cosf(2.0f * hh0 - n_angle)) / 4.0f;
    const float iarc1 =
        (cos_norm + 2.0f * hh1 * sin_n - cosf(2.0f * hh1 - n_angle)) / 4.0f;
    visibility = visibility + pn_len * (iarc0 + iarc1);
  }

  visibility = visibility / (float)slice_count;
  visibility = powf(nmax(visibility, 0.0f), c[C_FINAL_POWER]);
  visibility = nmax(visibility, 0.03f);
  const float vis_packed = clip(visibility / 1.5f, 0.0f, 1.0f);
  ao_out[idx] = (uint8_t)(int)(vis_packed * 255.0f + 0.5f);
}

}  // namespace

extern "C" int tpurt_gtao_main(const float* flat, const int* meta,
                               const float* normal_enc, const float* consts,
                               const float* noise, int h, int w,
                               int slice_count, int steps, uint8_t* ao_out,
                               uint8_t* edges_out, cudaStream_t stream) {
  const int n = h * w;
  if (n > 0) {
    gtao_main_kernel<<<(n + 127) / 128, 128, 0, stream>>>(
        flat, meta, normal_enc, consts, noise, h, w, slice_count, steps,
        ao_out, edges_out);
  }
  return (int)cudaGetLastError();
}

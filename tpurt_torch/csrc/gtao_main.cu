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
// of the pixel at mip m, share L1 lines. The slice and step counts are
// template parameters for the four presets (1,2), (2,2), (3,3), (9,3), so
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
// Exactness: the operation order is main_pass's (dot products and norms sum
// left to right; the scalar block arrives precomputed as
// engine/convert.gtao_tensors makes it); min/max/clamp propagate NaN; the
// library is built with --fmad=false and without fast math, so the plain
// PyTorch version (kernels/gtao_main.py) calls the same device math, and
// the table holds the bits the inline expressions gave.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float PI_F = 3.1415926535897932384626433832795f;
constexpr float PI_HALF_F = 1.5707963267948966192313216916398f;
constexpr int NOISE_TEXELS = 4096;
constexpr int TILE_X = 16, TILE_Y = 8;

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
__global__ void __launch_bounds__(128)
gtao_noise_kernel(const float* __restrict__ noise,
                  const float* __restrict__ cv, int slice_count, int steps,
                  float* __restrict__ table) {
  const int texel = blockIdx.x * blockDim.x + threadIdx.x;
  const int si = blockIdx.y;
  if (texel >= NOISE_TEXELS) return;
  const float noise_slice = noise[texel];
  const float noise_sample = noise[NOISE_TEXELS + texel];
  const float sdp = cv[C_SDP];
  float* out = table + (size_t)si * (2 + steps) * NOISE_TEXELS + texel;
  const float slice_k = ((float)si + noise_slice) / (float)slice_count;
  const float phi = slice_k * PI_F;
  out[0] = cosf(phi);
  out[NOISE_TEXELS] = sinf(phi);
  for (int st = 0; st < steps; ++st) {
    const float step_base_noise =
        (float)((double)(si + st * steps) * 0.6180339887498948482);
    const float step_noise = fmodf(noise_sample + step_base_noise, 1.0f);
    const float s = ((float)st + step_noise) / (float)steps;
    out[(2 + st) * NOISE_TEXELS] = powf(s, sdp);
  }
}

// K3. SLICES / STEPS > 0 fix the counts at compile time; 0 reads the
// runtime counts.
template <int SLICES, int STEPS>
__global__ void __launch_bounds__(TILE_X * TILE_Y)
gtao_main_kernel(const Mips m, const float* __restrict__ normal_enc,
                 const float* __restrict__ cv,
                 const float* __restrict__ table, int h, int w,
                 int slice_count_rt, int steps_rt,
                 uint8_t* __restrict__ ao_out,
                 uint8_t* __restrict__ edges_out) {
  const int slice_count = SLICES > 0 ? SLICES : slice_count_rt;
  const int steps = STEPS > 0 ? STEPS : steps_rt;
  const int planes_per_slice = 2 + steps;
  const int x = blockIdx.x * TILE_X + threadIdx.x;
  const int y = blockIdx.y * TILE_Y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int texel = (y & 63) * 64 + (x & 63);
  const int idx = y * w + x;

  float c[C_COUNT];
#pragma unroll
  for (int i = 0; i < C_COUNT; ++i) c[i] = __ldg(cv + i);

  const float sp_x = ((float)x + 0.5f) / (float)w;
  const float sp_y = ((float)y + 0.5f) / (float)h;

  // edges (XeGTAO_CalculateEdges + XeGTAO_PackEdges)
  const float* d0 = m.level[0];  // mip 0 is (h, w)
  float vz = __ldg(d0 + idx);
  const float e_l = __ldg(d0 + y * w + max(x - 1, 0)) - vz;
  const float e_r = __ldg(d0 + y * w + min(x + 1, w - 1)) - vz;
  const float e_t = __ldg(d0 + max(y - 1, 0) * w + x) - vz;
  const float e_b = __ldg(d0 + min(y + 1, h - 1) * w + x) - vz;
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
  float nx = __ldg(normal_enc + 3 * idx) * 2.0f - 1.0f;
  float ny = __ldg(normal_enc + 3 * idx + 1) * 2.0f - 1.0f;
  float nz = __ldg(normal_enc + 3 * idx + 2) * 2.0f - 1.0f;
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

  // the steps issued together: all of a slice's with fixed counts
  constexpr int BATCH = STEPS > 0 ? STEPS : 1;

#pragma unroll 1
  for (int si = 0; si < slice_count; ++si) {
    const float* plane =
        table + (size_t)si * planes_per_slice * NOISE_TEXELS + texel;
    const float cos_phi = plane[0];
    const float sin_phi = plane[NOISE_TEXELS];
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
    for (int st0 = 0; st0 < steps; st0 += BATCH) {
      // every step's sample positions and depth loads first ...
      float sx[BATCH][2], sy[BATCH][2], sz[BATCH][2];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int st = st0 + b;
        if (STEPS == 0 && st >= steps) break;
        const float s = plane[(2 + st) * NOISE_TEXELS] + min_s;
        const float so_x = s * omega_x, so_y = s * omega_y;
        const float so_len = sqrtf(so_x * so_x + so_y * so_y);
        const float mip_level =
            clip(log2f(nmax(so_len, 1e-20f)) - c[C_MIP_OFFSET], 0.0f, 5.0f);
        const int mip = min(max((int)rintf(mip_level), 0), 4);
        const float sox = rintf(so_x) * c[C_PIX_X];
        const float soy = rintf(so_y) * c[C_PIX_Y];
        sx[b][0] = sp_x + sox;
        sy[b][0] = sp_y + soy;
        sx[b][1] = sp_x - sox;
        sy[b][1] = sp_y - soy;
#pragma unroll
        for (int side = 0; side < 2; ++side)
          sz[b][side] = sample_mip(m, mip, clip(sx[b][side], 0.0f, 1.0f),
                                   clip(sy[b][side], 0.0f, 1.0f));
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
          const float hx = dx / dmax, hy = dy / dmax, hz = dz / dmax;
          const float dzt = dz * c[C_THIN_MUL];
          const float falloff_base = sqrtf(dx * dx + dy * dy + dzt * dzt);
          const float weight =
              clip(falloff_base * c[C_FALLOFF_MUL] + c[C_FALLOFF_ADD], 0.0f,
                   1.0f);
          float shc = hx * vx + hy * vy + hz * vzv;
          shc = low + (shc - low) * weight;
          if (side == 0) h0c = nmax(h0c, shc);
          else h1c = nmax(h1c, shc);
        }
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

template <int SLICES, int STEPS>
int launch_main(const Mips& m, const float* normal_enc, const float* consts,
                const float* table, int h, int w, int slice_count, int steps,
                uint8_t* ao_out, uint8_t* edges_out, cudaStream_t stream) {
  const dim3 block(TILE_X, TILE_Y);
  const dim3 grid((w + TILE_X - 1) / TILE_X, (h + TILE_Y - 1) / TILE_Y);
  gtao_main_kernel<SLICES, STEPS><<<grid, block, 0, stream>>>(
      m, normal_enc, consts, table, h, w, slice_count, steps, ao_out,
      edges_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K3h: noise (2, 64, 64) f32 -> table (slice_count * (2 + steps), 4096) f32
int tpurt_gtao_noise_table(const float* noise, const float* consts,
                           int slice_count, int steps, float* table,
                           cudaStream_t stream) {
  if (slice_count <= 0 || steps <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((NOISE_TEXELS + 127) / 128, slice_count);
  gtao_noise_kernel<<<grid, 128, 0, stream>>>(noise, consts, slice_count,
                                              steps, table);
  return (int)cudaGetLastError();
}

// K3. mips: host array of the 5 device pointers; dims: host array of the 5
// heights then the 5 widths; table: K3h's output for the same counts.
int tpurt_gtao_main(const float* const* mips, const int* dims,
                    const float* normal_enc, const float* consts,
                    const float* table, int h, int w, int slice_count,
                    int steps, uint8_t* ao_out,
                    uint8_t* edges_out, cudaStream_t stream) {
  if (slice_count <= 0 || steps <= 0) return (int)cudaErrorInvalidValue;
  if (h <= 0 || w <= 0) return (int)cudaGetLastError();
  Mips m;
  for (int i = 0; i < 5; ++i) {
    m.level[i] = mips[i];
    m.h[i] = dims[i];
    m.w[i] = dims[5 + i];
  }
#define TPURT_PRESET(S, T)                                               \
  if (slice_count == S && steps == T)                                    \
    return launch_main<S, T>(m, normal_enc, consts, table, h, w,         \
                             slice_count, steps, ao_out, edges_out, stream);
  // tpurt/passes/gtao.py:53-56: LOW, MEDIUM, HIGH, ULTRA
  TPURT_PRESET(1, 2)
  TPURT_PRESET(2, 2)
  TPURT_PRESET(3, 3)
  TPURT_PRESET(9, 3)
#undef TPURT_PRESET
  return launch_main<0, 0>(m, normal_enc, consts, table, h, w, slice_count,
                           steps, ao_out, edges_out, stream);
}

}  // extern "C"

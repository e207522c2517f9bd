// Shade's light loop (K8) written for Hopper: two kernels around the
// shadow traces, one thread per pixel, every light in a loop inside it.
//
// Replaces no TPU kernel: tpurt's light loop is XLA code
// (tpurt/passes/shade.py:747-804), and the port ran it as plain PyTorch,
// some 280 eager launches per light, many over strided [..., k] views of
// (N, 3) tensors. Here:
//   * K8a, light_rays_kernel: every light's normalized L, N.L, whether the
//     lane wants a shadow ray and the ray's t_max (0 where it wants none),
//     what passes/shade.py's pre-pass computed per light
//     (passes/light.py get_unnormalized_L_vec, then light_ray);
//   * the shadow traces (K2, K5, K6 or the sharded hooks) run unchanged
//     between the two, on K8a's L and t_max;
//   * K8b, light_sum_kernel: per light the GGX + Burley BRDF
//     (passes/brdf.py), the shadow attenuation and get_light_radiance,
//     summed over the lights in index order from 0.0f into rho (N, 3).
//
// What bounds it on an H100: bytes. At 1080p with 3 lights K8a reads 25 B
// and writes 63 B a pixel (182 MB), K8b reads 110 B and writes 12 B (253
// MB): 0.054 + 0.076 ms at 3.35 TB/s; a few hundred flops a pixel and
// light are far below the card's rate. What the design does about it:
// each operand is read once and each output written once, with no
// intermediate in device memory (the eager chain wrote and read back one
// (N,) or (N, 3) tensor per operation); a warp's float3 rows, 12 bytes a
// thread, are 384 contiguous bytes read by three coalesced loads; the
// light parameters are a few hundred bytes that every thread reads from
// the same address (one broadcast from L1). Only the taken branch of the
// light type is computed: the plain version selects with torch.where, so
// the bits are the same and the area light's closest-point work is paid
// by area lights alone.
//
// Bits: each operation is the one the plain chain's eager kernel performs
// on the card, in its order, each rounded on its own (--fmad=false):
// tensor / tensor an IEEE divide, `s / x` a reciprocal times s
// (PyTorch's __rtruediv__), sqrtf IEEE, torch.pow(x, 5.0) powf, arccos
// acosf, clamp NaN-propagating fmaxf/fminf as PyTorch's clamp kernels,
// three-term dots left to right. Scalars that PyTorch converts from a
// Python double are written (float)<double>. Every light is evaluated,
// an inactive one too: its term is multiplied by `active` (0), as the
// plain chain multiplies, so a non-finite term gives NaN there as well.
#include <cuda_runtime.h>
#include <math.h>

namespace {

// passes/light.py's light types
constexpr int LIGHT_POINT = 0;
constexpr int LIGHT_SPOT = 1;
constexpr int LIGHT_DIRECTIONAL = 2;
constexpr int LIGHT_AREA = 3;
constexpr int BLOCK = 256;
// occlusion masks a K8b launch takes by value (kernel parameter space)
constexpr int OCC_CHUNK = 32;
// passes/brdf.py's PI and the literals of the plain chain, as PyTorch
// converts its Python doubles
constexpr float INV_PI = (float)(1.0 / 3.14159265359);
constexpr float F0_DIELECTRIC = (float)0.04;
constexpr float NDOTV_MIN = (float)1e-5;
constexpr float LEN_MIN = (float)1e-20;

// engine/convert.light_tensors' arrays: (S, 3) f32 and (S,) f32 / int32
struct Lights {
  const float *pos, *dir, *color, *area_pos2, *area_pos3;
  const float *falloff, *penumbra, *umbra, *active;
  const int *type, *casts;
};

struct Occluded {
  const bool* mask[OCC_CHUNK];
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 ld3(const float* __restrict__ p, size_t i) {
  return V3{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void st3(float* __restrict__ p, size_t i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return V3{a.x + b.x, a.y + b.y, a.z + b.z};
}

__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}

__device__ __forceinline__ V3 scale(V3 a, float s) {
  return V3{a.x * s, a.y * s, a.z * s};
}

__device__ __forceinline__ V3 divide(V3 a, float d) {
  return V3{a.x / d, a.y / d, a.z / d};
}

// shade.py's _dot: the products, then summed left to right
__device__ __forceinline__ float dot(V3 a, V3 b) {
  const float x = a.x * b.x, y = a.y * b.y, z = a.z * b.z;
  return (x + y) + z;
}

// torch.clamp / clamp_min on the card: NaN passes, else min(max(v, lo), hi)
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// shade.py's _normalize at its default eps
__device__ __forceinline__ V3 normalize(V3 v) {
  return divide(v, clamp_min(sqrtf(dot(v, v)), LEN_MIN));
}

// light.py compute_barycentric
__device__ V3 barycentric(V3 a, V3 b, V3 c, V3 p) {
  const V3 v0 = sub(b, a), v1 = sub(c, a), v2 = sub(p, a);
  const float d00 = dot(v0, v0), d01 = dot(v0, v1), d11 = dot(v1, v1);
  const float d20 = dot(v2, v0), d21 = dot(v2, v1);
  const float denom = d00 * d11 - d01 * d01;
  const float bx = (d11 * d20 - d01 * d21) / denom;
  const float by = (d00 * d21 - d01 * d20) / denom;
  return V3{bx, by, (1.0f - bx) - by};
}

// light.py closest_point_to_segment
__device__ V3 closest_on_segment(V3 p0, V3 p1, V3 p) {
  const V3 v01 = sub(p1, p0);
  const float t = clamp(dot(sub(p, p0), v01) / dot(v01, v01), 0.0f, 1.0f);
  return add(p0, scale(v01, t));
}

// light.py closest_point_to_triangle, its selects as branches
__device__ V3 closest_on_triangle(V3 p0, V3 p1, V3 p2, V3 p) {
  const V3 b = barycentric(p0, p1, p2, p);
  if (b.x < 0.0f) return closest_on_segment(p2, p0, p);
  if (b.z < 0.0f) return closest_on_segment(p1, p2, p);
  return p;
}

// light.py get_unnormalized_L_vec: the branch of light s's type only
__device__ V3 unnormalized_l(const Lights& lt, int s, V3 pos) {
  const int type = lt.type[s];
  const V3 lpos = ld3(lt.pos, s);
  if (type == LIGHT_POINT || type == LIGHT_SPOT) return sub(lpos, pos);
  if (type != LIGHT_DIRECTIONAL && type != LIGHT_AREA)
    return V3{1.0f, 1.0f, 1.0f};
  const V3 ldir = ld3(lt.dir, s);
  if (type == LIGHT_DIRECTIONAL)
    return V3{-ldir.x * 10.0f, -ldir.y * 10.0f, -ldir.z * 10.0f};
  // the area light: project onto its plane, clamp to the rectangle
  const V3 a2 = ld3(lt.area_pos2, s), a3 = ld3(lt.area_pos3, s);
  const float distance = dot(ldir, a2) - dot(ldir, pos);
  const V3 cp = add(pos, scale(ldir, distance));
  const V3 b = barycentric(lpos, a2, a3, cp);
  V3 clamped = cp;
  if (b.x < 0.0f)
    clamped = closest_on_triangle(lpos, a3, add(sub(lpos, a2), a3), cp);
  else if (b.y < 0.0f)
    clamped = closest_on_segment(lpos, a2, cp);
  else if (b.z < 0.0f)
    clamped = closest_on_segment(a2, a3, cp);
  return sub(clamped, pos);
}

// light.py get_light_radiance
__device__ V3 radiance(const Lights& lt, int s, V3 pos, V3 l) {
  V3 rad = ld3(lt.color, s);
  const int type = lt.type[s];
  if (type == LIGHT_SPOT || type == LIGHT_AREA) {
    const V3 d = ld3(lt.dir, s);
    const float cos_theta = dot(d, V3{-l.x, -l.y, -l.z});
    const float theta = acosf(clamp(cos_theta, -1.0f, 1.0f));
    const float umbra = lt.umbra[s];
    float denom = lt.penumbra[s] - umbra;
    if (denom == 0.0f) denom = 1.0f;
    const float t = clamp((theta - umbra) / denom, 0.0f, 1.0f);
    rad = scale(rad, t * t);
  }
  const float falloff = lt.falloff[s];
  if (falloff > 0.0f) {
    const V3 dl = sub(ld3(lt.pos, s), pos);
    const float r = sqrtf(dot(dl, dl)) / falloff;
    float w = clamp_min(1.0f - r * r, 0.0f);
    w = w * w;
    rad = scale(rad, w);
  }
  return rad;
}

// brdf.f_schlick(1.0, x, f90) with pow(1 - x, 5) given
__device__ __forceinline__ float schlick1(float f90, float p5) {
  return (f90 - 1.0f) * p5 + 1.0f;
}

__global__ void __launch_bounds__(BLOCK)
light_rays_kernel(const float* __restrict__ world_pos,
                  const float* __restrict__ normal,
                  const bool* __restrict__ valid, int n, Lights lt,
                  int lights, float* __restrict__ L,
                  float* __restrict__ nc_ndotl, bool* __restrict__ wants,
                  float* __restrict__ t_max) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const V3 pos = ld3(world_pos, i), nrm = ld3(normal, i);
  const bool ok = valid[i];
  for (int s = 0; s < lights; ++s) {
    const V3 nn = unnormalized_l(lt, s, pos);
    const float len = sqrtf(dot(nn, nn));
    const V3 l = divide(nn, clamp_min(len, LEN_MIN));
    const float ndl = dot(nrm, l);
    const bool want = ok && lt.casts[s] > 0 && ndl > 0.0f;
    const size_t o = (size_t)s * n + i;
    st3(L, o, l);
    nc_ndotl[o] = ndl;
    wants[o] = want;
    t_max[o] = want ? len : 0.0f;
  }
}

// lights [s0, s0 + count) added to rho (from 0.0f when first)
__global__ void __launch_bounds__(BLOCK)
light_sum_kernel(const float* __restrict__ normal,
                 const float* __restrict__ view,
                 const float* __restrict__ albedo,
                 const float* __restrict__ roughness, long long rough_stride,
                 const float* __restrict__ metallic, long long metal_stride,
                 const float* __restrict__ world_pos, int n,
                 const float* __restrict__ L,
                 const float* __restrict__ nc_ndotl,
                 const bool* __restrict__ wants, Occluded occ, Lights lt,
                 int s0, int count, int first, float sss_scale,
                 float diffuse_scale, float shadow_attenuation,
                 float* __restrict__ rho) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const V3 nrm = ld3(normal, i), v = ld3(view, i), alb = ld3(albedo, i);
  const V3 pos = ld3(world_pos, i);
  const float metal = metallic[i * metal_stride];
  const float rough = roughness[i * rough_stride];
  const float one_m = 1.0f - metal;
  const float f0_base = one_m * F0_DIELECTRIC;
  const V3 f0{f0_base + alb.x * metal, f0_base + alb.y * metal,
              f0_base + alb.z * metal};
  const V3 kd = V3{one_m * alb.x, one_m * alb.y, one_m * alb.z};
  const float cr = rough * rough;
  const float nc_ndv = dot(nrm, v);
  const float ndv = clamp(nc_ndv, NDOTV_MIN, 1.0f);
  const float pow_v = powf(1.0f - nc_ndv, 5.0f);
  V3 acc = first ? V3{0.0f, 0.0f, 0.0f} : ld3(rho, i);
  for (int k = 0; k < count; ++k) {
    const int s = s0 + k;
    const size_t o = (size_t)s * n + i;
    const V3 l = ld3(L, o);
    const float ncl = nc_ndotl[o];
    const V3 h = normalize(add(v, l));
    const float ndl = clamp(ncl, 0.0f, 1.0f);
    const float ndh = clamp(dot(nrm, h), 0.0f, 1.0f);
    const float ldh = clamp(dot(l, h), 0.0f, 1.0f);

    // cook_torrance_specular: d_ggx, v_smith_ggx_correlated_fast,
    // f_schlick(F0, LdotH)
    const float one_minus_noh2 = 1.0f - ndh * ndh;
    const float a = ndh * cr;
    const float kk = cr / (one_minus_noh2 + a * a);
    const float D = (kk * kk) * INV_PI;
    const float mix_a = (ndl * 2.0f) * ndv;
    const float mix = mix_a + ((ndl + ndv) - mix_a) * cr;
    const float G = (1.0f / mix) * 0.5f;
    const float dg = D * G;
    const float pow_h = powf(1.0f - ldh, 5.0f);
    const V3 spec{dg * (f0.x + (1.0f - f0.x) * pow_h),
                  dg * (f0.y + (1.0f - f0.y) * pow_h),
                  dg * (f0.z + (1.0f - f0.z) * pow_h)};

    // burley_diffuse_local_sss
    const float pow_l = powf(1.0f - ncl, 5.0f);
    const float f_ss90 = (cr * ldh) * ldh;
    const float f_ss_mix = schlick1(f_ss90, pow_l) * schlick1(f_ss90, pow_v);
    const float f_ss = ((1.0f / (nc_ndv * ncl)) - 0.5f) * f_ss_mix + 0.5f;
    const float local_sss = f_ss * sss_scale;
    const float f90 = f_ss90 * 2.0f + 0.5f;
    const float diffuse =
        (schlick1(f90, pow_l) * diffuse_scale) * schlick1(f90, pow_v);
    const float burley = (ndv * (diffuse + local_sss)) * INV_PI;

    const bool shadowed = wants[o] && occ.mask[k][i];
    const float f =
        ((shadowed ? shadow_attenuation : 1.0f) * ndl) * lt.active[s];
    const V3 rad = radiance(lt, s, pos, l);
    acc.x = acc.x + ((spec.x + kd.x * burley) * rad.x) * f;
    acc.y = acc.y + ((spec.y + kd.y * burley) * rad.y) * f;
    acc.z = acc.z + ((spec.z + kd.z * burley) * rad.z) * f;
  }
  st3(rho, i, acc);
}

Lights lights_of(const float* pos, const float* dir, const float* color,
                 const float* area_pos2, const float* area_pos3,
                 const float* falloff, const float* penumbra,
                 const float* umbra, const float* active, const int* type,
                 const int* casts) {
  return Lights{pos,     dir,      color, area_pos2, area_pos3, falloff,
                penumbra, umbra,   active, type,     casts};
}

}  // namespace

// K8a. world_pos, normal (n, 3) f32, valid (n,) bool; the lights' arrays
// (engine/convert.light_tensors, `lights` rows); out L (lights, n, 3),
// nc_ndotl and t_max (lights, n) f32, wants (lights, n) bool.
extern "C" int tpurt_shade_light_rays(
    const float* world_pos, const float* normal, const bool* valid, int n,
    const float* pos, const float* dir, const float* color,
    const float* area_pos2, const float* area_pos3, const float* falloff,
    const float* penumbra, const float* umbra, const float* active,
    const int* type, const int* casts, int lights, float* L,
    float* nc_ndotl, bool* wants, float* t_max, cudaStream_t stream) {
  if (n > 0 && lights > 0) {
    light_rays_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
        world_pos, normal, valid, n,
        lights_of(pos, dir, color, area_pos2, area_pos3, falloff, penumbra,
                  umbra, active, type, casts),
        lights, L, nc_ndotl, wants, t_max);
  }
  return (int)cudaGetLastError();
}

// K8b. The surface terms (roughness and metallic strided by their element
// strides), K8a's outputs, `occluded` a host array of `lights` device
// pointers to (n,) bool masks, the lights' arrays; out rho (n, 3) f32.
// One launch per OCC_CHUNK lights, each adding its lights to rho in order.
extern "C" int tpurt_shade_light_sum(
    const float* normal, const float* view, const float* albedo,
    const float* roughness, long long rough_stride, const float* metallic,
    long long metal_stride, const float* world_pos, int n, const float* L,
    const float* nc_ndotl, const bool* wants, const bool* const* occluded,
    const float* pos, const float* dir, const float* color,
    const float* area_pos2, const float* area_pos3, const float* falloff,
    const float* penumbra, const float* umbra, const float* active,
    const int* type, const int* casts, int lights, float sss_scale,
    float diffuse_scale, float shadow_attenuation, float* rho,
    cudaStream_t stream) {
  const Lights lt = lights_of(pos, dir, color, area_pos2, area_pos3,
                              falloff, penumbra, umbra, active, type, casts);
  for (int s0 = 0; n > 0 && s0 < lights; s0 += OCC_CHUNK) {
    const int count = lights - s0 < OCC_CHUNK ? lights - s0 : OCC_CHUNK;
    Occluded occ{};
    for (int k = 0; k < count; ++k) occ.mask[k] = occluded[s0 + k];
    light_sum_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
        normal, view, albedo, roughness, rough_stride, metallic,
        metal_stride, world_pos, n, L, nc_ndotl, wants, occ, lt, s0, count,
        s0 == 0, sss_scale, diffuse_scale, shadow_attenuation, rho);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

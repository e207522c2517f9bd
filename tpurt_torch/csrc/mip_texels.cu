// The texel fetch of a mip scene (K9) written for Hopper: one thread per
// hit, the ray-cone footprint and every tap's trilinear sample of the
// three packed layers (albedo, ORM, normal map) in one launch.
//
// Replaces no TPU kernel: tpurt's fetch is XLA code (tpurt/passes/
// shade.py:616-694), and the port ran it as plain PyTorch: ray_cone_lod or
// ray_cone_aniso, then the tier's trilinear sampler once per tap
// (passes/shade.py _anisotropic), each tap a chain of eager index math,
// row gathers and lerps over (N, 64) u8 rows and (N, 12) f32 temporaries.
// Per lane K9 computes:
//   * the footprint, as passes/shade.py ray_cone_lod does (1 tap) or
//     ray_cone_aniso does (max_aniso 16; more taps): the LOD at the minor
//     axis and the major axis duv;
//   * per tap i, uv' = uv + duv * ((i + 0.5) / taps - 0.5), the trilinear
//     sample at uv' through the tier the scene ships (quad, pair or
//     block4, a template parameter; rows of scene/scene.py _quad_rows,
//     _pair_rows, _block4_rows): the bilinear lerp of the four corner
//     texels at the two levels around the clamped LOD, each / 255, lerped
//     by the LOD's fraction;
//   * the taps summed in order and divided by their count (1 tap: the
//     trilinear sample).
// Where the tier's rows are served by a gather instead (the sharded-
// geometry frame's ring, passes/shade.py's gather= hook), the fetch takes
// two launches: mip_texel_rows_kernel writes the global index of every
// row that each tap and level reads, (n, taps, 2, rows per sample) int32,
// the caller gathers those rows in that order, and mip_texels_kernel
// filters, reading each row at its position in the gathered rows in
// place of the tier's table. Both compute the same footprint and texel
// coordinates, so the texels are the same bits either way.
//
// What bounds it on an H100: operations. At 1080p with 16 taps the filter
// (rtbench/metrics/k9_roofline.py's count) is ~5,000 f32 operations a
// pixel, 10.4 G, 0.31 ms at 33.5 T unfused operations a second; the
// inputs (148 bytes a pixel: t, direction, normal, the tri_attr row's
// corners, uvs and primitive, the interpolated uv, the 48-byte output) are
// 0.09 ms at 3.35 TB/s. The texel rows (16 taps x 2 levels x 1, 2 or 4
// rows of 64 bytes) come mostly from L1 and L2: a warp is 32 neighbouring
// pixels of one image row, whose footprints overlap. What the design does
// about it: no intermediate reaches device memory (the eager chain wrote
// and read back every (N, 12) and (N, 64) temporary); a row is read once
// per tap and level, as three 16-byte loads (a pair row that serves both
// columns and a block4 row that serves several corners are loaded once); a
// u8 becomes a float by a byte permute and one subtraction, not a
// conversion instruction; the footprint and the levels' extents and
// offsets are computed once per lane, not per tap.
//
// Bits: each operation is the one the plain chain's eager kernel performs
// on the card, in its order, each rounded on its own (--fmad=false): the
// three-term dots left to right, the cross product's components as
// products and one difference (passes/shade.py _texel_density), IEEE
// divides and square roots, log2f (torch.log2), floorf, clamps that pass
// NaN, Python's remainder for the wrapped texel coordinates, and scalars
// that PyTorch converts from a Python double written (float)<double>. A
// NaN LOD takes level 0 with a NaN fraction (nan_to_num, then the int
// conversion), as the plain chain does.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BLOCK = 128;
// the tiers, in the wrapper's order (kernels/mip_texels.py TIERS)
constexpr int TIER_QUAD = 0;
constexpr int TIER_PAIR = 1;
constexpr int TIER_BLOCK4 = 2;
constexpr int ROW_BYTES = 64;
constexpr int TEXEL_WORDS = 3;     // 12 u8 channels: 3 layers x RGBA
constexpr int CHANNELS = 12;
// tri_attr's columns (passes/shade.py surface): each corner's position at
// 12k, its uv at 12k + 3; the primitive at 36
constexpr int ATTR_CORNER = 12;
constexpr int ATTR_UV = 3;
constexpr int ATTR_PRIM = 36;
constexpr int MAX_ANISO = 16;
// 2^23: a u8 placed in the low byte of 0x4B000000 reads 2^23 + u8
constexpr unsigned MAGIC_BITS = 0x4B000000u;
constexpr float MAGIC = 8388608.0f;

// the rows one bilinear sample reads: a quad row holds its four corners,
// a pair row two neighbouring columns of two image rows, a block4 row a
// 2x2 block (kernels/mip_texels.py ROWS_PER_SAMPLE)
template <int TIER>
constexpr int ROWS_PER_SAMPLE = TIER == TIER_QUAD ? 1
                                : TIER == TIER_PAIR ? 2
                                                    : 4;

struct Hits {
  const float* t;          // (n,) hit distance
  const float* dir;        // (n, 3) primary ray direction
  const float* normal;     // (n, 3) interpolated world normal
  const float* attr;       // tri_attr rows, attr_stride floats apart
  long long attr_stride;
  const float* uv;         // (n, 2) interpolated uv
  const float* spread;     // the cone's spread angle (one float)
};

struct Tier {
  // (R, 64) u8: the tier's rows, or with `gathered` the rows each lane,
  // tap, level and sample row reads, in that order
  const unsigned char* rows;
  bool gathered;
  const int* offsets;          // (P, levels) first row of each level
  const int* sizes;            // (P, levels, 2) (h, w)
  int levels;
};

struct V3 {
  float x, y, z;
};

struct Texel {
  unsigned w[TEXEL_WORDS];
};

struct Row {
  Texel t[4];
};

__device__ __forceinline__ V3 ld3(const float* __restrict__ p, size_t i) {
  return V3{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return V3{a.x - b.x, a.y - b.y, a.z - b.z};
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

// torch.remainder of int32 tensors (Python's sign rule), for b > 0
__device__ __forceinline__ int remainder(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// (i + 0.5) / taps - 0.5 in double, as Python computes it, then the float
// that PyTorch multiplies by
__device__ __forceinline__ float tap_offset(int i, int taps) {
  return (float)(((double)i + 0.5) / (double)taps - 0.5);
}

// channel c of a texel as an exact float
__device__ __forceinline__ float channel(const Texel& t, int c) {
  const unsigned bits =
      __byte_perm(t.w[c >> 2], MAGIC_BITS, 0x7440u | (unsigned)(c & 3));
  return __uint_as_float(bits) - MAGIC;
}

// a row's first 48 bytes: its four 12-byte texels
__device__ __forceinline__ Row load_row(const unsigned char* rows,
                                        size_t flat) {
  const uint4* p = reinterpret_cast<const uint4*>(rows + flat * ROW_BYTES);
  const uint4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
  Row r;
  r.t[0] = Texel{{a.x, a.y, a.z}};
  r.t[1] = Texel{{a.w, b.x, b.y}};
  r.t[2] = Texel{{b.z, b.w, c.x}};
  r.t[3] = Texel{{c.y, c.z, c.w}};
  return r;
}

__device__ __forceinline__ Texel pick(const Row& r, int slot) {
  Texel out = r.t[0];
  out = slot == 1 ? r.t[1] : out;
  out = slot == 2 ? r.t[2] : out;
  out = slot == 3 ? r.t[3] : out;
  return out;
}

// one mip level of one primitive: extents and first row
struct Level {
  int h, w, offset;
};

__device__ __forceinline__ Level level_of(const Tier& tb, int prim,
                                          int level) {
  const size_t k = (size_t)prim * tb.levels + level;
  return Level{tb.sizes[2 * k], tb.sizes[2 * k + 1], tb.offsets[k]};
}

// one bilinear sample: the global index of each row it reads, the slot of
// each corner (t00, t10, t01, t11) in its row, and the lerp weights
struct Sample {
  int flat[4];
  int slot[4];
  float fx, fy;
};

// shade.py's _texel_coords and the tier's row indices (_mip_quad_flat_
// index, _pair_corners, _block4_corners)
template <int TIER>
__device__ __forceinline__ Sample corners(const Level& lv, float u,
                                          float v) {
  Sample s;
  const float px = u * (float)lv.w - 0.5f;
  const float py = v * (float)lv.h - 0.5f;
  const float x0 = floorf(px), y0 = floorf(py);
  s.fx = px - x0;
  s.fy = py - y0;
  const int x0i = remainder((int)x0, lv.w);
  const int y0i = remainder((int)y0, lv.h);
  const int x1i = x0i + 1 == lv.w ? 0 : x0i + 1;
  if constexpr (TIER == TIER_QUAD) {
    s.flat[0] = lv.offset + y0i * lv.w + x0i;
    s.slot[0] = 0;
    s.slot[1] = 1;
    s.slot[2] = 2;
    s.slot[3] = 3;
  } else if constexpr (TIER == TIER_PAIR) {
    // columns x0 and x1 of rows y0 (slots 0, 1) and y0 + 1 (slots 2, 3)
    const int base = lv.offset + y0i * ((lv.w + 1) / 2);
    s.flat[0] = base + x0i / 2;
    s.flat[1] = base + x1i / 2;
    s.slot[0] = x0i & 1;
    s.slot[1] = x1i & 1;
    s.slot[2] = 2 + (x0i & 1);
    s.slot[3] = 2 + (x1i & 1);
  } else {
    // texel (y, x) in block (y / 2, x / 2), slot (y & 1) * 2 + (x & 1)
    const int y1i = y0i + 1 == lv.h ? 0 : y0i + 1;
    const int bw = (lv.w + 1) / 2;
    s.flat[0] = lv.offset + (y0i / 2) * bw + x0i / 2;
    s.flat[1] = lv.offset + (y0i / 2) * bw + x1i / 2;
    s.flat[2] = lv.offset + (y1i / 2) * bw + x0i / 2;
    s.flat[3] = lv.offset + (y1i / 2) * bw + x1i / 2;
    const int sy0 = (y0i & 1) * 2, sy1 = (y1i & 1) * 2;
    s.slot[0] = sy0 + (x0i & 1);
    s.slot[1] = sy0 + (x1i & 1);
    s.slot[2] = sy1 + (x0i & 1);
    s.slot[3] = sy1 + (x1i & 1);
  }
  return s;
}

// row j of a sample: from the tier's table at its global index, or from
// the gathered rows at `pos` + j
__device__ __forceinline__ Row fetch(const Tier& tb, const Sample& s,
                                     size_t pos, int j) {
  return load_row(tb.rows, tb.gathered ? pos + j : (size_t)s.flat[j]);
}

// the tier's rows and shade.py's _bilerp (each channel / 255): the
// bilinear sample of all 12 channels; a row that serves several corners
// is loaded once
template <int TIER>
__device__ __forceinline__ void bilinear(const Tier& tb, const Sample& s,
                                         size_t pos, float* out) {
  Texel t00, t10, t01, t11;
  if constexpr (TIER == TIER_QUAD) {
    const Row r = fetch(tb, s, pos, 0);
    t00 = r.t[0];
    t10 = r.t[1];
    t01 = r.t[2];
    t11 = r.t[3];
  } else if constexpr (TIER == TIER_PAIR) {
    const Row r0 = fetch(tb, s, pos, 0);
    const Row r1 = s.flat[1] == s.flat[0] ? r0 : fetch(tb, s, pos, 1);
    t00 = pick(r0, s.slot[0]);
    t10 = pick(r1, s.slot[1]);
    t01 = pick(r0, s.slot[2]);
    t11 = pick(r1, s.slot[3]);
  } else {
    const Row r00 = fetch(tb, s, pos, 0);
    const Row r10 = s.flat[1] == s.flat[0] ? r00 : fetch(tb, s, pos, 1);
    const Row r01 = s.flat[2] == s.flat[0] ? r00 : fetch(tb, s, pos, 2);
    const Row r11 = s.flat[3] == s.flat[2]   ? r01
                    : s.flat[3] == s.flat[1] ? r10
                                             : fetch(tb, s, pos, 3);
    t00 = pick(r00, s.slot[0]);
    t10 = pick(r10, s.slot[1]);
    t01 = pick(r01, s.slot[2]);
    t11 = pick(r11, s.slot[3]);
  }
  const float gx = 1.0f - s.fx, gy = 1.0f - s.fy;
#pragma unroll
  for (int c = 0; c < CHANNELS; ++c) {
    const float top = channel(t00, c) * gx + channel(t10, c) * s.fx;
    const float bottom = channel(t01, c) * gx + channel(t11, c) * s.fx;
    out[c] = (top * gy + bottom * s.fy) / 255.0f;
  }
}

struct Footprint {
  float lod, du, dv;
};

// shade.py's ray_cone_lod (taps 1) and ray_cone_aniso (max_aniso 16),
// with _texel_density
__device__ Footprint footprint(const Hits& in, const Tier& tb, int i,
                               int prim, bool aniso) {
  const float* a = in.attr + (size_t)i * in.attr_stride;
  const V3 p0{a[0], a[1], a[2]};
  const V3 p1{a[ATTR_CORNER], a[ATTR_CORNER + 1], a[ATTR_CORNER + 2]};
  const V3 p2{a[2 * ATTR_CORNER], a[2 * ATTR_CORNER + 1],
              a[2 * ATTR_CORNER + 2]};
  const float* uv0 = a + ATTR_UV;
  const float* uv1 = a + ATTR_CORNER + ATTR_UV;
  const float* uv2 = a + 2 * ATTR_CORNER + ATTR_UV;
  const V3 d = ld3(in.dir, i), n = ld3(in.normal, i);
  // the extents of level 0 of the primitive's chain
  const float tex_h = (float)tb.sizes[(size_t)prim * tb.levels * 2];
  const float tex_w = (float)tb.sizes[(size_t)prim * tb.levels * 2 + 1];

  const V3 e1 = sub(p1, p0), e2 = sub(p2, p0);
  const V3 c{e1.y * e2.z - e1.z * e2.y, e1.z * e2.x - e1.x * e2.z,
             e1.x * e2.y - e1.y * e2.x};
  const float world_area = 0.5f * sqrtf(dot(c, c));
  const float du1 = uv1[0] - uv0[0], dv1 = uv1[1] - uv0[1];
  const float du2 = uv2[0] - uv0[0], dv2 = uv2[1] - uv0[1];
  const float uv_area = 0.5f * fabsf(du1 * dv2 - dv1 * du2);
  const float tpw = sqrtf(uv_area * tex_w * tex_h /
                          clamp_min(world_area, (float)1e-12));

  const float cone = in.t[i] * in.spread[0];
  const float d_dot_n = dot(n, d);
  const float cos_in = fabsf(d_dot_n);
  if (!aniso) {
    const float fp = cone / clamp_min(cos_in, 0.25f);
    return Footprint{log2f(clamp_min(fp * tpw, (float)1e-6)), 0.0f, 0.0f};
  }
  const float lod = log2f(clamp_min(cone * tpw, (float)1e-6));
  const V3 proj{d.x - d_dot_n * n.x, d.y - d_dot_n * n.y,
                d.z - d_dot_n * n.z};
  const float len = clamp_min(sqrtf(dot(proj, proj)), (float)1e-20);
  const V3 pdir{proj.x / len, proj.y / len, proj.z / len};
  const float aniso_ratio = clamp(1.0f / clamp_min(cos_in, (float)1e-4),
                                  1.0f, (float)MAX_ANISO);
  const float major_len = cone * aniso_ratio;
  // pdir = a e1 + b e2 in the triangle's plane (a 2x2 Gram system)
  const float g11 = dot(e1, e1), g12 = dot(e1, e2), g22 = dot(e2, e2);
  const float r1 = dot(pdir, e1), r2 = dot(pdir, e2);
  const float det = g11 * g22 - g12 * g12;
  if (!(det > (float)1e-8 * g11 * g22)) return Footprint{lod, 0.0f, 0.0f};
  const float inv_det = 1.0f / clamp_min(det, (float)1e-30);
  const float ca = (r1 * g22 - r2 * g12) * inv_det;
  const float cb = (g11 * r2 - g12 * r1) * inv_det;
  return Footprint{lod, (ca * du1 + cb * du2) * major_len,
                   (ca * dv1 + cb * dv2) * major_len};
}

// one lane's footprint and the two levels around its clamped LOD
// (shade.py's _lod_levels)
struct Lane {
  Footprint fp;
  Level lv0, lv1;
  float frac;
};

__device__ __forceinline__ Lane lane(const Hits& in, const Tier& tb, int i,
                                     bool aniso) {
  const int prim = (int)in.attr[(size_t)i * in.attr_stride + ATTR_PRIM];
  const Footprint fp = footprint(in, tb, i, prim, aniso);
  const float lod = clamp(fp.lod, 0.0f, (float)(tb.levels - 1));
  const float l0 = floorf(lod);
  const int l0i = l0 != l0 ? 0 : (int)l0;
  const int l1i = min(l0i + 1, tb.levels - 1);
  return Lane{fp, level_of(tb, prim, l0i), level_of(tb, prim, l1i),
              lod - l0};
}

// tap k's uv: uv + duv * ((k + 0.5) / taps - 0.5), uv itself for one tap
__device__ __forceinline__ void tap_uv(const Lane& ln, float u, float v,
                                       int k, int taps, float& qu,
                                       float& qv) {
  qu = u;
  qv = v;
  if (taps > 1) {
    const float f = tap_offset(k, taps);
    qu = u + ln.fp.du * f;
    qv = v + ln.fp.dv * f;
  }
}

template <int TIER>
__global__ void __launch_bounds__(BLOCK)
    mip_texels_kernel(Hits in, Tier tb, int n, int taps,
                      float* __restrict__ out, float* __restrict__ lod_out,
                      float* __restrict__ duv_out) {
  constexpr int K = ROWS_PER_SAMPLE<TIER>;
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const bool aniso = taps > 1;
  const Lane ln = lane(in, tb, i, aniso);
  if (lod_out != nullptr) lod_out[i] = ln.fp.lod;
  if (duv_out != nullptr && aniso) {
    duv_out[2 * i] = ln.fp.du;
    duv_out[2 * i + 1] = ln.fp.dv;
  }
  const float gf = 1.0f - ln.frac;
  const float u = in.uv[2 * i], v = in.uv[2 * i + 1];
  // the lane's first row in the gathered rows
  size_t pos = (size_t)i * taps * 2 * K;
  float acc[CHANNELS];
  for (int k = 0; k < taps; ++k, pos += 2 * K) {
    float qu, qv;
    tap_uv(ln, u, v, k, taps, qu, qv);
    float s0[CHANNELS], s1[CHANNELS];
    bilinear<TIER>(tb, corners<TIER>(ln.lv0, qu, qv), pos, s0);
    bilinear<TIER>(tb, corners<TIER>(ln.lv1, qu, qv), pos + K, s1);
#pragma unroll
    for (int c = 0; c < CHANNELS; ++c) {
      const float s = s0[c] * gf + s1[c] * ln.frac;
      acc[c] = k == 0 ? s : acc[c] + s;
    }
  }
  if (aniso) {
    const float count = (float)taps;
#pragma unroll
    for (int c = 0; c < CHANNELS; ++c) acc[c] = acc[c] / count;
  }
  float4* o = reinterpret_cast<float4*>(out + (size_t)i * CHANNELS);
  o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  o[2] = make_float4(acc[8], acc[9], acc[10], acc[11]);
}

// the global index of every row the filter reads: (n, taps, 2, K) int32,
// lane, tap, level (the lower first) and the sample's row
template <int TIER>
__global__ void __launch_bounds__(BLOCK)
    mip_texel_rows_kernel(Hits in, Tier tb, int n, int taps,
                          int* __restrict__ flats) {
  constexpr int K = ROWS_PER_SAMPLE<TIER>;
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const Lane ln = lane(in, tb, i, taps > 1);
  const float u = in.uv[2 * i], v = in.uv[2 * i + 1];
  int* o = flats + (size_t)i * taps * 2 * K;
  for (int k = 0; k < taps; ++k, o += 2 * K) {
    float qu, qv;
    tap_uv(ln, u, v, k, taps, qu, qv);
    const Sample s0 = corners<TIER>(ln.lv0, qu, qv);
    const Sample s1 = corners<TIER>(ln.lv1, qu, qv);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      o[j] = s0.flat[j];
      o[K + j] = s1.flat[j];
    }
  }
}

int grid_of(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace

// K9. tier 0 quad, 1 pair, 2 block4; taps >= 1. The footprint comes from
// t, dir, normal, the attr rows (corners, uvs, primitive), uv and spread;
// lod_out (n,) and duv_out (n, 2), when not null, receive it (duv_out only
// with taps > 1). rows: the tier's (R, 64) u8 table, or with gathered != 0
// the rows tpurt_mip_texel_rows named, in its order. out (n, 12) f32.
extern "C" int tpurt_mip_texels(
    int tier, const float* t, const float* dir, const float* normal,
    const float* attr, long long attr_stride, const float* uv,
    const float* spread, const unsigned char* rows, int gathered,
    const int* offsets, const int* sizes, int levels, int n, int taps,
    float* out, float* lod_out, float* duv_out, cudaStream_t stream) {
  if (n > 0) {
    const Hits in{t, dir, normal, attr, attr_stride, uv, spread};
    const Tier tb{rows, gathered != 0, offsets, sizes, levels};
    const int grid = grid_of(n);
    if (tier == TIER_QUAD) {
      mip_texels_kernel<TIER_QUAD><<<grid, BLOCK, 0, stream>>>(
          in, tb, n, taps, out, lod_out, duv_out);
    } else if (tier == TIER_PAIR) {
      mip_texels_kernel<TIER_PAIR><<<grid, BLOCK, 0, stream>>>(
          in, tb, n, taps, out, lod_out, duv_out);
    } else {
      mip_texels_kernel<TIER_BLOCK4><<<grid, BLOCK, 0, stream>>>(
          in, tb, n, taps, out, lod_out, duv_out);
    }
  }
  return (int)cudaGetLastError();
}

// The rows K9 reads, for a gather to serve: flats (n, taps, 2, 1 | 2 | 4)
// int32, global row indices of the tier's table, from the same inputs.
extern "C" int tpurt_mip_texel_rows(
    int tier, const float* t, const float* dir, const float* normal,
    const float* attr, long long attr_stride, const float* uv,
    const float* spread, const int* offsets, const int* sizes, int levels,
    int n, int taps, int* flats, cudaStream_t stream) {
  if (n > 0) {
    const Hits in{t, dir, normal, attr, attr_stride, uv, spread};
    const Tier tb{nullptr, false, offsets, sizes, levels};
    const int grid = grid_of(n);
    if (tier == TIER_QUAD) {
      mip_texel_rows_kernel<TIER_QUAD><<<grid, BLOCK, 0, stream>>>(
          in, tb, n, taps, flats);
    } else if (tier == TIER_PAIR) {
      mip_texel_rows_kernel<TIER_PAIR><<<grid, BLOCK, 0, stream>>>(
          in, tb, n, taps, flats);
    } else {
      mip_texel_rows_kernel<TIER_BLOCK4><<<grid, BLOCK, 0, stream>>>(
          in, tb, n, taps, flats);
    }
  }
  return (int)cudaGetLastError();
}

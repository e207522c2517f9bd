// Shade's surface reconstruction (K10) written for Hopper: one thread per
// hit, the shading point, its TBN basis and its material terms.
//
// Replaces no TPU kernel: tpurt's surface reconstruction is XLA code
// (tpurt/passes/shade.py:573-745), and the port ran it as plain PyTorch
// (passes/shade.py surface_plain): the tri_attr row gather into an (N, 40)
// temporary, then some 115 eager launches over strided [..., k] views of
// (N, 3) tensors. Per lane K10 computes, in that chain's order:
//   * the tri_attr row of max(tri, 0), or the lane's own row where the
//     sharded-geometry attr_rows hook served it (LANE_ROWS);
//   * the barycentric position, uv, normal and tangent; Gram-Schmidt;
//     the binormal N x T times the handedness t0.w; V;
//   * without mips, the REPEAT-wrapped quad row of the image (slab or
//     streaming arena), from the closest-hit uv payload where the hits
//     carry it, its bilinear lerp (/ 255), the normal map through the
//     TBN, pow(albedo, 2.2) and the ORM terms (MODE_QUAD: one launch
//     writes every output).
// Where a step between runs elsewhere, the work splits around it:
//   * MODE_MIP (a mip scene): the pre-pass writes the attr rows, the
//     world normal, the uv and the cone's spread that K9 (mip_texels.cu)
//     reads, and the TBN; K9 fetches the (N, 12) texels; then
//     shade_surface_nmap_kernel<SRC_TEXELS> applies the normal map, pow
//     and ORM;
//   * MODE_ROWS (the sharded-geometry quad_gather hook): the pre-pass
//     writes each lane's flat quad row index and its lerp weights, the
//     hook serves the rows, and shade_surface_nmap_kernel<SRC_ROWS> lerps
//     them and finishes as above.
//
// What bounds it on an H100: bytes. At 1080p MODE_QUAD reads the hit (12
// B), the 160-byte tri_attr row (bench43k's 7 MB table sits in L2) and
// 48 bytes of the 64-byte quad row, and writes 57 B a pixel; ~0.6 GB, or
// ~0.18 ms at 3.35 TB/s, against ~6 ms for the eager chain. What the
// design does about it: no intermediate reaches device memory in
// MODE_QUAD (the chain wrote and read back an (N, 40) row, ~30 (N, 3)
// temporaries and the (N, 12) texels); the attr row is ten 16-byte
// loads, the quad row three; a u8 becomes a float by a byte permute and
// one subtraction.
//
// Bits: each operation is the one the plain chain's eager kernel performs
// on the card, in its order, each rounded on its own (--fmad=false):
// three-term dots left to right, IEEE square roots and divides (x / 255
// divides, as passes/encodings.divide does), clamp_min that passes NaN,
// the cross product as products and one difference (as the chain writes
// it), float-to-int32 conversions by truncation, Python's remainder for
// the wrapped texel coordinates, int32 arithmetic that wraps for the
// arena's row index and int64 for the slab's, powf for torch.pow(x, 2.2)
// and scalars that PyTorch converts from a Python double written
// (float)<double>.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BLOCK = 128;
// the modes, in the wrapper's order (kernels/shade_surface.py MODES)
constexpr int MODE_QUAD = 0;
constexpr int MODE_ROWS = 1;
constexpr int MODE_MIP = 2;
// the epilogue's texel sources (kernels/shade_surface.py)
constexpr int SRC_TEXELS = 0;
constexpr int SRC_ROWS = 1;
// tri_attr's row (passes/shade.py surface_plain): corner k's position at
// 12k, uv at 12k + 3, normal at 12k + 5, tangent (xyz, handedness w) at
// 12k + 8; the primitive at 36, the image's extents (h, w) at 37 and its
// unique-image slot at 39
constexpr int ATTR_COLUMNS = 40;
constexpr int ATTR_WORDS = ATTR_COLUMNS / 4;
constexpr int CORNER = 12;
constexpr int UV = 3;
constexpr int NORMAL = 5;
constexpr int TANGENT = 8;
constexpr int HANDEDNESS = 11;
constexpr int TEX_H = 37;
constexpr int TEX_W = 38;
constexpr int TEX_IMG = 39;
constexpr int ROW_BYTES = 64;
constexpr int TEXEL_WORDS = 3;     // 12 u8 channels: 3 layers x RGBA
constexpr int CHANNELS = 12;
// the packed layers' channels: albedo rgb, ORM's roughness and metallic,
// the normal map's xyz
constexpr int ALBEDO = 0;
constexpr int ROUGHNESS = 5;
constexpr int METALLIC = 6;
constexpr int NMAP = 8;
constexpr float LEN_MIN = (float)1e-20;
constexpr float GAMMA = (float)2.2;
// 2^23: a u8 placed in the low byte of 0x4B000000 reads 2^23 + u8
constexpr unsigned MAGIC_BITS = 0x4B000000u;
constexpr float MAGIC = 8388608.0f;

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

// shade.py's _dot: the products, then summed left to right
__device__ __forceinline__ float dot(V3 a, V3 b) {
  const float x = a.x * b.x, y = a.y * b.y, z = a.z * b.z;
  return (x + y) + z;
}

// torch.clamp_min on the card: NaN passes, else max(v, lo)
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// shade.py's _normalize: v / clamp_min(sqrt(v.v), 1e-20)
__device__ __forceinline__ V3 normalize(V3 v) {
  const float len = clamp_min(sqrtf(dot(v, v)), LEN_MIN);
  return V3{v.x / len, v.y / len, v.z / len};
}

// the barycentric blend a * w + b * u + c * v, summed left to right
__device__ __forceinline__ float blend(float a, float b, float c, float w,
                                       float u, float v) {
  return (a * w + b * u) + c * v;
}

// torch.remainder of int32 tensors (Python's sign rule), for b > 0
__device__ __forceinline__ int remainder(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

struct Attr {
  float c[ATTR_COLUMNS];
};

// a tri_attr row (16-byte aligned): ten 16-byte loads
__device__ __forceinline__ Attr load_attr(const float* row) {
  const float4* p = reinterpret_cast<const float4*>(row);
  Attr a;
#pragma unroll
  for (int k = 0; k < ATTR_WORDS; ++k) {
    const float4 q = __ldg(p + k);
    a.c[4 * k] = q.x;
    a.c[4 * k + 1] = q.y;
    a.c[4 * k + 2] = q.z;
    a.c[4 * k + 3] = q.w;
  }
  return a;
}

__device__ __forceinline__ V3 corner(const Attr& a, int k, int col) {
  const int j = CORNER * k + col;
  return V3{a.c[j], a.c[j + 1], a.c[j + 2]};
}

__device__ __forceinline__ V3 blend3(const Attr& a, int col, float w,
                                     float u, float v) {
  const V3 p0 = corner(a, 0, col), p1 = corner(a, 1, col),
           p2 = corner(a, 2, col);
  return V3{blend(p0.x, p1.x, p2.x, w, u, v),
            blend(p0.y, p1.y, p2.y, w, u, v),
            blend(p0.z, p1.z, p2.z, w, u, v)};
}

struct Texel {
  unsigned w[TEXEL_WORDS];
};

// channel c of a texel as an exact float
__device__ __forceinline__ float channel(const Texel& t, int c) {
  const unsigned bits =
      __byte_perm(t.w[c >> 2], MAGIC_BITS, 0x7440u | (unsigned)(c & 3));
  return __uint_as_float(bits) - MAGIC;
}

// shade.py's _quad_lerp: the quad row's four corners (t00, t10, t01, t11:
// its first 48 bytes) lerped by (fx, fy), each channel / 255
__device__ __forceinline__ void quad_lerp(const unsigned char* rows,
                                          size_t flat, float fx, float fy,
                                          float* out) {
  const uint4* p = reinterpret_cast<const uint4*>(rows + flat * ROW_BYTES);
  const uint4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
  const Texel t00{{a.x, a.y, a.z}}, t10{{a.w, b.x, b.y}},
      t01{{b.z, b.w, c.x}}, t11{{c.y, c.z, c.w}};
  const float gx = 1.0f - fx, gy = 1.0f - fy;
#pragma unroll
  for (int k = 0; k < CHANNELS; ++k) {
    const float top = channel(t00, k) * gx + channel(t10, k) * fx;
    const float bottom = channel(t01, k) * gx + channel(t11, k) * fx;
    out[k] = (top * gy + bottom * fy) / 255.0f;
  }
}

struct Hits {
  const int* tri;          // (n,) closest triangle, -1 on a miss
  const float* u;          // (n,) barycentrics
  const float* v;
  // the closest-hit uv payload (n,) each, or null: texu, texv, the
  // unique-image slot, the image's h and w
  const float *texu, *texv, *img, *texh, *texw;
  // tri_attr (T, 40) rows read at max(tri, 0), or with LANE_ROWS the
  // lanes' own rows; attr_stride floats apart
  const float* attr;
  long long attr_stride;
  const float* camera_pos;  // (3,)
  const float* proj11;      // the projection's [1][1] (MODE_MIP)
};

struct Quad {
  // (R, 64) u8 rows: the slab of shape (U, h, w, 64), or with `base` the
  // streaming arena's rows from base[img]
  const unsigned char* rows;
  const int* base;
  long long h, w;
};

// the shading inputs every mode writes, the material terms MODE_QUAD and
// the epilogue write, and what the split modes hand over
struct Out {
  bool* valid;
  float *world_pos, *V;                   // (n, 3)
  float *N, *albedo;                      // (n, 3)
  float *roughness, *metallic;            // (n,)
  float *normal, *tangent, *binormal;     // (n, 3): the TBN
  float* uv;                              // (n, 2) MODE_MIP
  float* attr;                            // (n, 40) MODE_MIP
  float* spread;                          // (1,) MODE_MIP
  long long* flat;                        // (n,) MODE_ROWS
  float* weights;                         // (n, 2) MODE_ROWS: fx, fy
};

// the normal map through the TBN, pow(albedo, 2.2) and ORM from the
// packed (12,) texels
__device__ __forceinline__ void materials(const float* t, V3 tangent,
                                          V3 binormal, V3 normal,
                                          const Out& out, size_t i) {
  const V3 ts = normalize(V3{t[NMAP] * 2.0f - 1.0f,
                             t[NMAP + 1] * 2.0f - 1.0f,
                             t[NMAP + 2] * 2.0f - 1.0f});
  st3(out.N, i, normalize(add(add(scale(tangent, ts.x),
                                  scale(binormal, ts.y)),
                              scale(normal, ts.z))));
  st3(out.albedo, i, V3{powf(t[ALBEDO], GAMMA), powf(t[ALBEDO + 1], GAMMA),
                        powf(t[ALBEDO + 2], GAMMA)});
  out.roughness[i] = t[ROUGHNESS];
  out.metallic[i] = t[METALLIC];
}

template <int MODE, bool LANE_ROWS>
__global__ void __launch_bounds__(BLOCK)
    shade_surface_kernel(Hits in, Quad qt, Out out, int n, float spread_rows) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (MODE == MODE_MIP && i == 0) {
    // passes/shade.py cone_spread: 2 / (proj[1][1] * rows)
    *out.spread = 2.0f / (*in.proj11 * spread_rows);
  }
  if (i >= n) return;
  const int tri = in.tri[i];
  const size_t row = LANE_ROWS ? (size_t)i : (size_t)(tri < 0 ? 0 : tri);
  const Attr a = load_attr(in.attr + row * in.attr_stride);
  const float u = in.u[i], v = in.v[i];
  const float w = (1.0f - u) - v;

  const V3 world_pos = blend3(a, 0, w, u, v);
  const float tu = blend(a.c[UV], a.c[CORNER + UV], a.c[2 * CORNER + UV], w,
                         u, v);
  const float tv = blend(a.c[UV + 1], a.c[CORNER + UV + 1],
                         a.c[2 * CORNER + UV + 1], w, u, v);
  const V3 normal = normalize(blend3(a, NORMAL, w, u, v));
  const V3 t = normalize(blend3(a, TANGENT, w, u, v));
  const V3 tangent = normalize(sub(t, scale(normal, dot(t, normal))));
  const V3 cross{normal.y * tangent.z - normal.z * tangent.y,
                 normal.z * tangent.x - normal.x * tangent.z,
                 normal.x * tangent.y - normal.y * tangent.x};
  const V3 binormal = scale(cross, a.c[HANDEDNESS]);
  const V3 cam{in.camera_pos[0], in.camera_pos[1], in.camera_pos[2]};

  out.valid[i] = tri >= 0;
  st3(out.world_pos, i, world_pos);
  st3(out.V, i, normalize(sub(cam, world_pos)));
  if (MODE != MODE_QUAD) {
    st3(out.normal, i, normal);
    st3(out.tangent, i, tangent);
    st3(out.binormal, i, binormal);
  }
  if (MODE == MODE_MIP) {
    out.uv[2 * i] = tu;
    out.uv[2 * i + 1] = tv;
    float4* o = reinterpret_cast<float4*>(out.attr + (size_t)i * ATTR_COLUMNS);
#pragma unroll
    for (int k = 0; k < ATTR_WORDS; ++k) {
      o[k] = make_float4(a.c[4 * k], a.c[4 * k + 1], a.c[4 * k + 2],
                         a.c[4 * k + 3]);
    }
    return;
  }

  // the quad row's footprint (shade.py _texel_coords): from the uv
  // payload where the trace emitted it, else from the attr row
  float hf, wf, imgf, qu, qv;
  if (in.texu != nullptr) {
    hf = in.texh[i];
    wf = in.texw[i];
    imgf = in.img[i];
    qu = in.texu[i];
    qv = in.texv[i];
  } else {
    hf = a.c[TEX_H];
    wf = a.c[TEX_W];
    imgf = a.c[TEX_IMG];
    qu = tu;
    qv = tv;
  }
  const int h = (int)hf, wi = (int)wf, img = (int)imgf;
  const float px = qu * (float)wi - 0.5f;
  const float py = qv * (float)h - 0.5f;
  const float x0 = floorf(px), y0 = floorf(py);
  const float fx = px - x0, fy = py - y0;
  const int x0i = remainder((int)x0, wi);
  const int y0i = remainder((int)y0, h);
  long long flat;
  if (qt.base != nullptr) {
    // int32 arithmetic, wrapping as the chain's int32 tensors do
    flat = (long long)(int)((unsigned)qt.base[img] + (unsigned)y0i *
                            (unsigned)wi + (unsigned)x0i);
  } else {
    flat = ((long long)img * qt.h + y0i) * qt.w + x0i;
  }
  if (MODE == MODE_ROWS) {
    out.flat[i] = flat;
    out.weights[2 * i] = fx;
    out.weights[2 * i + 1] = fy;
    return;
  }
  float texels[CHANNELS];
  quad_lerp(qt.rows, (size_t)flat, fx, fy, texels);
  materials(texels, tangent, binormal, normal, out, i);
}

// the material terms from K9's (n, 12) texels (SRC_TEXELS) or from the
// quad rows a hook served, (n, 64) u8 in lane order, lerped by the
// pre-pass's weights (SRC_ROWS)
template <int SRC>
__global__ void __launch_bounds__(BLOCK)
    shade_surface_nmap_kernel(const float* __restrict__ texels,
                              const unsigned char* rows,
                              const float* __restrict__ weights, Out out,
                              int n) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  float t[CHANNELS];
  if (SRC == SRC_TEXELS) {
    const float4* p =
        reinterpret_cast<const float4*>(texels + (size_t)i * CHANNELS);
#pragma unroll
    for (int k = 0; k < CHANNELS / 4; ++k) {
      const float4 q = __ldg(p + k);
      t[4 * k] = q.x;
      t[4 * k + 1] = q.y;
      t[4 * k + 2] = q.z;
      t[4 * k + 3] = q.w;
    }
  } else {
    quad_lerp(rows, (size_t)i, weights[2 * i], weights[2 * i + 1], t);
  }
  materials(t, ld3(out.tangent, i), ld3(out.binormal, i), ld3(out.normal, i),
            out, i);
}

int grid_of(int n) { return (n + BLOCK - 1) / BLOCK; }

template <int MODE>
void launch(bool lane_rows, const Hits& in, const Quad& qt, const Out& out,
            int n, float rows, cudaStream_t stream) {
  const int grid = grid_of(n > 0 ? n : 1);
  if (lane_rows) {
    shade_surface_kernel<MODE, true><<<grid, BLOCK, 0, stream>>>(
        in, qt, out, n, rows);
  } else {
    shade_surface_kernel<MODE, false><<<grid, BLOCK, 0, stream>>>(
        in, qt, out, n, rows);
  }
}

}  // namespace

// K10. mode 0 quad (every output), 1 rows (flat and weights for a hook),
// 2 mip (K9's inputs and the spread); lane_rows: attr holds the lanes'
// own rows. hits: tri, u, v and the five payload planes (null without).
// quad: rows, base (null: the slab of extents h, w). out: valid,
// world_pos, V, N, albedo, roughness, metallic, normal, tangent, binormal,
// uv, attr, spread, flat, weights; those the mode does not write may be
// null. proj11 and rows: the projection's [1][1] and the image's rows, for
// the spread (MODE_MIP).
extern "C" int tpurt_shade_surface(
    int mode, int lane_rows, const int* tri, const float* u, const float* v,
    const float* texu, const float* texv, const float* img,
    const float* texh, const float* texw, const float* attr,
    long long attr_stride, const float* camera_pos, const float* proj11,
    const unsigned char* quad, const int* base, long long quad_h,
    long long quad_w, bool* valid, float* world_pos, float* view,
    float* normal_out, float* albedo, float* roughness, float* metallic,
    float* normal, float* tangent, float* binormal, float* uv,
    float* attr_out, float* spread, long long* flat, float* weights, int n,
    float rows, cudaStream_t stream) {
  const Hits in{tri,  u,    v,           texu,       texv,  img,
                texh, texw, attr,        attr_stride, camera_pos, proj11};
  const Quad qt{quad, base, quad_h, quad_w};
  const Out out{valid,  world_pos, view,     normal_out, albedo,
                roughness, metallic, normal, tangent,    binormal,
                uv,     attr_out,  spread,   flat,       weights};
  if (n > 0 || mode == MODE_MIP) {
    if (mode == MODE_QUAD) {
      launch<MODE_QUAD>(lane_rows != 0, in, qt, out, n, rows, stream);
    } else if (mode == MODE_ROWS) {
      launch<MODE_ROWS>(lane_rows != 0, in, qt, out, n, rows, stream);
    } else {
      launch<MODE_MIP>(lane_rows != 0, in, qt, out, n, rows, stream);
    }
  }
  return (int)cudaGetLastError();
}

// K10's epilogue. src 0: texels (n, 12) f32 (K9's); 1: rows (n, 64) u8
// and weights (n, 2). Reads normal, tangent, binormal; writes N, albedo,
// roughness, metallic.
extern "C" int tpurt_shade_surface_nmap(
    int src, const float* texels, const unsigned char* rows,
    const float* weights, const float* normal, const float* tangent,
    const float* binormal, float* normal_out, float* albedo,
    float* roughness, float* metallic, int n, cudaStream_t stream) {
  const Out out{nullptr, nullptr, nullptr,  normal_out,
                albedo,  roughness, metallic, const_cast<float*>(normal),
                const_cast<float*>(tangent), const_cast<float*>(binormal),
                nullptr, nullptr,   nullptr,  nullptr,
                nullptr};
  if (n > 0) {
    const int grid = grid_of(n);
    if (src == SRC_TEXELS) {
      shade_surface_nmap_kernel<SRC_TEXELS><<<grid, BLOCK, 0, stream>>>(
          texels, rows, weights, out, n);
    } else {
      shade_surface_nmap_kernel<SRC_ROWS><<<grid, BLOCK, 0, stream>>>(
          texels, rows, weights, out, n);
    }
  }
  return (int)cudaGetLastError();
}

// XeGTAO edge-aware denoise (K4) written for Hopper, one pass per launch.
//
// Replaces tpurt/kernels/gtao_pallas.py::_chain_kernel (K4,
// denoise_chain_pallas). The TPU kernel fuses all N passes over row blocks
// with an N-row halo and re-clamps the halo between passes. Here each pass
// is its own launch with a u8 image between passes, which is exactly the
// semantics of tpurt's XLA chain (passes/gtao.py:denoise_pass applied N
// times), so no halo re-clamping is needed. The last pass scales by 1.5 and
// stores the u16 value without a clamp (values reach ~383) as int32, the
// type the frame's tonemap reads, so no conversion launch follows.
//
// What bounds it on an H100: instruction issue, then launch latency. Its
// bytes (AO and packed edges in, u8 or int32 out) take about a
// microsecond; per pixel the arithmetic is some 60 multiplies, adds and
// selects and two IEEE divides. The design takes out the work that does not
// change the bits:
//   * a block covers a 128x8 pixel tile, each thread 4 neighbouring pixels
//     of one row (a 2-D grid: no integer divide per pixel);
//   * the tile's AO and packed edges and their 1-pixel clamped halo are
//     staged once in shared memory, the interior with 4-byte loads (1 byte
//     at a time on a ragged tile or unaligned rows), all of a thread's
//     loads issued before its first shared store, each texel's four edges
//     unpacked once per tile (not five times per pixel), into
//     structure-of-arrays planes that a thread reads as float4s;
//   * AO / 255 and the 2-bit edges / 3 are lookups: a 256-entry table of
//     (float)k / 255.0f and four values (float)e / 3.0f, computed in shared
//     memory at block start by the same IEEE divisions, so their bits are
//     the divisions' by construction;
//   * the 4 outputs of a thread leave in one 4-byte (u8) or 16-byte
//     (int32) store.
// The AO leak's division by 1.5 and the final total / sum_weight stay IEEE
// divides.
//
// Exactness: the operation order of denoise_pass (edge symmetry, AO leak,
// diagonal weights, the 9 taps added in tpurt's order); --fmad=false.
//
// The variants of tpurt's denoise_pass (passes/gtao.py:628-709), which
// tpurt runs on its XLA chain, are the same kernel's template flags,
// gtao_denoise_kernel<BENT, LP, FINAL>, on the same tile:
//   * BENT: the AO term is the packed uint32 (bn, vis) texel; staging
//     decodes it once per texel into four shared planes (bn * 2 - 1 through
//     the /255 table, and vis), each pixel blurs the four channels with the
//     same weights, normalizes the bent normal and re-encodes it (the final
//     pass scales vis by 1.5 first). The texels are staged one 4-byte load
//     each (the 1-byte path's loop) and a thread's 4 outputs leave in one
//     16-byte store.
//   * LP: tpurt's lpfloat blur, every staged value, edge weight and
//     weighted sum rounded to f16 after its operation (csrc/gtao_common.cuh
//     lp, in kernels/gtao_denoise.py's plain order).
// With both false the operations are the exact pass's.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// threads of a block, a tile's rows, pixels per thread and the tile's width
#define DN_THREADS 256
#define DN_ROWS 8
#define DN_PX 4
#define DN_TILE_W 128
// shared rows (the tile's and one halo row on each side) and their length:
// column DN_COL0 holds the tile's first pixel, DN_COL0 - 1 the left halo,
// DN_COL0 + DN_TILE_W the right one; DN_COL0 = 4 keeps a thread's 4 pixels
// 16-byte aligned
#define DN_SROWS (DN_ROWS + 2)
#define DN_COL0 4
#define DN_SCOLS 136
// staging work items per thread: 4-byte words of the interior, or texels
// on a ragged tile
#define DN_WORDS ((DN_SROWS * DN_TILE_W / 4 + DN_THREADS - 1) / DN_THREADS)
#define DN_TEXELS ((DN_SROWS * DN_TILE_W + DN_THREADS - 1) / DN_THREADS)

#include "gtao_common.cuh"

namespace {

using namespace gtao;

// AO channels of a staged texel: the bent normal and visibility, or the
// visibility alone
template <bool BENT>
struct Tile {
  float vis[BENT ? 4 : 1][DN_SROWS][DN_SCOLS];
  // edges l, r, t, b
  float e[4][DN_SROWS][DN_SCOLS];
};

// one texel into the tile: the AO term through the /255 table, its four
// 2-bit edges (l, r, t, b from the high bits down) through the /3 values
template <bool BENT, bool LP>
__device__ __forceinline__ void stage(Tile<BENT>& s, int row, int col,
                                      uint32_t a, int p, const float* tab,
                                      const float third[4]) {
  if constexpr (BENT) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      s.vis[k][row][col] = lp<LP>(tab[(a >> (8 * k)) & 255u] * 2.0f - 1.0f);
    s.vis[3][row][col] = lp<LP>(tab[a >> 24]);
  } else {
    s.vis[0][row][col] = lp<LP>(tab[a]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int q = (p >> (6 - 2 * k)) & 3;
    s.e[k][row][col] = q == 0   ? third[0]
                       : q == 1 ? third[1]
                       : q == 2 ? third[2]
                                : third[3];
  }
}

// the AO term of texel `at`: packed uint32 (BENT) or u8
template <bool BENT>
__device__ __forceinline__ uint32_t term_at(const void* ao, size_t at) {
  if constexpr (BENT) return static_cast<const uint32_t*>(ao)[at];
  return static_cast<const uint8_t*>(ao)[at];
}

__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  out[0] = q.x;
  out[1] = q.y;
  out[2] = q.z;
  out[3] = q.w;
}

template <bool BENT, bool LP, bool FINAL>
__global__ void __launch_bounds__(DN_THREADS)
gtao_denoise_kernel(const void* __restrict__ ao,
                    const uint8_t* __restrict__ edges, int h, int w,
                    int wide, float blur, void* __restrict__ out) {
  constexpr int NV = BENT ? 4 : 1;
  __shared__ float tab[256];
  __shared__ float third_s[4];
  __shared__ __align__(16) Tile<BENT> s;

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * DN_TILE_W, y0 = blockIdx.y * DN_ROWS;
  tab[tid] = (float)tid / 255.0f;
  if (tid < 4) third_s[tid] = lp<LP>((float)tid / 3.0f);
  __syncthreads();
  float third[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) third[k] = third_s[k];

  // the tile's texels, rows and columns clamped to the image
  if (!BENT && wide && x0 + DN_TILE_W <= w) {
    const uint8_t* ao8 = static_cast<const uint8_t*>(ao);
    uint32_t a[DN_WORDS], p[DN_WORDS];
#pragma unroll
    for (int j = 0; j < DN_WORDS; ++j) {
      const int i = tid + j * DN_THREADS;
      const int row = min(i / (DN_TILE_W / 4), DN_SROWS - 1);
      const int gy = min(max(y0 - 1 + row, 0), h - 1);
      const size_t at = (size_t)gy * w + x0 + 4 * (i % (DN_TILE_W / 4));
      a[j] = *reinterpret_cast<const uint32_t*>(ao8 + at);
      p[j] = *reinterpret_cast<const uint32_t*>(edges + at);
    }
#pragma unroll
    for (int j = 0; j < DN_WORDS; ++j) {
      const int i = tid + j * DN_THREADS;
      if (i >= DN_SROWS * (DN_TILE_W / 4)) break;
      const int row = i / (DN_TILE_W / 4), word = i % (DN_TILE_W / 4);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        stage<BENT, LP>(s, row, DN_COL0 + 4 * word + k,
                        (a[j] >> (8 * k)) & 255, (p[j] >> (8 * k)) & 255,
                        tab, third);
    }
  } else {
    uint32_t a[DN_TEXELS];
    int p[DN_TEXELS];
#pragma unroll
    for (int j = 0; j < DN_TEXELS; ++j) {
      const int i = tid + j * DN_THREADS;
      const int row = min(i / DN_TILE_W, DN_SROWS - 1);
      const int gy = min(max(y0 - 1 + row, 0), h - 1);
      const size_t at = (size_t)gy * w + min(x0 + i % DN_TILE_W, w - 1);
      a[j] = term_at<BENT>(ao, at);
      p[j] = edges[at];
    }
#pragma unroll
    for (int j = 0; j < DN_TEXELS; ++j) {
      const int i = tid + j * DN_THREADS;
      if (i >= DN_SROWS * DN_TILE_W) break;
      stage<BENT, LP>(s, i / DN_TILE_W, DN_COL0 + i % DN_TILE_W, a[j], p[j],
                      tab, third);
    }
  }
  if (tid < 2 * DN_SROWS) {
    const int row = tid >> 1, right = tid & 1;
    const int gy = min(max(y0 - 1 + row, 0), h - 1);
    const int gx = right ? min(x0 + DN_TILE_W, w - 1) : max(x0 - 1, 0);
    const size_t at = (size_t)gy * w + gx;
    stage<BENT, LP>(s, row, right ? DN_COL0 + DN_TILE_W : DN_COL0 - 1,
                    term_at<BENT>(ao, at), edges[at], tab, third);
  }
  __syncthreads();

  const int tx = tid % 32, ty = tid / 32;
  const int y = y0 + ty, x = x0 + DN_PX * tx;
  if (y >= h || x >= w) return;
  const int R = ty + 1, c = DN_COL0 + DN_PX * tx;

  // the centre row's edges and AO at columns c - 1 .. c + 4 (index j <->
  // column c - 1 + j), the rows above and below at c .. c + 3 (AO at
  // c - 1 .. c + 4)
  float cl[6], cr[6], ct[6], cb[6];
  load4(&s.e[0][R][c], cl + 1);
  load4(&s.e[1][R][c], cr + 1);
  load4(&s.e[2][R][c], ct + 1);
  load4(&s.e[3][R][c], cb + 1);
  cl[0] = 0.0f;
  cr[0] = s.e[1][R][c - 1];
  ct[0] = s.e[2][R][c - 1];
  cb[0] = s.e[3][R][c - 1];
  cl[5] = s.e[0][R][c + 4];
  cr[5] = 0.0f;
  ct[5] = s.e[2][R][c + 4];
  cb[5] = s.e[3][R][c + 4];
  float tl[4], tr[4], tb[4], bl[4], br[4], bt[4];
  load4(&s.e[0][R - 1][c], tl);
  load4(&s.e[1][R - 1][c], tr);
  load4(&s.e[3][R - 1][c], tb);
  load4(&s.e[0][R + 1][c], bl);
  load4(&s.e[1][R + 1][c], br);
  load4(&s.e[2][R + 1][c], bt);
  float vis[NV][3][6];
#pragma unroll
  for (int ch = 0; ch < NV; ++ch) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      vis[ch][dy][0] = s.vis[ch][R - 1 + dy][c - 1];
      load4(&s.vis[ch][R - 1 + dy][c], vis[ch][dy] + 1);
      vis[ch][dy][5] = s.vis[ch][R - 1 + dy][c + 4];
    }
  }

  uint32_t packed[DN_PX];
#pragma unroll
  for (int k = 0; k < DN_PX; ++k) {
    const int j = k + 1;
    // symmetry enforcement
    float ecl = lp<LP>(cl[j] * cr[j - 1]);
    float ecr = lp<LP>(cr[j] * cl[j + 1]);
    float ect = lp<LP>(ct[j] * tb[k]);
    float ecb = lp<LP>(cb[j] * bt[k]);
    // AO leak for pixels with 3-4 edges
    const float esum = lp<LP>(ecl + ecr + ect + ecb);
    const float edginess = lp<LP>(
        lp<LP>(clip(lp<LP>(lit<LP>(1.5) - esum), 0.0f, 1.0f) /
               lit<LP>(1.5)) *
        lit<LP>(0.5));
    ecl = clip(lp<LP>(ecl + edginess), 0.0f, 1.0f);
    ecr = clip(lp<LP>(ecr + edginess), 0.0f, 1.0f);
    ect = clip(lp<LP>(ect + edginess), 0.0f, 1.0f);
    ecb = clip(lp<LP>(ecb + edginess), 0.0f, 1.0f);

    const float diag = lit<LP>(0.425);
    const float w_tl =
        lp<LP>(diag * lp<LP>(lp<LP>(ecl * ct[j - 1]) + lp<LP>(ect * tl[k])));
    const float w_tr =
        lp<LP>(diag * lp<LP>(lp<LP>(ect * tr[k]) + lp<LP>(ecr * ct[j + 1])));
    const float w_bl =
        lp<LP>(diag * lp<LP>(lp<LP>(ecb * bl[k]) + lp<LP>(ecl * cb[j - 1])));
    const float w_br =
        lp<LP>(diag * lp<LP>(lp<LP>(ecr * cb[j + 1]) + lp<LP>(ecb * br[k])));

    // the 9 taps in tpurt's order: centre, l, r, t, b, tl, tr, bl, br
    const float wt[8] = {ecl, ecr, ect, ecb, w_tl, w_tr, w_bl, w_br};
    const int ty_[8] = {1, 1, 0, 2, 0, 0, 2, 2};
    const int tx_[8] = {j - 1, j + 1, j, j, j - 1, j + 1, j - 1, j + 1};
    float sum_weight = blur;
    float o[NV];
#pragma unroll
    for (int ch = 0; ch < NV; ++ch) {
      float total = lp<LP>(vis[ch][1][j] * blur);
#pragma unroll
      for (int t = 0; t < 8; ++t)
        total = lp<LP>(total + lp<LP>(vis[ch][ty_[t]][tx_[t]] * wt[t]));
      o[ch] = total;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) sum_weight = lp<LP>(sum_weight + wt[t]);
#pragma unroll
    for (int ch = 0; ch < NV; ++ch) o[ch] = lp<LP>(o[ch] / sum_weight);

    if constexpr (BENT) {
      // XeGTAO_Output, bent-normal branch
      const float v = FINAL ? lp<LP>(o[3] * lit<LP>(1.5)) : o[3];
      const float eps = LP ? 0.0f : 1e-20f;
      const float blen = nmax(
          lp<LP>(sqrtf(lp<LP>(lp<LP>(o[0] * o[0]) + lp<LP>(o[1] * o[1]) +
                              lp<LP>(o[2] * o[2])))),
          eps);
      packed[k] = encode_bent<LP>(v, lp<LP>(o[0] / blen),
                                  lp<LP>(o[1] / blen), lp<LP>(o[2] / blen));
    } else if constexpr (FINAL) {
      // the final pass keeps the u16 store's bits (no clamp above 1)
      packed[k] =
          (uint32_t)(uint16_t)(int)(nmax(o[0] * 1.5f, 0.0f) * 255.0f + 0.5f);
    } else {
      packed[k] =
          (uint32_t)(uint8_t)(int)(clip(o[0], 0.0f, 1.0f) * 255.0f + 0.5f);
    }
  }

  // 4-byte output texels: the packed bent term, or the final pass's int32
  constexpr bool WORDS = BENT || FINAL;
  const size_t at = (size_t)y * w + x;
  if (wide) {
    // w % 4 == 0, so all 4 pixels lie in the image and `at` is 4-aligned
    if (WORDS)
      *reinterpret_cast<uint4*>(static_cast<int32_t*>(out) + at) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    else
      *reinterpret_cast<uint32_t*>(static_cast<uint8_t*>(out) + at) =
          packed[0] | (packed[1] << 8) | (packed[2] << 16) |
          (packed[3] << 24);
    return;
  }
#pragma unroll
  for (int k = 0; k < DN_PX; ++k) {
    if (x + k < w) {
      if (WORDS)
        static_cast<int32_t*>(out)[at + k] = (int32_t)packed[k];
      else
        static_cast<uint8_t*>(out)[at + k] = (uint8_t)packed[k];
    }
  }
}

template <bool BENT, bool LP>
int launch(const void* ao, const uint8_t* edges, int h, int w, int wide,
           float blur, int final_pass, void* out, cudaStream_t stream) {
  const dim3 grid((w + DN_TILE_W - 1) / DN_TILE_W,
                  (h + DN_ROWS - 1) / DN_ROWS);
  if (final_pass)
    gtao_denoise_kernel<BENT, LP, true><<<grid, DN_THREADS, 0, stream>>>(
        ao, edges, h, w, wide, blur, out);
  else
    gtao_denoise_kernel<BENT, LP, false><<<grid, DN_THREADS, 0, stream>>>(
        ao, edges, h, w, wide, blur, out);
  return (int)cudaGetLastError();
}

}  // namespace

// one pass over (h, w) AO and packed edges into `out`. ao: u8, or the
// packed uint32 term with bent; out: the packed uint32 with bent, else
// int32 u16 values when final_pass, else u8. lp: the fp16 instantiation
// (blur is then already f16-valued, kernels/gtao_denoise.py).
extern "C" int tpurt_gtao_denoise(const void* ao, const uint8_t* edges,
                                  int h, int w, float blur, int final_pass,
                                  int bent, int lp, void* out,
                                  cudaStream_t stream) {
  if (h <= 0 || w <= 0) return (int)cudaGetLastError();
  // 16-byte (int32, uint32) and 4-byte (u8) stores need rows of a multiple
  // of 4 pixels (out is a fresh allocation); the u8 staging's 4-byte loads
  // need 4-byte aligned inputs too
  const int wide = (w % 4 == 0) &&
                   (bent || (((uintptr_t)ao % 4 == 0) &&
                             ((uintptr_t)edges % 4 == 0)));
  if (bent && lp)
    return launch<true, true>(ao, edges, h, w, wide, blur, final_pass, out,
                              stream);
  if (bent)
    return launch<true, false>(ao, edges, h, w, wide, blur, final_pass, out,
                               stream);
  if (lp)
    return launch<false, true>(ao, edges, h, w, wide, blur, final_pass, out,
                               stream);
  return launch<false, false>(ao, edges, h, w, wide, blur, final_pass, out,
                              stream);
}

// Red-black SOR sweeps of the variational flow solver on Hopper (sm_90a).
//
// Replaces: rs_sfm_tpu/ops/pallas/sor.py::sor_sweeps_pallas (kernel
//           _sor_kernel), the TPU kernel that runs the inner solve of
//           every warp of rs_sfm_tpu/flow/dense.py::_level_solve.
//
// What it computes: `iters` red-black sweeps with over-relaxation omega of
// the lagged-diffusivity Charbonnier point solve, on the 8 coefficient
// planes (ix, iy, c, ixx, ixy, iyy, cgx, cgy) of the TPU kernel's absolute
// form.  Per pixel of the colour being updated, at its current (u, v):
//   wd = wbr / sqrt(r^2 + eps2),           r = ix u + iy v + c
//   wg = wgrad / sqrt(rgx^2 + rgy^2 + eps2), rgx = cgx + ixx u + ixy v, ...
//   the 2x2 system with the 4-neighbour averages (Neumann edges: a missing
//   neighbour is the pixel itself), solved by Cramer's rule, and
//   u += omega (u_new - u).
// The colour of (y, x) is (y + x) mod 2 on the whole grid; colour 0 is
// updated first in every sweep.
//
// What bounds it on this card: float32 operations.  A sweep does about 92
// operations per pixel (two square roots and four divisions among them)
// against 48 bytes that must move over a whole call (8 planes and (u, v)
// read, (u, v) written); at 20 sweeps that is above the card's ridge point.
// The census term adds about 168 operations (8 more square roots and
// divisions) and 96 bytes a pixel.
//
// What the design does about it: each launch runs up to K sweeps (2K colour
// passes) on tiles held in shared memory, so the planes cross HBM once per
// K sweeps instead of once per colour pass.  A block copies its tile plus
// a halo of 2K pixels on every side (clipped at the image edges) with
// cp.async, updates it in place with a __syncthreads() between colour
// passes, and writes back only the interior.  The cells a pass must get
// right shrink by one pixel per pass towards the interior (the red-black
// dependency cone), so pass p of 2s updates only the cells within 2s-1-p
// of the interior; a cell at the halo's outer ring is read but never
// updated, and a read beyond the copied region (only ever from that ring or
// at the true image edge) takes the cell itself: Neumann at the image edge.
// Launches read one (u, v) buffer and write another, since a block's halo
// is its neighbours' interior.  The first launch reads u and v where the
// caller has them, with a column stride of 1 (planes) or 2 (the halves of
// an (H, W, 2) flow, as the flow's median writes it).  A plane whose whole copy fits in one
// block's shared memory runs all its sweeps in one launch with no halo.
// The tile plan (tile size, K, halo) comes from the wrapper
// (ops/kernels/sor.py::tile_plan).
//
// Shared-memory layout: each of the 10 planes (8 coefficients, u, v) is
// split by colour, [colour][row][x / 2], so the threads of a warp touch
// consecutive words for the cell itself and for all four neighbours (which
// are of the other colour): no bank conflicts.
//
// The census data term (DenseFlowConfig.census_weight > 0; the JAX package
// runs it only on its XLA loop, rs_sfm_tpu/flow/dense.py:681-689): an
// optional operand of 24 sweep-invariant planes, cjx, cjy and ccc of each
// of the 8 census channels (planes c, 8 + c and 16 + c), in the absolute
// form rc = cjx u + cjy v + ccc.  Per channel, in the order 0 to 7, the
// point solve adds the Charbonnier weight wc = census_weight / sqrt(rc^2 +
// eps2) (written (1 / s) * census_weight, as wd is) times cjx cjx, cjx cjy
// and cjy cjy to a11, a12 and a22, and subtracts wc cjx ccc, wc cjy ccc from
// b1 and b2; each of the five is summed over the channels first, from
// channel 0's term, then added.  The census planes make a pixel 136 bytes
// instead of 40, so the 40x80 tile with its 8-pixel halo could not stage
// them in a block's shared memory: a block stages the 10 planes of the
// tile plan without census and reads the 24 census planes of the cell being
// updated from global memory through the read-only cache (kCensus).  On an
// H100 that was the faster of the two designs timed at full HD (3.55
// against 3.81 ms for 20 sweeps with all 34 planes staged on 16x32 tiles),
// and the two took the same time summed over the e2e pyramid's 7 levels.
//
// Numerics: compiled with -fmad=false, with IEEE sqrtf and '/', and in the
// operation order of the plain PyTorch version (ops/kernels/sor.py::
// sor_sweeps_plain), which writes wbr / s as (1 / s) * wbr because that is
// how PyTorch evaluates a number divided by a tensor.  The result is
// bit-identical to the plain version on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int NPLANES = 10;  // ix, iy, c, ixx, ixy, iyy, cgx, cgy, u, v
constexpr int NCENSUS = 8;   // census channels: cjx, cjy, ccc planes each

struct SorParams {
  float omega, lam, eps2, wbr, wgrad, census_weight;
};

struct Tiling {
  int h, w;            // image
  int tile_h, tile_w;  // interior of a block
  int halo;
  int cap_h, cap_hw;   // shared rows, and cells per colour and row
};

__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// The point solve of cell (ly, lx = 2 j + par) of the copy: its new
// (u, v).  row_c is the start of its row in its colour's half of plane 0,
// row_o the same row in the other colour's half.  With kCensus, census + g
// is the cell's value of census plane 0 in global memory (plane stride n).
template <bool kCensus>
__device__ __forceinline__ void point_solve(
    const float* row_c, const float* row_o, int64_t plane_stride, int j,
    int par, int ly, int lx, int lh, int lw, int hw, const SorParams& prm,
    const float* __restrict__ census, int64_t g, int64_t n,
    float& u_new_out, float& v_new_out) {
  const float ix = row_c[j];
  const float iy = row_c[plane_stride + j];
  const float c = row_c[2 * plane_stride + j];
  const float ixx = row_c[3 * plane_stride + j];
  const float ixy = row_c[4 * plane_stride + j];
  const float iyy = row_c[5 * plane_stride + j];
  const float cgx = row_c[6 * plane_stride + j];
  const float cgy = row_c[7 * plane_stride + j];
  const float uc = row_c[8 * plane_stride + j];
  const float vc = row_c[9 * plane_stride + j];

  const float lam = prm.lam;
  const float eps2 = prm.eps2;
  const float r = ix * uc + iy * vc + c;
  const float wd = (1.0f / sqrtf(r * r + eps2)) * prm.wbr;
  const float rgx = cgx + ixx * uc + ixy * vc;
  const float rgy = cgy + ixy * uc + iyy * vc;
  const float wg = (1.0f / sqrtf(rgx * rgx + rgy * rgy + eps2)) * prm.wgrad;

  // Neumann neighbours: up, down, left, right (dense.py's navg order); all
  // of the other colour, at half-row index j (up, down), j - 1 + par (left)
  // and j + par (right).
  const float* uo = row_o + 8 * plane_stride;
  const float* vo = row_o + 9 * plane_stride;
  const int jl = j - 1 + par, jr = j + par;
  const float u_up = ly > 0 ? uo[j - hw] : uc;
  const float u_dn = ly < lh - 1 ? uo[j + hw] : uc;
  const float u_lf = lx > 0 ? uo[jl] : uc;
  const float u_rt = lx < lw - 1 ? uo[jr] : uc;
  const float v_up = ly > 0 ? vo[j - hw] : vc;
  const float v_dn = ly < lh - 1 ? vo[j + hw] : vc;
  const float v_lf = lx > 0 ? vo[jl] : vc;
  const float v_rt = lx < lw - 1 ? vo[jr] : vc;
  const float ubar = (u_up + u_dn + u_lf + u_rt) * 0.25f;
  const float vbar = (v_up + v_dn + v_lf + v_rt) * 0.25f;

  float a11 = lam + wd * ix * ix + wg * (ixx * ixx + ixy * ixy);
  float a12 = wd * ix * iy + wg * (ixx * ixy + ixy * iyy);
  float a22 = lam + wd * iy * iy + wg * (ixy * ixy + iyy * iyy);
  float b1 = lam * ubar - wd * ix * c - wg * (ixx * cgx + ixy * cgy);
  float b2 = lam * vbar - wd * iy * c - wg * (ixy * cgx + iyy * cgy);
  if (kCensus) {
    float s11 = 0.0f, s12 = 0.0f, s22 = 0.0f, sb1 = 0.0f, sb2 = 0.0f;
#pragma unroll
    for (int ch = 0; ch < NCENSUS; ++ch) {
      const float cx = __ldg(census + ch * n + g);
      const float cy = __ldg(census + (NCENSUS + ch) * n + g);
      const float cc = __ldg(census + (2 * NCENSUS + ch) * n + g);
      const float rc = cx * uc + cy * vc + cc;
      const float wc = (1.0f / sqrtf(rc * rc + eps2)) * prm.census_weight;
      const float wx = wc * cx, wy = wc * cy;
      // Channel 0's terms start the sums (no 0 + x, which would turn -0
      // into +0).
      if (ch == 0) {
        s11 = wx * cx;
        s12 = wx * cy;
        s22 = wy * cy;
        sb1 = wx * cc;
        sb2 = wy * cc;
      } else {
        s11 = s11 + wx * cx;
        s12 = s12 + wx * cy;
        s22 = s22 + wy * cy;
        sb1 = sb1 + wx * cc;
        sb2 = sb2 + wy * cc;
      }
    }
    a11 = a11 + s11;
    a12 = a12 + s12;
    a22 = a22 + s22;
    b1 = b1 - sb1;
    b2 = b2 - sb2;
  }
  float det = a11 * a22 - a12 * a12;
  det = fabsf(det) < 1e-12f ? 1e-12f : det;
  const float u_new = (a22 * b1 - a12 * b2) / det;
  const float v_new = (a11 * b2 - a12 * b1) / det;
  u_new_out = uc + prm.omega * (u_new - uc);
  v_new_out = vc + prm.omega * (v_new - vc);
}

template <bool kCensus>
__global__ void __launch_bounds__(MAX_THREADS)
sor_tile_kernel(const float* __restrict__ coef, const float* __restrict__ u_in,
                const float* __restrict__ v_in, float* __restrict__ u_out,
                float* __restrict__ v_out,
                const float* __restrict__ census, Tiling tl, int sweeps,
                SorParams prm, int in_cs) {
  extern __shared__ float smem[];
  const int h = tl.h, w = tl.w;
  const int ty0 = blockIdx.y * tl.tile_h, tx0 = blockIdx.x * tl.tile_w;
  const int ty1 = min(h, ty0 + tl.tile_h), tx1 = min(w, tx0 + tl.tile_w);
  const int gy0 = max(0, ty0 - tl.halo), gx0 = max(0, tx0 - tl.halo);
  const int lh = min(h, ty1 + tl.halo) - gy0;
  const int lw = min(w, tx1 + tl.halo) - gx0;
  const int q = (gy0 + gx0) & 1;  // colour of local cell (0, 0)
  const int hw = tl.cap_hw;
  const int64_t colour_stride = (int64_t)tl.cap_h * hw;
  const int64_t plane_stride = 2 * colour_stride;
  // Cell (ly, lx) of plane k: smem + at(k, ly, lx).
  auto at = [&](int k, int ly, int lx) -> int64_t {
    return k * plane_stride + ((ly + lx + q) & 1) * colour_stride
           + (int64_t)ly * hw + (lx >> 1);
  };

  const int64_t n = (int64_t)h * w;
  for (int ly = threadIdx.y; ly < lh; ly += blockDim.y) {
    for (int lx = threadIdx.x; lx < lw; lx += blockDim.x) {
      const int64_t g = (int64_t)(gy0 + ly) * w + gx0 + lx;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        copy4_async(smem + at(k, ly, lx), coef + k * n + g);
      copy4_async(smem + at(8, ly, lx), u_in + g * in_cs);
      copy4_async(smem + at(9, ly, lx), v_in + g * in_cs);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  for (int pass = 0; pass < 2 * sweeps; ++pass) {
    const int colour = pass & 1;
    const int m = 2 * sweeps - 1 - pass;  // margin around the interior
    const int ry0 = max(0, ty0 - m) - gy0, ry1 = min(h, ty1 + m) - gy0;
    const int rx0 = max(0, tx0 - m) - gx0, rx1 = min(w, tx1 + m) - gx0;
    for (int ly = ry0 + threadIdx.y; ly < ry1; ly += blockDim.y) {
      const int par = (ly + q + colour) & 1;  // lx = 2 j + par
      float* row_c = smem + colour * colour_stride + (int64_t)ly * hw;
      const float* row_o = smem + (1 - colour) * colour_stride
                           + (int64_t)ly * hw;
      for (int j = threadIdx.x; j < hw; j += blockDim.x) {
        const int lx = 2 * j + par;
        if (lx < rx0 || lx >= rx1) continue;
        float un, vn;
        point_solve<kCensus>(row_c, row_o, plane_stride, j, par, ly, lx, lh,
                             lw, hw, prm, census,
                             (int64_t)(gy0 + ly) * w + gx0 + lx, n, un, vn);
        row_c[8 * plane_stride + j] = un;
        row_c[9 * plane_stride + j] = vn;
      }
    }
    __syncthreads();
  }

  for (int gy = ty0 + threadIdx.y; gy < ty1; gy += blockDim.y) {
    for (int gx = tx0 + threadIdx.x; gx < tx1; gx += blockDim.x) {
      const int64_t g = (int64_t)gy * w + gx;
      u_out[g] = smem[at(8, gy - gy0, gx - gx0)];
      v_out[g] = smem[at(9, gy - gy0, gx - gx0)];
    }
  }
}

template <bool kCensus>
int launch_all(const float* coef, const float* u_in, const float* v_in,
               float* u_out, float* v_out, float* u_tmp, float* v_tmp,
               const float* census, int in_cs, const Tiling& tl, int iters,
               int sweeps, const SorParams& prm, int* launches,
               cudaStream_t stream) {
  // 10 planes of the copied region, split by colour.
  const size_t smem = sizeof(float) * NPLANES * 2 * tl.cap_h * tl.cap_hw;
  auto kernel = sor_tile_kernel<kCensus>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int bx = std::min(tl.cap_hw, MAX_THREADS);
  const int by = std::max(1, std::min(tl.cap_h, MAX_THREADS / bx));
  const dim3 grid((tl.w + tl.tile_w - 1) / tl.tile_w,
                  (tl.h + tl.tile_h - 1) / tl.tile_h);
  const int n_launch = (iters + sweeps - 1) / sweeps;
  const float* us = u_in;
  const float* vs = v_in;
  for (int l = 0; l < n_launch; ++l) {
    // The last launch writes (u_out, v_out); the ones before alternate.
    const bool to_out = ((n_launch - 1 - l) & 1) == 0;
    float* ud = to_out ? u_out : u_tmp;
    float* vd = to_out ? v_out : v_tmp;
    const int s = std::min(sweeps, iters - l * sweeps);
    kernel<<<grid, dim3(bx, by), smem, stream>>>(
        coef, us, vs, ud, vd, census, tl, s, prm, l == 0 ? in_cs : 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
    us = ud;
    vs = vd;
  }
  return 0;
}

}  // namespace

// coef: (8, h, w) f32; u_in, v_in: (h, w) f32 with column stride in_cs
// (1 or 2) and row stride in_cs * w, read only.  Runs `iters`
// sweeps in ceil(iters / sweeps) launches of `sweeps` sweeps each (the last
// may run fewer) over tiles of tile_h x tile_w with the given halo; the
// result lands in (u_out, v_out).  (u_tmp, v_tmp) is the other buffer of
// the ping-pong between launches (unused with one launch).  census: null,
// or (24, h, w) f32 (cjx, cjy, ccc of the 8 channels) with weight
// census_weight, read from global memory.  Returns the number of launches
// in *launches and a cudaError_t.
extern "C" int sor_launch(const float* coef, const float* u_in,
                          const float* v_in, float* u_out, float* v_out,
                          float* u_tmp, float* v_tmp, int in_cs, int h, int w,
                          int iters, int tile_h, int tile_w, int halo,
                          int sweeps,
                          float omega, float lam, float eps2, float wbr,
                          float wgrad, const float* census,
                          float census_weight, int* launches, void* stream) {
  *launches = 0;
  if (h <= 0 || w <= 0 || iters <= 0) return 0;
  if (tile_h <= 0 || tile_w <= 0 || sweeps <= 0 || halo < 0 || in_cs < 1)
    return (int)cudaErrorInvalidValue;
  const SorParams prm{omega, lam, eps2, wbr, wgrad, census_weight};
  Tiling tl;
  tl.h = h;
  tl.w = w;
  tl.tile_h = tile_h;
  tl.tile_w = tile_w;
  tl.halo = halo;
  tl.cap_h = std::min(h, tile_h + 2 * halo);
  tl.cap_hw = (std::min(w, tile_w + 2 * halo) + 1) / 2;
  cudaStream_t s = (cudaStream_t)stream;
  if (census == nullptr)
    return launch_all<false>(coef, u_in, v_in, u_out, v_out, u_tmp, v_tmp,
                             census, in_cs, tl, iters, sweeps, prm, launches,
                             s);
  return launch_all<true>(coef, u_in, v_in, u_out, v_out, u_tmp, v_tmp,
                          census, in_cs, tl, iters, sweeps, prm, launches, s);
}

// Discrete flow search on Hopper (sm_90a): one launch per search.
//
// Replaces: the search around rs_sfm_tpu/ops/pallas/warp.py::bilinear_warp.
//           The JAX package's warp-local refine (flow/dense.py::
//           _discrete_refine, exact mode) and coarse integer search
//           (::_coarse_init) scan (2r+1)^2 integer candidates per pixel in a
//           lax.scan: each candidate warps I2 (the TPU kernel), squares its
//           difference with I1, box-sums it over 5x5 and updates the
//           per-pixel best / second-best.  The shifted refine
//           (::_discrete_refine with refine_shifted) warps I2 once and
//           reads each candidate at an integer shift of that plane.  The
//           port ran that scan from the host, about 24 small kernels a
//           candidate; here a block runs all of it for a tile of pixels.
//
// What it computes, per pixel p = (y, x), for candidate k = dy * side + dx
// (side = 2r + 1, offset (du, dv) = (dx - r, dy - r)), in scan order:
//   refine: cand = flow(p) + (du, dv) (rounded to float32), warped = the
//           bilinear, edge-clamped sample of I2 at p + cand, in the operation
//           order of ops/kernels/warp.py::warp_plain;
//   coarse: cand = (du, dv), warped = I2[clip(y + dv), clip(x + du)];
//   shifted: cand = flow(p) + (du, dv) (rounded to float32), warped =
//           I2[clip(y + dv), clip(x + du)], I2 being the plane already
//           warped once by the flow (DIS-style: candidate d tests the flow
//           at p + d plus d);
//   d2 = (warped - I1(p))^2;
//   cost = 5x5 box sum of d2 over edge-clamped neighbours, rows first, each
//          5-sum left to right: x[i+2] + x[i+1] + x[i] + x[i-1] + x[i-2];
//   sel = cost, or with a prior (the relock pass's model flow)
//         cost * (1 + (0.35f * d2) / (d2 + max(r, 1)^2)), d2 the squared
//         distance of cand to the prior at p (dense.py::_prior_factor);
//   then ops/kernels/match.py::_scan's update of (best, second): the best
//   is the first least sel; a dethroned best or a losing candidate becomes
//   the second when it lies more than 1.5 px, max-norm, from the best and
//   its raw cost is the lower; ambiguous = best cost >= 0.9f * second
//   cost (raw costs), and without a prior, with ratio > 0, the fallback
//   where best cost >= ratio * second cost.
//
// What bounds it on this card: operations and their dependences.  The
// inputs are at most a few 135x240 planes (in L2); every (candidate, pixel)
// costs about 50 float operations (a bilinear sample, the square, 8 adds of
// the box, the scan), and the scan is a chain of K dependent steps per pixel.
//
// What the design does about it: a block owns a TH x TW tile.  It first
// stages I1 and the flow on the tile plus a 2-pixel halo (clamped
// coordinates, so the halo holds exactly the clamped neighbours' values)
// and a window of I2 in shared memory: for the coarse and shifted
// searches the window holds every pixel the tile reads (the shifted one
// stages no flow: a pixel reads its own once, into registers); for the
// refine it is centred on the tile's centre flow with MARGIN pixels to
// spare, and a corner outside it is read from global memory (the same
// value, so the result does not depend on the window).  Then it walks the candidates one row of offsets
// (one dv, `side` candidates) at a time: all threads compute d2 on the
// halo into shared memory, then the row 5-sums, then the column 5-sums
// (the costs), and one thread per pixel scans the row's costs in order,
// keeping best and second in registers.  Nothing but the result leaves
// the block.
// The block's loops and barriers leave it bound by latency more than by
// issue, so a block runs 512 threads, and the tile shape is the wrapper's
// choice (ops/kernels/match.py::tile_plan): small tiles give the small
// pyramid levels enough blocks.  A split form (a cost-volume kernel over
// (tile, candidate row) blocks writing the (K, H, W) costs, then a scan
// kernel one thread a pixel) was slower at every search of the e2e pass
// (PERF.md section 6) and is not kept.
//
// The prior costs a pixel's scan 8 more bytes (read once into registers)
// and 10 operations a candidate; without one the scan is as before.
//
// Numerics: compiled with -fmad=false; every value goes through the plain
// version's IEEE operations in its order, so the result is bit-identical to
// ops/kernels/match.py::match_search_plain on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
// Refine: the pixels of flow variation about the tile's centre that the
// staged window of I2 covers; corners outside it are read from global
// memory (the same values).
constexpr int MARGIN = 8;
// The prior's tie-break strength (rs_sfm_tpu/flow/dense.py:437).
constexpr float PRIOR_W = 0.35f;

// Search modes: how a candidate's sample of I2 is read and what the
// candidate is (see the header).
constexpr int MODE_COARSE = 0, MODE_REFINE = 1, MODE_SHIFTED = 2;

// Tile shapes (rows, columns), indexed by the wrapper's plan.
constexpr int N_TILES = 4;
constexpr int TILE_H[N_TILES] = {8, 8, 8, 4};
constexpr int TILE_W[N_TILES] = {32, 16, 8, 8};

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi);
}

// Rows [y0, y0 + h) and columns [x0, x0 + w) of I2 staged in shared
// memory (read at clamped coordinates).
struct Window {
  int y0, x0, h, w;
  const float* s;

  __device__ __forceinline__ float read(const float* __restrict__ i2,
                                        int width, int y, int x) const {
    const int wy = y - y0, wx = x - x0;
    if ((unsigned)wy < (unsigned)h && (unsigned)wx < (unsigned)w)
      return s[wy * w + wx];
    return i2[y * width + x];
  }
};

// The sample of I2 for candidate (du, dv) at image pixel (y, x) of flow f
// (refine: bilinear at x + f + d, edge-clamped, in warp_plain's operation
// order; kShift, the coarse and shifted searches: I2[clip(y + dv),
// clip(x + du)]).
template <bool kShift>
__device__ __forceinline__ float sample(const Window& win,
                                       const float* __restrict__ i2, int h,
                                       int w, int y, int x, float2 f, int du,
                                       int dv) {
  if (kShift) return win.read(i2, w, clampi(y + dv, h - 1),
                               clampi(x + du, w - 1));
  const float cx = f.x + (float)du;
  const float cy = f.y + (float)dv;
  const float xs = fminf(fmaxf((float)x + cx, 0.0f), (float)(w - 1));
  const float ys = fminf(fmaxf((float)y + cy, 0.0f), (float)(h - 1));
  const int x0 = (int)floorf(xs);
  const int y0 = (int)floorf(ys);
  const int x1 = min(x0 + 1, w - 1);
  const int y1 = min(y0 + 1, h - 1);
  const float fx = xs - (float)x0;
  const float fy = ys - (float)y0;
  const float v00 = win.read(i2, w, y0, x0);
  const float v01 = win.read(i2, w, y0, x1);
  const float v10 = win.read(i2, w, y1, x0);
  const float v11 = win.read(i2, w, y1, x1);
  return (1.0f - fy) * ((1.0f - fx) * v00 + fx * v01)
         + fy * ((1.0f - fx) * v10 + fx * v11);
}

// The per-pixel scan state of ops/kernels/match.py::_scan.
struct Scan {
  float best_sel, best_cost, second_cost, bu, bv, su, sv;

  __device__ __forceinline__ void init() {
    best_sel = best_cost = second_cost = INFINITY;
    bu = bv = su = sv = 0.0f;
  }

  // cost: the candidate's raw cost; sel: its selection cost (the raw cost
  // without a prior).
  __device__ __forceinline__ void step(float cost, float sel, float cu,
                                       float cv) {
    const bool better = sel < best_sel;
    const bool far = fmaxf(fabsf(cu - bu), fabsf(cv - bv)) > 1.5f;
    const bool to_second = better && far;
    const bool new_second = !better && far && (cost < second_cost);
    second_cost = better ? (far ? best_cost : second_cost)
                         : (new_second ? cost : second_cost);
    su = to_second ? bu : (new_second ? cu : su);
    sv = to_second ? bv : (new_second ? cv : sv);
    if (better) {
      best_sel = sel;
      best_cost = cost;
      bu = cu;
      bv = cv;
    }
  }

  __device__ __forceinline__ void write(int p, const float* __restrict__ fb,
                                        float ratio, float* __restrict__ best,
                                        float* __restrict__ second,
                                        unsigned char* __restrict__ amb) const {
    float ou = bu, ov = bv;
    if (fb != nullptr && !(best_cost < ratio * second_cost)) {
      ou = fb[2 * p];
      ov = fb[2 * p + 1];
    }
    reinterpret_cast<float2*>(best)[p] = make_float2(ou, ov);
    reinterpret_cast<float2*>(second)[p] = make_float2(su, sv);
    amb[p] = best_cost >= 0.9f * second_cost;
  }
};

// Rows and columns of a TH x TW tile's staged window of I2.
template <int TH, int TW, int kMode>
__host__ __device__ constexpr int window_rows(int radius) {
  return kMode != MODE_REFINE ? TH + 4 + 2 * radius
                              : TH + 5 + 2 * (radius + MARGIN);
}
template <int TH, int TW, int kMode>
__host__ __device__ constexpr int window_cols(int radius) {
  return kMode != MODE_REFINE ? TW + 4 + 2 * radius
                              : TW + 5 + 2 * (radius + MARGIN);
}

// Shared-memory floats of one block.
template <int TH, int TW, int kMode>
__host__ __device__ constexpr int smem_floats(int radius) {
  return (kMode == MODE_REFINE ? 2 * (TH + 4) * (TW + 4) : 0)  // the flow
         + (TH + 4) * (TW + 4)                    // I1 on the halo
         + window_rows<TH, TW, kMode>(radius)
               * window_cols<TH, TW, kMode>(radius)
         + (2 * radius + 1)
               * ((TH + 4) * (TW + 4) + TH * (TW + 4) + TH * TW);
}

// One block: the TH x TW tile at (blockIdx.y, blockIdx.x), every candidate
// row in order, scanned in registers.
template <int TH, int TW, int kMode>
__global__ void __launch_bounds__(THREADS)
match_kernel(const float* __restrict__ i1, const float* __restrict__ i2,
             const float* __restrict__ flow, const float* __restrict__ fb,
             const float* __restrict__ prior, float* __restrict__ best, float* __restrict__ second,
             unsigned char* __restrict__ amb, int h, int w, int radius,
             float ratio) {
  constexpr int HH = TH + 4, HW = TW + 4;
  constexpr int HALO = HH * HW;   // d2 on the tile and its halo
  constexpr int ROWS = TH * HW;   // row 5-sums
  constexpr int PIX = TH * TW;    // costs
  extern __shared__ float smem[];
  const int side = 2 * radius + 1;
  const float2* flow2 = reinterpret_cast<const float2*>(flow);
  constexpr bool kRefine = kMode == MODE_REFINE;
  float2* fls = reinterpret_cast<float2*>(smem);   // [HALO], refine only
  float* i1s = smem + (kRefine ? 2 * HALO : 0);    // [HALO]
  float* win_s = i1s + HALO;                       // the window of I2
  const int wh = window_rows<TH, TW, kMode>(radius);
  const int ww = window_cols<TH, TW, kMode>(radius);
  float* d2 = win_s + wh * ww;       // [side][HALO]
  float* rsum = d2 + side * HALO;    // [side][ROWS]
  float* cost = rsum + side * ROWS;  // [side][PIX]

  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;

  // Stage I1 and (refine) the flow on the halo cells, and the window of
  // I2: for the coarse and shifted searches every read lies in it; for the
  // refine it is centred on the tile's centre flow.
  for (int r = tid; r < HALO; r += THREADS) {
    const int hy = r / HW, hx = r - (r / HW) * HW;
    const int q = clampi(y0 - 2 + hy, h - 1) * w + clampi(x0 - 2 + hx, w - 1);
    i1s[r] = i1[q];
    if (kRefine) fls[r] = flow2[q];
  }
  Window win;
  win.y0 = y0 - 2 - radius;
  win.x0 = x0 - 2 - radius;
  if (kRefine) {
    const float2 c = flow2[min(y0 + TH / 2, h - 1) * w
                           + min(x0 + TW / 2, w - 1)];
    const float lim = (float)(h + w);
    win.y0 += (int)rintf(fminf(fmaxf(c.y, -lim), lim)) - MARGIN;
    win.x0 += (int)rintf(fminf(fmaxf(c.x, -lim), lim)) - MARGIN;
  }
  win.h = wh;
  win.w = ww;
  win.s = win_s;
  for (int i = tid; i < wh * ww; i += THREADS) {
    const int wy = i / ww, wx = i - (i / ww) * ww;
    win_s[i] = i2[clampi(win.y0 + wy, h - 1) * w
                  + clampi(win.x0 + wx, w - 1)];
  }

  const int ty = tid / TW, tx = tid - (tid / TW) * TW;
  const int y = y0 + ty, x = x0 + tx;
  const bool owner = tid < PIX && y < h && x < w;
  const int p = y * w + x;
  Scan s;
  s.init();
  __syncthreads();
  float2 base = make_float2(0.0f, 0.0f);
  if (kRefine && owner) base = fls[(ty + 2) * HW + tx + 2];
  if (kMode == MODE_SHIFTED && owner) base = flow2[p];
  const bool use_prior = prior != nullptr;
  float2 pr = make_float2(0.0f, 0.0f);
  if (use_prior && owner) pr = reinterpret_cast<const float2*>(prior)[p];
  const float s_r = (float)max(radius, 1);
  const float s2 = s_r * s_r;

  for (int row = 0; row < side; ++row) {
    const int dv = row - radius;
    for (int i = tid; i < side * HALO; i += THREADS) {
      const int g = i / HALO, r = i - (i / HALO) * HALO;
      const int hy = r / HW, hx = r - (r / HW) * HW;
      const float d = sample<!kRefine>(
          win, i2, h, w, clampi(y0 - 2 + hy, h - 1),
          clampi(x0 - 2 + hx, w - 1),
          kRefine ? fls[r] : make_float2(0.0f, 0.0f), g - radius, dv)
          - i1s[r];
      d2[i] = d * d;
    }
    __syncthreads();
    for (int i = tid; i < side * ROWS; i += THREADS) {
      const int g = i / ROWS, r = i - (i / ROWS) * ROWS;
      const float* c = d2 + g * HALO + r;  // column hx of halo rows ty..ty+4
      rsum[i] = c[4 * HW] + c[3 * HW] + c[2 * HW] + c[HW] + c[0];
    }
    __syncthreads();
    for (int i = tid; i < side * PIX; i += THREADS) {
      const int g = i / PIX, r = i - (i / PIX) * PIX;
      const int cy = r / TW, cx = r - (r / TW) * TW;
      const float* c = rsum + g * ROWS + cy * HW + cx;
      cost[i] = c[4] + c[3] + c[2] + c[1] + c[0];
    }
    __syncthreads();
    if (owner) {
      const float cv = kMode == MODE_COARSE ? (float)dv : base.y + (float)dv;
      for (int g = 0; g < side; ++g) {
        const float du = (float)(g - radius);
        const float cu = kMode == MODE_COARSE ? du : base.x + du;
        const float c = cost[g * PIX + tid];
        float sel = c;
        if (use_prior) {
          const float eu = cu - pr.x, ev = cv - pr.y;
          const float d2p = eu * eu + ev * ev;
          sel = c * (1.0f + (PRIOR_W * d2p) / (d2p + s2));
        }
        s.step(c, sel, cu, cv);
      }
    }
  }
  if (owner) s.write(p, fb, ratio, best, second, amb);
}

template <int TH, int TW, int kMode>
int launch_tile(const float* i1, const float* i2, const float* flow,
                const float* fb, const float* prior, float* best,
                float* second, unsigned char* amb, int h, int w, int radius,
                float ratio, cudaStream_t stream) {
  const size_t smem =
      (size_t)smem_floats<TH, TW, kMode>(radius) * sizeof(float);
  auto kernel = match_kernel<TH, TW, kMode>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 tiles((w + TW - 1) / TW, (h + TH - 1) / TH);
  kernel<<<tiles, THREADS, smem, stream>>>(i1, i2, flow, fb, prior, best,
                                           second, amb, h, w, radius, ratio);
  return (int)cudaGetLastError();
}

template <int kMode>
int launch_mode(int tile, const float* i1, const float* i2, const float* flow,
                const float* fb, const float* prior, float* best,
                float* second, unsigned char* amb, int h, int w, int radius,
                float ratio, cudaStream_t stream) {
  switch (tile) {
#define MATCH_TILE(t)                                                        \
  case t:                                                                    \
    return launch_tile<TILE_H[t], TILE_W[t], kMode>(                         \
        i1, i2, flow, fb, prior, best, second, amb, h, w, radius, ratio,     \
        stream);
    MATCH_TILE(0)
    MATCH_TILE(1)
    MATCH_TILE(2)
    MATCH_TILE(3)
#undef MATCH_TILE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// i1, i2: (h, w) f32 matching planes (shifted: i2 already warped by the
// flow); flow: (h, w, 2) f32, 8-byte aligned, or null for the coarse
// search; shifted: non-zero for the shifted search (flow not null); fb:
// (h, w, 2) f32 ratio fallback, 8-byte aligned, or null for none (then
// ratio is not read); prior: (h, w, 2) f32, 8-byte aligned, or null for
// none (the caller passes no fallback with a prior); best, second:
// (h, w, 2) f32 out; amb: (h, w) bytes out; tile: index into TILE_H /
// TILE_W.
extern "C" int match_launch(const float* i1, const float* i2,
                            const float* flow, int shifted, const float* fb,
                            const float* prior, float* best, float* second,
                            unsigned char* amb, int h, int w, int radius,
                            float ratio, int tile, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (radius < 0 || (shifted && flow == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (flow == nullptr)
    return launch_mode<MODE_COARSE>(tile, i1, i2, flow, fb, prior, best,
                                    second, amb, h, w, radius, ratio, s);
  if (shifted)
    return launch_mode<MODE_SHIFTED>(tile, i1, i2, flow, fb, prior, best,
                                     second, amb, h, w, radius, ratio, s);
  return launch_mode<MODE_REFINE>(tile, i1, i2, flow, fb, prior, best,
                                  second, amb, h, w, radius, ratio, s);
}

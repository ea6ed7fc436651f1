// RANSAC hypothesis scoring on Hopper (sm_90a).
//
// Replaces: rs_sfm_tpu/ops/pallas/score.py::score_hypotheses_pallas
//           (kernel _score_kernel), the TPU kernel that scores every
//           hypothesis (v, w, k) on every pixel.
//
// What it computes, per hypothesis and pixel (the packed layouts of the
// JAX kernel): beta = (alpha + k*alpha_k) * (2/(2+k)), the closed-form
// inverse depth rho = <g, r>/<g, g> with g = beta*A*v and r = u - beta*B*w,
// the residual e = u - beta*(A*v*rho + B*w), and the inlier test
// |e| < tol && valid.  Per hypothesis it reduces (inlier count, summed
// inlier |e|).
//
// What bounds it on this card: instruction issue.  Each pixel is read once
// (28 bytes) and then evaluated against all T hypotheses: at T = 256 that
// is far above the H100's float32 ridge point.  The file is built with
// -fmad=false (every pixel's residual bit-identical to the plain
// version's, below), so each multiply and add issues alone, at one
// instruction per lane per clock: half the FMA rate that the 67 TFLOP/s
// peak assumes.  The inner loop issues about 60 instructions a pair: 41
// multiplies and adds, 10 for the IEEE division (its fast path, check and
// skip branch), the rest the select, the test, the root, the count and
// the loads.
//
// What the design does about it:
// - Exact inlier test without a root.  The wrapper passes s* = the least
//   float32 s with sqrt_rn(s) >= tol (ops/kernels/score.py::sq_threshold).
//   sqrt_rn is monotone, so sqrt_rn(ex^2 + ey^2) < tol exactly when
//   ex^2 + ey^2 < s*.  The root is needed only for the inliers' error
//   sums: an approximate root (sqrt.approx.ftz.f32, one MUFU instruction,
//   relative error about 2^-23), predicated on the test with the count and
//   the add; the sums are held to rtol 1e-5.
// - Pixel invariants hoisted.  (-x)*y, 1 + x*x, -(1 + y*y) and x*y are the
//   first operations of the plain expression, computed once per pixel when
//   its tile is staged, in the same rounding.
// - Register tile of hypotheses against a shared pixel tile.  A block of
//   128 threads holds 256 hypotheses in registers, two a thread, and walks
//   a contiguous range of pixels in tiles of 256.  Each tile is staged in
//   shared memory once (coalesced row loads), compacted to its valid
//   pixels in order (a warp ballot and a prefix over the block's warps),
//   and read by every thread through broadcast loads: three 16-byte loads
//   a pixel for two pairs, and invalid pixels cost nothing.  Every thread
//   owns its hypotheses' counts and sums, so there is no per-hypothesis
//   reduction inside the block: each block writes one (count, sum) per
//   hypothesis to a (blocks, 2, T) partial buffer, which the wrapper sums.
// - Sums in a fixed order, no atomics: per thread a fresh sum per tile,
//   added to the block's running sum after the tile; the grid size is fixed
//   by the shapes and the device.  Repeated runs are bit-identical.
//
// Numerics: the residual is computed with -fmad=false and an IEEE '/', in
// the plain PyTorch version's operation order
// (ops/kernels/score.py::score_hypotheses_plain), so every pair's
// ex^2 + ey^2 is bit-identical to the plain version's on the card, and the
// inlier counts match it exactly.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int HPT = 2;                  // hypotheses per thread
constexpr int HYPS = THREADS * HPT;     // hypotheses per block (grid.y)
constexpr int TILE = 256;               // pixels staged at once
constexpr int STAGE = TILE / THREADS;   // pixels a thread stages

__device__ __forceinline__ float root_approx(float s) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(s));
  return r;
}

// Block (bx, by) scores hypotheses [by*HYPS, (by+1)*HYPS) on pixels
// [n*bx/gridDim.x, n*(bx+1)/gridDim.x).
__global__ void __launch_bounds__(THREADS)
score_kernel(const float* __restrict__ px, int64_t n, int64_t stride,
             const float* __restrict__ hyps, int t, float sstar,
             float* __restrict__ partial) {
  // Per valid pixel, three float4: (x, y, ux, uy), (alpha, alpha_k,
  // (-x)*y, 1 + x*x), (-(1 + y*y), x*y, -, -).
  __shared__ float4 tile[3 * TILE];
  __shared__ int s_valid[STAGE * WARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // This thread's hypotheses: vx vy vz wx wy wz k, and c2 = 2/(2+k).
  const int hbase = blockIdx.y * HYPS;
  float q[HPT][8];
#pragma unroll
  for (int j = 0; j < HPT; ++j) {
    const int h = hbase + j * THREADS + tid;
#pragma unroll
    for (int i = 0; i < 7; ++i) q[j][i] = h < t ? hyps[(int64_t)h * 8 + i] : 0.0f;
    q[j][7] = 2.0f / (2.0f + q[j][6]);
  }
  // A warp whose first hypothesis is past t has none.
  const bool live = hbase + warp * 32 < t;

  int cnt[HPT];
  float esum[HPT];
#pragma unroll
  for (int j = 0; j < HPT; ++j) {
    cnt[j] = 0;
    esum[j] = 0.0f;
  }

  const int64_t lo = n * blockIdx.x / gridDim.x;
  const int64_t hi = n * (blockIdx.x + 1) / gridDim.x;
  for (int64_t p0 = lo; p0 < hi; p0 += TILE) {
    // Stage the tile's valid pixels, in pixel order.
    float f[STAGE][6];
    bool ok[STAGE];
    int pos[STAGE];
#pragma unroll
    for (int r = 0; r < STAGE; ++r) {
      const int64_t p = p0 + r * THREADS + tid;
      ok[r] = p < hi && px[6 * stride + p] > 0.5f;
#pragma unroll
      for (int i = 0; i < 6; ++i) f[r][i] = ok[r] ? px[i * stride + p] : 0.0f;
      const unsigned m = __ballot_sync(0xffffffffu, ok[r]);
      pos[r] = __popc(m & ((1u << lane) - 1u));
      if (lane == 0) s_valid[r * WARPS + warp] = __popc(m);
    }
    __syncthreads();  // s_valid written; the previous tile consumed
    int total = 0;
#pragma unroll
    for (int i = 0; i < STAGE * WARPS; ++i) {
#pragma unroll
      for (int r = 0; r < STAGE; ++r)
        if (i == r * WARPS + warp) pos[r] += total;
      total += s_valid[i];
    }
#pragma unroll
    for (int r = 0; r < STAGE; ++r) {
      if (!ok[r]) continue;
      const float x = f[r][0], y = f[r][1];
      tile[3 * pos[r]] = make_float4(x, y, f[r][2], f[r][3]);
      tile[3 * pos[r] + 1] = make_float4(f[r][4], f[r][5], -x * y,
                                         1.0f + x * x);
      tile[3 * pos[r] + 2] = make_float4(-(1.0f + y * y), x * y, 0.0f, 0.0f);
    }
    __syncthreads();

    if (live) {
      float tsum[HPT];
#pragma unroll
      for (int j = 0; j < HPT; ++j) tsum[j] = 0.0f;
#pragma unroll 2
      for (int i = 0; i < total; ++i) {
        const float4 a = tile[3 * i];
        const float4 b = tile[3 * i + 1];
        const float4 c = tile[3 * i + 2];
#pragma unroll
        for (int j = 0; j < HPT; ++j) {
          const float* h = q[j];
          const float beta = (b.x + h[6] * b.y) * h[7];
          const float ax = h[0] - a.x * h[2];
          const float ay = h[1] - a.y * h[2];
          const float bx = b.z * h[3] + b.w * h[4] - a.y * h[5];
          const float by = c.x * h[3] + c.y * h[4] + a.x * h[5];
          const float gx = beta * ax;
          const float gy = beta * ay;
          const float rx = a.z - beta * bx;
          const float ry = a.w - beta * by;
          const float gg = gx * gx + gy * gy;
          const float gr = gx * rx + gy * ry;
          // The plain version's where(gg == 0, 0, gr / where(gg == 0, 1,
          // gg)): a select on each side of the division, no branch.
          const bool zero = gg == 0.0f;
          const float quot = gr / (zero ? 1.0f : gg);
          const float rho = zero ? 0.0f : quot;
          const float ex = a.z - beta * (ax * rho + bx);
          const float ey = a.w - beta * (ay * rho + by);
          const float s = ex * ex + ey * ey;
          if (s < sstar) {  // predicated: a count, a root and an add
            cnt[j] += 1;
            tsum[j] += root_approx(s);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < HPT; ++j) esum[j] += tsum[j];
    }
  }

  float* out = partial + (int64_t)blockIdx.x * 2 * t;
#pragma unroll
  for (int j = 0; j < HPT; ++j) {
    const int h = hbase + j * THREADS + tid;
    if (h < t) {
      out[h] = (float)cnt[j];
      out[t + h] = esum[j];
    }
  }
}

}  // namespace

// Pixel blocks of the grid for n pixels and t hypotheses on the current
// device: as many as fit on it at once with ceil(t / 256) hypothesis
// groups, and no more than there are pixel tiles; -1 on error.
extern "C" int score_blocks(long long n, int t) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, score_kernel,
                                                       THREADS, 0)
             != cudaSuccess)
    return -1;
  const long long groups = (t + HYPS - 1) / HYPS;
  const long long tiles = std::max(1LL, (n + TILE - 1) / TILE);
  const long long fit = std::max(1LL, (long long)sms * std::max(per_sm, 1)
                                          / std::max(groups, 1LL));
  return (int)std::min(tiles, fit);
}

// px: (8, stride) f32, first n columns used; hyps: (t, 8) f32; sstar: the
// squared tolerance of sq_threshold; partial: (blocks, 2, t) f32 with
// blocks from score_blocks(n, t).
extern "C" int score_launch(const float* px, long long n, long long stride,
                            const float* hyps, int t, float sstar,
                            float* partial, int blocks, void* stream) {
  const dim3 grid(blocks, (t + HYPS - 1) / HYPS);
  score_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      px, (int64_t)n, (int64_t)stride, hyps, t, sstar, partial);
  return (int)cudaGetLastError();
}

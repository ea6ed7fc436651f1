// RANSAC hypothesis scoring on Hopper (sm_90a).
//
// Replaces: rs_sfm_tpu/ops/pallas/score.py::score_hypotheses_pallas
//           (kernel _score_kernel), the TPU kernel that scores every
//           hypothesis (v, w, k) on every pixel.
//
// What it computes, per hypothesis and pixel (the packed layouts of the
// JAX kernel): beta = (alpha + k*alpha_k) * (2/(2+k)), the closed-form
// inverse depth rho = <g, r>/<g, g> with g = beta*A*v and r = u - beta*B*w,
// the residual norm err = |u - beta*(A*v*rho + B*w)|, and the inlier test
// err < tol && valid.  Per hypothesis it reduces (inlier count, summed
// inlier error).
//
// What bounds it on this card: arithmetic.  Each pixel is read once (28
// bytes) and then evaluated against all T hypotheses, ~45 float32 ops
// each: at T = 256 that is ~11.5k flops per pixel against 28 bytes, far
// above the H100's float32 ridge point, so the CUDA cores' float32 rate
// and the per-hypothesis reductions bound it, not HBM.
//
// What the design does about it: each thread keeps PPT pixels in
// registers and loops over the hypotheses, which sit in shared memory
// (HCHUNK x 8 floats at a time), so the only memory traffic per
// hypothesis is a broadcast shared-memory read.  Counts are reduced per
// warp with integer shuffles, then across the block's warps in a fixed
// order; each block writes its partials to a (blocks, 2, T) buffer that
// the wrapper sums (the JAX wrapper does the same outside its kernel).
// No atomics: the result is the same on every run.
//
// Numerics: this file is compiled with -fmad=false and uses IEEE '/' and
// sqrtf, in the same operation order as the plain PyTorch version
// (ops/kernels/score.py::score_hypotheses_plain), so every pixel's error is
// bit-identical to it on the card and the inlier counts match exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PPT = 4;        // pixels per thread
constexpr int HCHUNK = 256;   // hypotheses staged in shared memory at once
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
score_kernel(const float* __restrict__ px, int64_t n, int64_t stride,
             const float* __restrict__ hyps, int t, float tol,
             float* __restrict__ partial) {
  __shared__ float sh[HCHUNK * 8];
  __shared__ int s_cnt[WARPS][HCHUNK];
  __shared__ float s_err[WARPS][HCHUNK];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float x[PPT], y[PPT], ux[PPT], uy[PPT], al[PPT], ak[PPT];
  bool ok[PPT];
  const int64_t base = (int64_t)blockIdx.x * (THREADS * PPT);
#pragma unroll
  for (int r = 0; r < PPT; ++r) {
    const int64_t p = base + (int64_t)r * THREADS + tid;
    if (p < n) {
      x[r] = px[p];
      y[r] = px[stride + p];
      ux[r] = px[2 * stride + p];
      uy[r] = px[3 * stride + p];
      al[r] = px[4 * stride + p];
      ak[r] = px[5 * stride + p];
      ok[r] = px[6 * stride + p] > 0.5f;
    } else {
      x[r] = y[r] = ux[r] = uy[r] = al[r] = ak[r] = 0.0f;
      ok[r] = false;
    }
  }

  for (int h0 = 0; h0 < t; h0 += HCHUNK) {
    const int hc = min(HCHUNK, t - h0);
    __syncthreads();
    for (int i = tid; i < hc * 8; i += THREADS) sh[i] = hyps[(int64_t)h0 * 8 + i];
    __syncthreads();

    for (int h = 0; h < hc; ++h) {
      const float* hp = sh + h * 8;
      const float vx = hp[0], vy = hp[1], vz = hp[2];
      const float wx = hp[3], wy = hp[4], wz = hp[5], k = hp[6];
      const float c2 = 2.0f / (2.0f + k);
      int cnt = 0;
      float esum = 0.0f;
#pragma unroll
      for (int r = 0; r < PPT; ++r) {
        const float xr = x[r], yr = y[r];
        const float beta = (al[r] + k * ak[r]) * c2;
        const float ax = vx - xr * vz;
        const float ay = vy - yr * vz;
        const float bx = -xr * yr * wx + (1.0f + xr * xr) * wy - yr * wz;
        const float by = -(1.0f + yr * yr) * wx + xr * yr * wy + xr * wz;
        const float gx = beta * ax;
        const float gy = beta * ay;
        const float rx = ux[r] - beta * bx;
        const float ry = uy[r] - beta * by;
        const float gg = gx * gx + gy * gy;
        const float gr = gx * rx + gy * ry;
        const float rho = (gg == 0.0f) ? 0.0f : gr / gg;
        const float ex = ux[r] - beta * (ax * rho + bx);
        const float ey = uy[r] - beta * (ay * rho + by);
        const float err = sqrtf(ex * ex + ey * ey);
        if (err < tol && ok[r]) {
          cnt += 1;
          esum += err;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        cnt += __shfl_down_sync(0xffffffffu, cnt, off);
        esum += __shfl_down_sync(0xffffffffu, esum, off);
      }
      if (lane == 0) {
        s_cnt[warp][h] = cnt;
        s_err[warp][h] = esum;
      }
    }
    __syncthreads();
    for (int h = tid; h < hc; h += THREADS) {
      int c = 0;
      float e = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        c += s_cnt[w][h];
        e += s_err[w][h];
      }
      float* out = partial + (int64_t)blockIdx.x * 2 * t;
      out[h0 + h] = (float)c;
      out[t + h0 + h] = e;
    }
  }
}

}  // namespace

extern "C" int score_pixels_per_block() { return THREADS * PPT; }

// px: (8, stride) f32, first n columns used; hyps: (t, 8) f32;
// partial: (blocks, 2, t) f32 with blocks = ceil(n / score_pixels_per_block()).
extern "C" int score_launch(const float* px, long long n, long long stride,
                            const float* hyps, int t, float tol,
                            float* partial, int blocks, void* stream) {
  score_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      px, (int64_t)n, (int64_t)stride, hyps, t, tol, partial);
  return (int)cudaGetLastError();
}

// One fused Schur-LM iteration for J refinement starts on Hopper (sm_90a).
//
// Replaces: rs_sfm_tpu/ops/pallas/refine_kernels.py::lm_iter (kernel
//           _iter_kernel) and ::lm_iter_multi (kernel _iter_kernel_multi),
//           with their helpers _reduce_start, _decide_and_solve_start and
//           _solve_7x8_scalar.  lm_iter is the J = 1 call whose mask is
//           row 6 of the pixel record.
//
// What it computes (the "pipelined accept" iteration of the JAX module
// docstring): per start and pixel, the depth merge
// rho_eff = accept ? rho_cand : rho_prev, the VarPro step
// rho_new = rho_eff - g_rho/d, and the 71 reduction sums at
// (theta_cand, rho_new) -- triu sum J^T J, sum J^T r, the cost, triu
// sum c c^T/d and sum c g_rho/d, with Huber IRLS weights when
// loss_delta > 0; then, per start, accept/reject, the done-freeze, the
// lambda schedule (/3 on accept, *4 on reject), the Schur assembly and a
// damped 7x7 Gauss-Jordan solve with partial pivoting.  The state is the
// JAX module's 128-float layout, slot for slot.
//
// What bounds it on this card: HBM traffic and float32 arithmetic are
// both small -- per start and pixel it reads ~36 bytes and writes 8, and
// does ~250 flops -- so at full HD one sweep is about a hundred
// microseconds of work.  What bounds it is the reduction: 71 sums per start
// over two million pixels, which must stay in full float32 (the Gram sums
// stall LM in reduced precision, and the gradient and cost sums cancel near
// convergence).
//
// What the design does about it: two kernels.  The sweep kernel runs a
// grid of (pixel blocks x J); each thread keeps its 71 sums in registers
// over a short strided run of PPT pixels, then the block reduces them by
// warp shuffles and a fixed-order pass over its warps into a
// (blocks, J, 71) partial buffer.  The decide kernel (one block) reduces
// the partials over blocks in a fixed tree order -- each lane a strided
// run, then a butterfly across the warp -- with no float atomics, so
// repeated runs are bit-identical; then one thread per start makes the
// accept decision and solves the 7x7 system.  All products are CUDA-core
// FMAs in float32: no tensor cores, no TF32.
//
// The sharded path (rs_sfm_tpu/ops/pallas/refine_kernels.py::lm_sums_multi
// with lm_decide, driven by solver/refine_pallas.py::
// refine_pallas_multi_sharded) uses the same two halves as separate
// launches: lm_sums_launch runs the sweep and the same fixed-order reduction
// over blocks into a (J, 71) buffer in device memory, the caller all-reduces
// those sums across ranks, and lm_decide_launch runs the decide half on
// them.  Both halves are the device functions reduce_partials and
// decide_and_solve that the fused decide kernel calls, so at world size 1
// the split is bit-identical to lm_iter_launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PPT = 8;  // pixels per thread and start
constexpr int WARPS = THREADS / 32;
constexpr int NSUMS = 71;
constexpr int MAXJ = 32;

// State-vector slots (rs_sfm_tpu/ops/pallas/refine_kernels.py:46-60).
constexpr int S_THETA = 0;
constexpr int S_CAND = 7;
constexpr int S_LAM = 14;
constexpr int S_COST = 15;
constexpr int S_KKEEP = 16;
constexpr int S_ACCEPT = 17;
constexpr int S_DONE = 18;
constexpr int S_DELTA = 19;
constexpr int S_RELTOL = 26;
constexpr int S_ACTIVE = 27;
constexpr int S_COST0 = 28;
constexpr int S_SUMS = 32;

// Index of (r, c) in the 28-element row-major upper triangle of a 7x7.
__host__ __device__ constexpr int tri(int r, int c) {
  return r <= c ? r * 7 - r * (r - 1) / 2 + (c - r)
                : c * 7 - c * (c - 1) / 2 + (r - c);
}

__global__ void __launch_bounds__(THREADS)
lm_sweep_kernel(const float* __restrict__ state, const float* __restrict__ px,
                int64_t n, int64_t px_stride, const float* __restrict__ masks,
                int64_t mask_stride, const float* __restrict__ rho_prev,
                const float* __restrict__ rho_cand, int64_t rho_stride,
                float loss_delta, float* __restrict__ rho_eff_out,
                float* __restrict__ rho_new_out, float* __restrict__ partial) {
  __shared__ float red[WARPS][NSUMS];
  const int j = blockIdx.y;
  const int nj = gridDim.y;
  const float* st = state + (int64_t)j * 128;
  const float v0 = st[S_CAND + 0], v1 = st[S_CAND + 1], v2 = st[S_CAND + 2];
  const float w0 = st[S_CAND + 3], w1 = st[S_CAND + 4], w2 = st[S_CAND + 5];
  const float k = st[S_CAND + 6];
  const float k_keep = st[S_KKEEP];
  const bool accept = st[S_ACCEPT] > 0.5f;
  const float active = st[S_ACTIVE];
  const float c2 = 2.0f / (2.0f + k);
  const float dk2 = (2.0f + k) * (2.0f + k);

  const float* mrow = masks + (int64_t)j * mask_stride;
  const float* rp_row = rho_prev + (int64_t)j * rho_stride;
  const float* rc_row = rho_cand + (int64_t)j * rho_stride;
  float* re_row = rho_eff_out + (int64_t)j * rho_stride;
  float* rn_row = rho_new_out + (int64_t)j * rho_stride;

  float acc[NSUMS];
#pragma unroll
  for (int s = 0; s < NSUMS; ++s) acc[s] = 0.0f;

  const int64_t base = (int64_t)blockIdx.x * (THREADS * PPT);
  for (int r = 0; r < PPT; ++r) {
    const int64_t p = base + (int64_t)r * THREADS + threadIdx.x;
    if (p >= n) break;
    const float x = px[p];
    const float y = px[px_stride + p];
    const float ux = px[2 * px_stride + p];
    const float uy = px[3 * px_stride + p];
    const float alpha = px[4 * px_stride + p];
    const float alpha_k = px[5 * px_stride + p];
    const float m = mrow[p];
    const float rho_eff = accept ? rc_row[p] : rp_row[p];

    const float beta = (alpha + k * alpha_k) * c2;
    const float dbeta = 2.0f * (2.0f * alpha_k - alpha) / dk2;
    const float ax = v0 - x * v2;
    const float ay = v1 - y * v2;
    const float bx = -x * y * w0 + (1.0f + x * x) * w1 - y * w2;
    const float by = -(1.0f + y * y) * w0 + x * y * w1 + x * w2;
    const float jrx = -beta * ax;
    const float jry = -beta * ay;
    const float d = (jrx * jrx + jry * jry) * m;
    const bool informative = d > 0.0f;
    const float inv_d = informative ? 1.0f / d : 0.0f;

    // VarPro depth at theta_cand: one exact Newton step from rho_eff.
    const float rx0 = ux - beta * (ax * rho_eff + bx);
    const float ry0 = uy - beta * (ay * rho_eff + by);
    const float g_rho0 = (jrx * rx0 + jry * ry0) * m;
    const float delta_rho = informative ? -g_rho0 * inv_d : 0.0f;
    const float rho_new = rho_eff + delta_rho * m * active;
    re_row[p] = rho_eff;
    rn_row[p] = rho_new;

    // Reduction at (theta_cand, rho_new).
    const float ex = ax * rho_new + bx;
    const float ey = ay * rho_new + by;
    const float rx = ux - beta * ex;
    const float ry = uy - beta * ey;
    const float brho = beta * rho_new;
    const float jx[7] = {-brho, 0.0f, brho * x, beta * x * y,
                         -beta * (1.0f + x * x), beta * y,
                         -dbeta * ex * k_keep};
    const float jy[7] = {0.0f, -brho, brho * y, beta * (1.0f + y * y),
                         -beta * x * y, -beta * x, -dbeta * ey * k_keep};
    const float g_rho = (jrx * rx + jry * ry) * m;
    float c[7];
#pragma unroll
    for (int t = 0; t < 7; ++t) c[t] = (jx[t] * jrx + jy[t] * jry) * m;

    const float sq = rx * rx + ry * ry;
    float wl = 1.0f, swl = 1.0f, cost_px;
    if (loss_delta > 0.0f) {
      const float nrm = sqrtf(sq + 1e-24f);
      wl = fminf(1.0f, loss_delta / nrm);
      swl = sqrtf(wl);
      cost_px = (nrm <= loss_delta ? sq
                                   : 2.0f * loss_delta * nrm
                                         - loss_delta * loss_delta) * m;
    } else {
      cost_px = sq * m;
    }

    float a[7], b[7], ca[7], cb[7];
#pragma unroll
    for (int t = 0; t < 7; ++t) {
      a[t] = jx[t] * m * swl;
      b[t] = jy[t] * m * swl;
      ca[t] = c[t] * inv_d;
      cb[t] = c[t] * wl;
    }
    int q = 0;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
#pragma unroll
      for (int l = i; l < 7; ++l) {
        acc[q] += a[i] * a[l] + b[i] * b[l];
        acc[36 + q] += ca[i] * cb[l];
        ++q;
      }
    }
#pragma unroll
    for (int t = 0; t < 7; ++t) {
      acc[28 + t] += (jx[t] * rx + jy[t] * ry) * m * wl;
      acc[64 + t] += c[t] * wl * g_rho * inv_d;
    }
    acc[35] += cost_px;
  }

  // Block reduction: warp shuffles, then the warps in a fixed order.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < NSUMS; ++s) {
    float v = acc[s];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][s] = v;
  }
  __syncthreads();
  if (threadIdx.x < NSUMS) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += red[w][threadIdx.x];
    partial[((int64_t)blockIdx.x * nj + j) * NSUMS + threadIdx.x] = v;
  }
}

// Damped 7x7 solve, Gauss-Jordan with pairwise partial pivoting, exactly
// the elimination order of _solve_7x8_scalar.
__device__ void solve_7x8(float aug[7][8], float delta[7]) {
  for (int kk = 0; kk < 7; ++kk) {
    for (int r = kk + 1; r < 7; ++r) {
      if (fabsf(aug[r][kk]) > fabsf(aug[kk][kk])) {
        for (int c = kk; c < 8; ++c) {
          const float hi = aug[r][c];
          aug[r][c] = aug[kk][c];
          aug[kk][c] = hi;
        }
      }
    }
    const float piv = aug[kk][kk];
    const float inv = (piv == 0.0f) ? 0.0f : 1.0f / piv;
    for (int c = kk; c < 8; ++c) aug[kk][c] = aug[kk][c] * inv;
    for (int r = 0; r < 7; ++r) {
      if (r == kk) continue;
      const float f = aug[r][kk];
      for (int c = kk + 1; c < 8; ++c) aug[r][c] = aug[r][c] - f * aug[kk][c];
    }
  }
  for (int r = 0; r < 7; ++r) delta[r] = aug[r][7];
}

__device__ void decide_and_solve(const float* st, const float* sums_cand,
                                 float* out) {
  const float cost_prev = st[S_COST];
  const float rel_tol = st[S_RELTOL];
  const float cost_cand = sums_cand[35];
  const float k_keep = st[S_KKEEP];
  const float lam = st[S_LAM];
  // A start whose done flag is set is frozen: no accepts, lambda held.
  const bool was_done = st[S_DONE] > 0.5f;
  const bool acc_ok = (cost_cand < cost_prev) && (cost_cand == cost_cand)
                      && !was_done;
  const bool prev_finite = fabsf(cost_prev) < 3.0e38f;
  const bool conv = acc_ok && prev_finite
                    && (cost_prev - cost_cand <= rel_tol * cost_prev);
  const bool done = was_done || conv;

  float sums[NSUMS];
  for (int i = 0; i < NSUMS; ++i) sums[i] = acc_ok ? sums_cand[i] : st[S_SUMS + i];
  float theta[7];
  for (int t = 0; t < 7; ++t) theta[t] = acc_ok ? st[S_CAND + t] : st[S_THETA + t];
  const float cost = acc_ok ? cost_cand : cost_prev;
  const float lam_new = was_done ? lam
                        : (acc_ok ? fmaxf(lam / 3.0f, 1e-12f) : lam * 4.0f);

  const float s = 1.0f / (1.0f + lam_new);
  float aug[7][8];
  for (int r = 0; r < 7; ++r) {
    for (int c = 0; c < 7; ++c) {
      const int q = tri(r, c);
      aug[r][c] = sums[q] - sums[36 + q] * s;
    }
    aug[r][r] = aug[r][r] + lam_new * (sums[tri(r, r)] + 1e-12f);
    aug[r][7] = -(sums[28 + r] - sums[64 + r] * s);
  }
  aug[6][6] = aug[6][6] + (1.0f - k_keep);
  float delta[7];
  solve_7x8(aug, delta);

  for (int i = 0; i < 128; ++i) out[i] = 0.0f;
  for (int t = 0; t < 7; ++t) {
    out[S_THETA + t] = theta[t];
    out[S_CAND + t] = theta[t] + delta[t];
    out[S_DELTA + t] = delta[t];
  }
  out[S_LAM] = lam_new;
  out[S_COST] = cost;
  out[S_KKEEP] = k_keep;
  out[S_ACCEPT] = acc_ok ? 1.0f : 0.0f;
  out[S_DONE] = done ? 1.0f : 0.0f;
  out[S_RELTOL] = rel_tol;
  out[S_ACTIVE] = 1.0f;
  out[S_COST0] = prev_finite ? st[S_COST0] : cost_cand;
  for (int i = 0; i < NSUMS; ++i) out[S_SUMS + i] = sums[i];
}

// Fixed-order tree over the blocks' partials (nblk, nj, 71) into
// sums[j * 71 + s]: a strided run per lane, then a butterfly across the
// warp.  Run by one block of THREADS threads.
__device__ void reduce_partials(const float* __restrict__ partial, int nblk,
                                int nj, float* sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int idx = warp; idx < nj * NSUMS; idx += WARPS) {
    float v = 0.0f;
    for (int b = lane; b < nblk; b += 32)
      v += partial[(int64_t)b * nj * NSUMS + idx];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) sums[idx] = v;
  }
}

__global__ void __launch_bounds__(THREADS)
lm_decide_kernel(const float* __restrict__ state_in,
                 const float* __restrict__ partial, int nblk, int nj,
                 float* __restrict__ state_out) {
  __shared__ float sums_cand[MAXJ * NSUMS];
  reduce_partials(partial, nblk, nj, sums_cand);
  __syncthreads();
  if (threadIdx.x < nj) {
    const int j = threadIdx.x;
    decide_and_solve(state_in + (int64_t)j * 128, sums_cand + j * NSUMS,
                     state_out + (int64_t)j * 128);
  }
}

// The sharded path's halves: the reduction alone, into device memory ...
__global__ void __launch_bounds__(THREADS)
lm_reduce_kernel(const float* __restrict__ partial, int nblk, int nj,
                 float* __restrict__ sums) {
  reduce_partials(partial, nblk, nj, sums);
}

// ... and the decide step alone, on (J, 71) sums already reduced.
__global__ void lm_decide_sums_kernel(const float* __restrict__ state_in,
                                      const float* __restrict__ sums, int nj,
                                      float* __restrict__ state_out) {
  const int j = threadIdx.x;
  if (j < nj)
    decide_and_solve(state_in + (int64_t)j * 128, sums + j * NSUMS,
                     state_out + (int64_t)j * 128);
}

}  // namespace

extern "C" int lm_pixels_per_block() { return THREADS * PPT; }
extern "C" int lm_max_starts() { return MAXJ; }

// state_in/state_out: (J, 128); px: (8, px_stride), first n columns used;
// masks: start j's mask at masks + j*mask_stride; rho_*: (J, rho_stride);
// partial: (nblk, J, 71) scratch with nblk = ceil(n / lm_pixels_per_block()).
extern "C" int lm_iter_launch(const float* state_in, const float* px,
                              long long n, long long px_stride,
                              const float* masks, long long mask_stride,
                              const float* rho_prev, const float* rho_cand,
                              long long rho_stride, int nj, float loss_delta,
                              float* state_out, float* rho_eff,
                              float* rho_new, float* partial, int nblk,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  lm_sweep_kernel<<<dim3(nblk, nj), THREADS, 0, s>>>(
      state_in, px, (int64_t)n, (int64_t)px_stride, masks,
      (int64_t)mask_stride, rho_prev, rho_cand, (int64_t)rho_stride,
      loss_delta, rho_eff, rho_new, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lm_decide_kernel<<<1, THREADS, 0, s>>>(state_in, partial, nblk, nj,
                                         state_out);
  return (int)cudaGetLastError();
}

// The pixel-sweep half for J starts: the same sweep kernel, then the same
// fixed-order reduction over blocks, written to sums (J, 71).
extern "C" int lm_sums_launch(const float* state_in, const float* px,
                              long long n, long long px_stride,
                              const float* masks, long long mask_stride,
                              const float* rho_prev, const float* rho_cand,
                              long long rho_stride, int nj, float loss_delta,
                              float* rho_eff, float* rho_new, float* partial,
                              int nblk, float* sums, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  lm_sweep_kernel<<<dim3(nblk, nj), THREADS, 0, s>>>(
      state_in, px, (int64_t)n, (int64_t)px_stride, masks,
      (int64_t)mask_stride, rho_prev, rho_cand, (int64_t)rho_stride,
      loss_delta, rho_eff, rho_new, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lm_reduce_kernel<<<1, THREADS, 0, s>>>(partial, nblk, nj, sums);
  return (int)cudaGetLastError();
}

// The decide half: state_in (J, 128) and sums (J, 71) -> state_out (J, 128).
extern "C" int lm_decide_launch(const float* state_in, const float* sums,
                                int nj, float* state_out, void* stream) {
  lm_decide_sums_kernel<<<1, MAXJ, 0, (cudaStream_t)stream>>>(
      state_in, sums, nj, state_out);
  return (int)cudaGetLastError();
}

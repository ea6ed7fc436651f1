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
// both small -- per start and pixel it reads ~12 bytes and writes 8 beside
// the 24-byte pixel record shared by all starts, and does ~250 flops -- so
// at full HD one iteration is some tens of microseconds of work.  What
// costs beyond that is the reduction: 71 sums per start over two million
// pixels, which must stay in full float32 (the Gram sums stall LM in
// reduced precision, and the gradient and cost sums cancel near
// convergence).
//
// What the design does about it: a persistent sweep kernel of a few blocks
// per SM (as many as fit at once) strides over chunks of 1,024 pixels.  A
// block stages a chunk's pixel record in shared memory once and runs every
// start over it, so the record crosses HBM once for all J starts.  Per
// start, each thread sums its 4 pixels of the chunk into 71 registers;
// a reduce-scatter across the warp (5 butterfly stages, 71 shuffles a
// lane) leaves each lane with 2-3 finished warp sums, which it adds to the
// warp's running sums in shared memory.  After the last chunk the block
// adds its 8 warps' running sums in a fixed order into a [J][71][blocks]
// partial buffer, so the cross-block reduction reads contiguous addresses:
// a second kernel of one warp per (start, sum) row, spread over many
// blocks, sums each row by a strided run per lane and a butterfly.  In the
// fused iteration the last of those blocks to finish (an atomic ticket,
// reset by the sweep kernel of the same call) makes the accept decision
// and solves the 7x7 system for every start.  Every sum is added in an
// order fixed by the shapes and the device's SM count -- no float atomics
// -- so repeated runs are bit-identical, and no thread adds more than a
// few dozen terms in sequence.  All products are CUDA-core FMAs in
// float32: no tensor cores, no TF32.
//
// The sharded path (rs_sfm_tpu/ops/pallas/refine_kernels.py::lm_sums_multi
// with lm_decide, driven by solver/refine_pallas.py::
// refine_pallas_multi_sharded) uses the same halves as separate launches:
// lm_sums_launch runs the sweep and the same cross-block reduction into a
// (J, 71) buffer in device memory, the caller all-reduces those sums across
// ranks, and lm_decide_launch runs the decide half on them.  Both paths run
// the device functions sweep_body, reduce_rows and decide_and_solve, so at
// world size 1 the split is bit-identical to lm_iter_launch.  Each path has
// kernels of its own names (lm_iter_*, lm_iter_multi_*, lm_sums_*), so a
// profile tells B2, B3 and B7 apart.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PPT = 4;                  // pixels per thread and chunk
constexpr int CHUNK = THREADS * PPT;    // pixels a block stages at once
constexpr int NREC = 6;                 // x, y, ux, uy, alpha, alpha_k
constexpr int NSUMS = 71;
constexpr int NPAD = 72;                // NSUMS padded for the warp stages
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

// A chunk of the pixel record, then the warps' running sums.
__host__ __device__ constexpr size_t sweep_smem_bytes(int nj) {
  return sizeof(float) * ((size_t)NREC * CHUNK + (size_t)WARPS * nj * NPAD);
}

// One butterfly stage of the warp's reduce-scatter: the lanes whose `off`
// bit is set keep the upper half of a[0:N], the others the lower half,
// each adding its partner's copy of the half it keeps.
template <int N, int HALF>
__device__ __forceinline__ void scatter_stage(float* a, int off, bool upper) {
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float lo = a[i];
    const float hi = (i + HALF < N) ? a[i + HALF] : 0.0f;
    const float send = upper ? lo : hi;
    a[i] = (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

struct SweepArgs {
  const float* state;
  const float* px;
  int64_t n, px_stride;
  const float* masks;
  int64_t mask_stride;
  const float* rho_prev;
  const float* rho_cand;
  int64_t rho_stride;
  int nj;
  float loss_delta;
  float* rho_eff;
  float* rho_new;
  float* partial;  // [nj][NSUMS][gridDim.x]
  int* ticket;     // reset to 0 here for the reduction kernel, or null
};

__device__ __forceinline__ void sweep_body(const SweepArgs& g) {
  extern __shared__ float sh[];
  float* rec = sh;                   // [NREC][CHUNK]
  float* run = sh + NREC * CHUNK;    // [WARPS][nj][NPAD]
  const int nj = g.nj;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < WARPS * nj * NPAD; i += THREADS)
    run[i] = 0.0f;
  if (g.ticket != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    *g.ticket = 0;

  // This lane's slots after the reduce-scatter: the half it kept at each
  // stage (36, 18, 9, 5, 3 values), and whether slot i is padding.
  const bool b16 = lane & 16, b8 = lane & 8, b4 = lane & 4, b2 = lane & 2,
             b1 = lane & 1;
  int slot[3];
  bool real[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int p5 = i + (b1 ? 3 : 0);
    const int p4 = p5 + (b2 ? 5 : 0);
    slot[i] = p4 + (b4 ? 9 : 0) + (b8 ? 18 : 0) + (b16 ? 36 : 0);
    real[i] = p5 < 5 && p4 < 9 && slot[i] < NSUMS;
  }

  for (int64_t base = (int64_t)blockIdx.x * CHUNK; base < g.n;
       base += (int64_t)gridDim.x * CHUNK) {
    __syncthreads();  // the previous chunk's record is no longer read
#pragma unroll
    for (int f = 0; f < NREC; ++f) {
#pragma unroll
      for (int r = 0; r < PPT; ++r) {
        const int idx = r * THREADS + threadIdx.x;
        const int64_t p = base + idx;
        rec[f * CHUNK + idx] = p < g.n ? g.px[f * g.px_stride + p] : 0.0f;
      }
    }
    __syncthreads();

    for (int j = 0; j < nj; ++j) {
      const float* st = g.state + (int64_t)j * 128;
      const float v0 = st[S_CAND + 0], v1 = st[S_CAND + 1],
                  v2 = st[S_CAND + 2];
      const float w0 = st[S_CAND + 3], w1 = st[S_CAND + 4],
                  w2 = st[S_CAND + 5];
      const float k = st[S_CAND + 6];
      const float k_keep = st[S_KKEEP];
      const bool accept = st[S_ACCEPT] > 0.5f;
      const float active = st[S_ACTIVE];
      const float c2 = 2.0f / (2.0f + k);
      const float dk2 = (2.0f + k) * (2.0f + k);
      const float loss_delta = g.loss_delta;

      const float* mrow = g.masks + (int64_t)j * g.mask_stride;
      const float* rho_in = (accept ? g.rho_cand : g.rho_prev)
                            + (int64_t)j * g.rho_stride;
      float* re_row = g.rho_eff + (int64_t)j * g.rho_stride;
      float* rn_row = g.rho_new + (int64_t)j * g.rho_stride;

      float acc[NPAD];
#pragma unroll
      for (int s = 0; s < NPAD; ++s) acc[s] = 0.0f;

      for (int r = 0; r < PPT; ++r) {
        const int idx = r * THREADS + threadIdx.x;
        const int64_t p = base + idx;
        if (p >= g.n) break;
        const float x = rec[idx];
        const float y = rec[CHUNK + idx];
        const float ux = rec[2 * CHUNK + idx];
        const float uy = rec[3 * CHUNK + idx];
        const float alpha = rec[4 * CHUNK + idx];
        const float alpha_k = rec[5 * CHUNK + idx];
        const float m = mrow[p];
        const float rho_eff = rho_in[p];
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

      // Reduce-scatter over the warp's 32 lanes, then into the warp's
      // running sums (a fixed order: chunk after chunk).
      scatter_stage<72, 36>(acc, 16, b16);
      scatter_stage<36, 18>(acc, 8, b8);
      scatter_stage<18, 9>(acc, 4, b4);
      scatter_stage<9, 5>(acc, 2, b2);
      scatter_stage<5, 3>(acc, 1, b1);
      float* wrun = run + (warp * nj + j) * NPAD;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        if (real[i]) wrun[slot[i]] += acc[i];
    }
  }
  __syncthreads();

  // The block's sums, its warps in a fixed order, into [j][s][block].
  for (int i = threadIdx.x; i < nj * NSUMS; i += THREADS) {
    const int j = i / NSUMS, s = i % NSUMS;
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += run[(w * nj + j) * NPAD + s];
    g.partial[(int64_t)i * gridDim.x + blockIdx.x] = v;
  }
}

// The blocks' partials [rows][nblk] into sums[rows]: one warp per row,
// each lane a strided run over the blocks, then a butterfly across the
// warp; the rows are spread over every warp of the grid.
__device__ __forceinline__ void reduce_rows(const float* __restrict__ partial,
                                            int nblk, int rows,
                                            float* __restrict__ sums) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * WARPS;
  for (int row = blockIdx.x * WARPS + (threadIdx.x >> 5); row < rows;
       row += stride) {
    const float* pr = partial + (int64_t)row * nblk;
    float v = 0.0f;
    for (int b = lane; b < nblk; b += 32) v += pr[b];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) sums[row] = v;
  }
}

// The cross-block reduction; with a ticket, the last block to finish also
// runs the decide step for every start on the finished sums.
__device__ __forceinline__ void reduce_body(const float* __restrict__ partial,
                                            int nblk, int nj, float* sums,
                                            int* ticket,
                                            const float* __restrict__ state_in,
                                            float* __restrict__ state_out) {
  reduce_rows(partial, nblk, nj * NSUMS, sums);
  if (ticket == nullptr) return;
  __shared__ bool last;
  __shared__ float sums_s[MAXJ * NSUMS];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < nj * NSUMS; i += THREADS)
    sums_s[i] = __ldcg(sums + i);
  __syncthreads();
  if (threadIdx.x < nj) {
    const int j = threadIdx.x;
    decide_and_solve(state_in + (int64_t)j * 128, sums_s + j * NSUMS,
                     state_out + (int64_t)j * 128);
  }
}

// Kernels of one name per path, so that a profile tells them apart.
#define LM_KERNELS(prefix)                                                  \
  __global__ void __launch_bounds__(THREADS) prefix##_sweep(SweepArgs a) {  \
    sweep_body(a);                                                          \
  }                                                                         \
  __global__ void __launch_bounds__(THREADS) prefix##_reduce(               \
      const float* __restrict__ partial, int nblk, int nj, float* sums,     \
      int* ticket, const float* __restrict__ state_in,                      \
      float* __restrict__ state_out) {                                      \
    reduce_body(partial, nblk, nj, sums, ticket, state_in, state_out);      \
  }
LM_KERNELS(lm_iter)        // B2: lm_iter, J = 1 with the mask in px row 6
LM_KERNELS(lm_iter_multi)  // B3: lm_iter_multi
LM_KERNELS(lm_sums)        // B7: lm_sums_multi
#undef LM_KERNELS

// ... and the decide step alone, on (J, 71) sums already reduced.
__global__ void lm_decide_kernel(const float* __restrict__ state_in,
                                 const float* __restrict__ sums, int nj,
                                 float* __restrict__ state_out) {
  const int j = threadIdx.x;
  if (j < nj)
    decide_and_solve(state_in + (int64_t)j * 128, sums + j * NSUMS,
                     state_out + (int64_t)j * 128);
}

typedef void (*SweepKernel)(SweepArgs);
typedef void (*ReduceKernel)(const float*, int, int, float*, int*,
                             const float*, float*);

// Blocks of the persistent sweep grid: as many as fit on the device at
// once, and no more than there are chunks.  Every path takes the count of
// lm_iter_multi_sweep (the three kernels share one body), so the split
// and the fused iteration add their sums in the same order.  Also lets the
// three sweep kernels take sweep_smem_bytes(MAXJ) on the current device.
int sweep_blocks(long long n, int nj) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess)
    return -1;
  for (SweepKernel k : {lm_iter_sweep, lm_iter_multi_sweep, lm_sums_sweep})
    if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sweep_smem_bytes(MAXJ)) != cudaSuccess)
      return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, lm_iter_multi_sweep, THREADS, sweep_smem_bytes(nj))
      != cudaSuccess)
    return -1;
  const long long chunks = std::max(1LL, (n + CHUNK - 1) / CHUNK);
  return (int)std::min<long long>(chunks,
                                  (long long)sms * std::max(per_sm, 1));
}

// The sweep, then the cross-block reduction (ticket null: sums only).
int sweep_and_reduce(SweepKernel sweep, ReduceKernel reduce,
                     const SweepArgs& args, int nblk, float* sums,
                     const float* state_in, float* state_out,
                     cudaStream_t stream) {
  sweep<<<nblk, THREADS, sweep_smem_bytes(args.nj), stream>>>(args);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows = args.nj * NSUMS;
  reduce<<<(rows + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
      args.partial, nblk, args.nj, sums, args.ticket, state_in, state_out);
  return (int)cudaGetLastError();
}

SweepArgs make_args(const float* state, const float* px, long long n,
                    long long px_stride, const float* masks,
                    long long mask_stride, const float* rho_prev,
                    const float* rho_cand, long long rho_stride, int nj,
                    float loss_delta, float* rho_eff, float* rho_new,
                    float* partial, int* ticket) {
  SweepArgs a;
  a.state = state;
  a.px = px;
  a.n = n;
  a.px_stride = px_stride;
  a.masks = masks;
  a.mask_stride = mask_stride;
  a.rho_prev = rho_prev;
  a.rho_cand = rho_cand;
  a.rho_stride = rho_stride;
  a.nj = nj;
  a.loss_delta = loss_delta;
  a.rho_eff = rho_eff;
  a.rho_new = rho_new;
  a.partial = partial;
  a.ticket = ticket;
  return a;
}

}  // namespace

extern "C" int lm_max_starts() { return MAXJ; }

// Blocks of the sweep grid for n pixels and nj starts on the current
// device (the partial buffer holds nj * 71 * blocks floats); -1 on error.
// Call it on a device before the first launch there: it sets the sweep
// kernels' shared-memory limit.
extern "C" int lm_sweep_blocks(long long n, int nj) {
  return sweep_blocks(n, nj);
}

// One fused iteration.  state_in/state_out: (J, 128); px: (8, px_stride),
// first n columns used; masks: start j's mask at masks + j*mask_stride;
// rho_*: (J, rho_stride); partial: (J, 71, nblk) scratch with nblk =
// lm_sweep_blocks(n, J); sums: (J, 71) scratch; ticket: one int.
// route: 0 lm_iter (J = 1), 1 lm_iter_multi.
extern "C" int lm_iter_launch(int route, const float* state_in,
                              const float* px, long long n,
                              long long px_stride, const float* masks,
                              long long mask_stride, const float* rho_prev,
                              const float* rho_cand, long long rho_stride,
                              int nj, float loss_delta, float* state_out,
                              float* rho_eff, float* rho_new, float* partial,
                              int nblk, float* sums, int* ticket,
                              void* stream) {
  const SweepArgs args = make_args(state_in, px, n, px_stride, masks,
                                   mask_stride, rho_prev, rho_cand,
                                   rho_stride, nj, loss_delta, rho_eff,
                                   rho_new, partial, ticket);
  return route == 0
             ? sweep_and_reduce(lm_iter_sweep, lm_iter_reduce, args, nblk,
                                sums, state_in, state_out,
                                (cudaStream_t)stream)
             : sweep_and_reduce(lm_iter_multi_sweep, lm_iter_multi_reduce,
                                args, nblk, sums, state_in, state_out,
                                (cudaStream_t)stream);
}

// The pixel-sweep half for J starts: the same sweep, then the same
// cross-block reduction, written to sums (J, 71); nblk =
// lm_sweep_blocks(n, J).
extern "C" int lm_sums_launch(const float* state_in, const float* px,
                              long long n, long long px_stride,
                              const float* masks, long long mask_stride,
                              const float* rho_prev, const float* rho_cand,
                              long long rho_stride, int nj, float loss_delta,
                              float* rho_eff, float* rho_new, float* partial,
                              int nblk, float* sums, void* stream) {
  const SweepArgs args = make_args(state_in, px, n, px_stride, masks,
                                   mask_stride, rho_prev, rho_cand,
                                   rho_stride, nj, loss_delta, rho_eff,
                                   rho_new, partial, nullptr);
  return sweep_and_reduce(lm_sums_sweep, lm_sums_reduce, args, nblk, sums,
                          nullptr, nullptr, (cudaStream_t)stream);
}

// The decide half: state_in (J, 128) and sums (J, 71) -> state_out (J, 128).
extern "C" int lm_decide_launch(const float* state_in, const float* sums,
                                int nj, float* state_out, void* stream) {
  lm_decide_kernel<<<1, MAXJ, 0, (cudaStream_t)stream>>>(state_in, sums, nj,
                                                         state_out);
  return (int)cudaGetLastError();
}

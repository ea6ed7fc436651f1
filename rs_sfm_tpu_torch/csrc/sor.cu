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
// updated first.  Every pixel of one colour reads only pixels of the
// other, so one launch per colour updates (u, v) in place with exactly the
// semantics of the JAX package's sweep loop.
//
// What bounds it on this card: float32 operations.  A sweep does about 92
// operations per pixel (two square roots and two divisions among them)
// against 48 bytes that must move over a whole call (8 planes and (u, v)
// read, (u, v) written); at 20 sweeps that is about 1.9 k operations per
// 48 bytes, above the card's ridge point.  Re-reading the planes on every
// launch (40 bytes per updated pixel) is what this simple design adds.
//
// What the design does about it: one thread per pixel of the colour, the
// threads of a warp on every second pixel of one row; all arithmetic in
// registers; 2 * iters launches queued by one host call.  Fusing sweeps
// in shared memory (the TPU kernel's halo blocks) is later work.
//
// Numerics: compiled with -fmad=false, with IEEE sqrtf and '/', and in the
// operation order of the plain PyTorch version (ops/kernels/sor.py::
// sor_sweeps_plain), which writes wbr / s as (1 / s) * wbr because that is
// how PyTorch evaluates a number divided by a tensor.  The result is
// bit-identical to the plain version on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

struct SorParams {
  float omega, lam, eps2, wbr, wgrad;
};

__global__ void __launch_bounds__(THREADS)
sor_color_kernel(const float* __restrict__ coef, float* __restrict__ u,
                 float* __restrict__ v, int h, int w, int color,
                 SorParams prm) {
  const int y = blockIdx.y;
  const int x = 2 * (blockIdx.x * THREADS + threadIdx.x) + ((y + color) & 1);
  if (x >= w) return;
  const int64_t hw = (int64_t)h * w;
  const int64_t p = (int64_t)y * w + x;

  const float ix = coef[p];
  const float iy = coef[hw + p];
  const float c = coef[2 * hw + p];
  const float ixx = coef[3 * hw + p];
  const float ixy = coef[4 * hw + p];
  const float iyy = coef[5 * hw + p];
  const float cgx = coef[6 * hw + p];
  const float cgy = coef[7 * hw + p];
  const float uc = u[p];
  const float vc = v[p];

  const float lam = prm.lam;
  const float eps2 = prm.eps2;
  const float r = ix * uc + iy * vc + c;
  const float wd = (1.0f / sqrtf(r * r + eps2)) * prm.wbr;
  const float rgx = cgx + ixx * uc + ixy * vc;
  const float rgy = cgy + ixy * uc + iyy * vc;
  const float wg = (1.0f / sqrtf(rgx * rgx + rgy * rgy + eps2)) * prm.wgrad;

  // Neumann neighbours: up, down, left, right (dense.py's navg order).
  const int64_t pu = y > 0 ? p - w : p;
  const int64_t pd = y < h - 1 ? p + w : p;
  const int64_t pl = x > 0 ? p - 1 : p;
  const int64_t pr = x < w - 1 ? p + 1 : p;
  const float ubar = (u[pu] + u[pd] + u[pl] + u[pr]) * 0.25f;
  const float vbar = (v[pu] + v[pd] + v[pl] + v[pr]) * 0.25f;

  const float a11 = lam + wd * ix * ix + wg * (ixx * ixx + ixy * ixy);
  const float a12 = wd * ix * iy + wg * (ixx * ixy + ixy * iyy);
  const float a22 = lam + wd * iy * iy + wg * (ixy * ixy + iyy * iyy);
  const float b1 = lam * ubar - wd * ix * c - wg * (ixx * cgx + ixy * cgy);
  const float b2 = lam * vbar - wd * iy * c - wg * (ixy * cgx + iyy * cgy);
  float det = a11 * a22 - a12 * a12;
  det = fabsf(det) < 1e-12f ? 1e-12f : det;
  const float u_new = (a22 * b1 - a12 * b2) / det;
  const float v_new = (a11 * b2 - a12 * b1) / det;
  u[p] = uc + prm.omega * (u_new - uc);
  v[p] = vc + prm.omega * (v_new - vc);
}

}  // namespace

extern "C" int sor_threads_per_block() { return THREADS; }

// coef: (8, h, w) f32; u, v: (h, w) f32, updated in place by `iters`
// sweeps (2 * iters launches: colour 0, then colour 1, per sweep).
extern "C" int sor_launch(const float* coef, float* u, float* v, int h,
                          int w, int iters, float omega, float lam,
                          float eps2, float wbr, float wgrad, void* stream) {
  if (h <= 0 || w <= 0 || iters <= 0) return 0;
  const SorParams prm{omega, lam, eps2, wbr, wgrad};
  const int half = (w + 1) / 2;
  const dim3 grid((half + THREADS - 1) / THREADS, h);
  for (int s = 0; s < iters; ++s) {
    for (int color = 0; color < 2; ++color) {
      sor_color_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          coef, u, v, h, w, color, prm);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

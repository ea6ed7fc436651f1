// 3x3 edge-clamped median of image planes on Hopper (sm_90a).
//
// Replaces: rs_sfm_tpu/ops/pallas/median.py::median3_planes (kernel
//           _median_kernel), the TPU kernel that median-filters the two
//           flow planes after every warp of the variational solver.
//
// What it computes: for every plane p and pixel (y, x), the median of the
// nine values x[p, clamp(y+dy), clamp(x+dx)], dy, dx in {-1, 0, 1}, through
// the 19-comparator median network of rs_sfm_tpu/flow/dense.py::_median3
// (same comparator list, same input order).  Only min and max are used, so
// the result is bit-identical to the plain PyTorch version and to JAX.
//
// What bounds it on this card: bytes.  Each plane is read once and written
// once (8 bytes per pixel) for 38 min/max operations per pixel; the nine
// overlapping reads of a neighbourhood are served from L1.
//
// What the design does about it: one thread per output pixel, threads of a
// warp on consecutive pixels of a row (coalesced loads and stores), the nine
// values and the network in registers.  Edge clamping replaces the TPU
// kernel's masked rolls and row windows; any (P, H, W) is taken as it is.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void cas(float& a, float& b) {
  const float lo = fminf(a, b);
  const float hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

__global__ void __launch_bounds__(THREADS)
median3_kernel(const float* __restrict__ in, float* __restrict__ out, int h,
               int w, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int64_t hw = (int64_t)h * w;
  const int64_t p = i / hw;
  const int64_t q = i - p * hw;
  const int y = (int)(q / w);
  const int x = (int)(q - (int64_t)y * w);
  const float* pl = in + p * hw;

  // dense.py::_median3's input order: _shift2(x, dy, dx) for dy, dx in
  // (-1, 0, 1) reads x[y - dy, x - dx] (edge-clamped).
  float v[9];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int yy = min(max(y + 1 - a, 0), h - 1);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int xx = min(max(x + 1 - b, 0), w - 1);
      v[3 * a + b] = pl[(int64_t)yy * w + xx];
    }
  }
  cas(v[0], v[1]); cas(v[3], v[4]); cas(v[6], v[7]);
  cas(v[1], v[2]); cas(v[4], v[5]); cas(v[7], v[8]);
  cas(v[0], v[1]); cas(v[3], v[4]); cas(v[6], v[7]);
  cas(v[0], v[3]); cas(v[5], v[8]); cas(v[4], v[7]);
  cas(v[3], v[6]); cas(v[1], v[4]); cas(v[2], v[5]);
  cas(v[4], v[7]); cas(v[4], v[2]); cas(v[6], v[4]);
  cas(v[4], v[2]);
  out[i] = v[4];
}

}  // namespace

// in, out: (planes, h, w) f32, contiguous, distinct buffers.
extern "C" int median3_launch(const float* in, float* out, int planes, int h,
                              int w, void* stream) {
  const int64_t total = (int64_t)planes * h * w;
  if (total == 0) return 0;
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  median3_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      in, out, h, w, total);
  return (int)cudaGetLastError();
}

// Exact z-buffered splat of the rectification on Hopper (sm_90a).
//
// Replaces: rs_sfm_tpu/ops/pallas/zbuffer.py::zbuffer_splat (kernel
//           _kernel), the experimental engine of
//           rs_sfm_tpu/rectify/backproject.py (method="pallas").
//
// What it computes: every source pixel s with finite target coordinates
// (tx, ty) and a finite depth d splats to the target pixel
// (floor(tx + 0.5), floor(ty + 0.5)) when that lies in the image; each
// target keeps the splat of minimum depth, ties to the lowest source id,
// and takes that source's colour.  This is backproject(method="scatter")
// exactly (its two scatter-min passes), not the TPU kernel's target-side
// window search, which misses the sources that stray from their target
// block's displacement consensus (about 5 % of splats at full HD).
//
// What bounds it on this card: memory traffic.  Per source pixel it reads
// 24 bytes (tx, ty, depth, colour) and per target it writes 13 (colour,
// hit flag), plus one 8-byte atomic and one 8-byte read of the key buffer;
// the arithmetic is a few operations.  The atomics land on scattered
// addresses of a 16 MB buffer at full HD, which the 50 MB L2 holds.
//
// What the design does about it: one pass of one thread per source pixel
// does a 64-bit atomicMin of (order-preserving depth bits << 32 | source
// id) into an (H*W) uint64 key buffer, so the minimum depth and the lowest
// id among equal depths fall out of one integer min with no second
// scatter.  The float's bits are mapped so that unsigned order is float
// order: a negative value has all its bits flipped, a non-negative one its
// sign bit set; -0.0 is first made +0.0, because the scatter engine's ==
// treats the two as equal.  A second pass of one thread per target pixel
// reads its key, gathers the winner's colour and writes the hit flag.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned long long EMPTY = 0xFFFFFFFFFFFFFFFFull;

__device__ __forceinline__ unsigned int ordered_bits(float d) {
  if (d == 0.0f) d = 0.0f;  // -0.0 -> +0.0
  const unsigned int b = __float_as_uint(d);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__global__ void __launch_bounds__(THREADS)
splat_kernel(const float* __restrict__ tx, const float* __restrict__ ty,
             const float* __restrict__ depth, int h, int w,
             unsigned long long* __restrict__ keys) {
  const int64_t n = (int64_t)h * w;
  const int64_t s = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (s >= n) return;
  const float x = tx[s];
  const float y = ty[s];
  const float d = depth[s];
  if (!(isfinite(x) && isfinite(y) && isfinite(d))) return;
  // Rounding as in the reference: int(x + 0.5) (src/rsframe.cc:831).
  const float fx = floorf(x + 0.5f);
  const float fy = floorf(y + 0.5f);
  if (!(fx >= 0.0f && fx < (float)w && fy >= 0.0f && fy < (float)h)) return;
  const int64_t t = (int64_t)fy * w + (int64_t)fx;
  const unsigned long long key =
      ((unsigned long long)ordered_bits(d) << 32) | (unsigned long long)s;
  atomicMin(keys + t, key);
}

__global__ void __launch_bounds__(THREADS)
resolve_kernel(const unsigned long long* __restrict__ keys,
               const float* __restrict__ colors, int64_t n,
               float* __restrict__ gs, uint8_t* __restrict__ scattered) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n) return;
  const unsigned long long key = keys[t];
  const bool hit = key != EMPTY;
  const int64_t src = (int64_t)(key & 0xFFFFFFFFull);
  float r = 0.0f, g = 0.0f, b = 0.0f;
  if (hit) {
    r = colors[3 * src];
    g = colors[3 * src + 1];
    b = colors[3 * src + 2];
  }
  gs[3 * t] = r;
  gs[3 * t + 1] = g;
  gs[3 * t + 2] = b;
  scattered[t] = hit ? 1 : 0;
}

}  // namespace

// tx, ty, depth: (h, w) float32 per source pixel; colors: (h, w, 3)
// float32; keys: (h*w) uint64 scratch; gs: (h, w, 3) float32 out;
// scattered: (h, w) bool (one byte each) out.  h*w < 2^32.
extern "C" int zbuffer_splat_launch(const float* tx, const float* ty,
                                    const float* depth, const float* colors,
                                    int h, int w, void* keys, float* gs,
                                    void* scattered, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n = (int64_t)h * w;
  if (n <= 0) return 0;
  unsigned long long* k = (unsigned long long*)keys;
  cudaError_t err =
      cudaMemsetAsync(k, 0xFF, n * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  const unsigned int blocks = (unsigned int)((n + THREADS - 1) / THREADS);
  splat_kernel<<<blocks, THREADS, 0, s>>>(tx, ty, depth, h, w, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  resolve_kernel<<<blocks, THREADS, 0, s>>>(k, colors, n, gs,
                                            (uint8_t*)scattered);
  return (int)cudaGetLastError();
}

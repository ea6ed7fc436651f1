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
// What bounds it on this card: memory traffic.  Per source pixel it must
// read 12 bytes (tx, ty, depth), per target write 13 (colour, hit flag),
// and per hit target read its winner's 12-byte colour: 25 bytes a pixel
// and 12 a hit target, about 0.02 ms at full HD and 3.35 TB/s.  On top of
// that each live source does one 8-byte atomic and each target reads its
// 8-byte key, on a (H*W) key buffer (16.6 MB at full HD) that the 50 MB
// L2 holds.
//
// What the design does about it:
//   * One 64-bit unsigned min of (order-preserving depth bits << 32 |
//     source id) a live source, so the minimum depth and the lowest id
//     among equal depths fall out of one integer min with no second
//     scatter.  The float's bits are mapped so that unsigned order is
//     float order: a negative value has all its bits flipped, a
//     non-negative one its sign bit set; -0.0 is first made +0.0, because
//     the scatter engine's == treats the two as equal.  The atomic's
//     result is unused, so it compiles to a reduction (RED.E.MIN.64),
//     which the SM does not wait on.
//   * No memset: the key buffer belongs to the wrapper, one per device,
//     is filled with EMPTY once when it is allocated, and the resolve
//     writes EMPTY back into every key it found set.  A call is two
//     kernels.
//   * One source a thread, one target a thread, so that every warp
//     instruction touches consecutive addresses: sources land near their
//     own pixel, so the atomics of 32 consecutive sources hit about 32
//     consecutive keys.  (Two or four sources a thread, adjacent or 256
//     apart, and 16-byte loads through a shared-memory transpose were each
//     slower on an H100; PERF.md §6.)
//   * Cache priorities that keep the keys in L2 from the splat to the
//     resolve and from one call to the next: the inputs, the colour
//     gather and the image are read and written evict-first (streaming),
//     the keys normally.  The colour gather alone, at normal priority,
//     pushed enough keys out to cost the next splat a quarter of its time.
//   * The resolve stages its block's colours and hit flags in shared
//     memory and writes them as 16-byte colour vectors and 4-byte words of
//     hit flags.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // sources or targets a block
constexpr unsigned long long EMPTY = 0xFFFFFFFFFFFFFFFFull;

__device__ __forceinline__ unsigned int ordered_bits(float d) {
  if (d == 0.0f) d = 0.0f;  // -0.0 -> +0.0
  const unsigned int b = __float_as_uint(d);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ void splat_one(float x, float y, float d, int h,
                                          int w, unsigned int s,
                                          unsigned long long* keys) {
  if (!(isfinite(x) && isfinite(y) && isfinite(d))) return;
  // Rounding as in the reference: int(x + 0.5) (src/rsframe.cc:831).
  const float fx = floorf(x + 0.5f);
  const float fy = floorf(y + 0.5f);
  if (!(fx >= 0.0f && fx < (float)w && fy >= 0.0f && fy < (float)h)) return;
  const int64_t t = (int64_t)fy * w + (int64_t)fx;
  atomicMin(keys + t,
            ((unsigned long long)ordered_bits(d) << 32) | (unsigned long long)s);
}

// Block (blockIdx.x, row blockIdx.y) splats column blockIdx.x * THREADS
// + threadIdx.x of its row; sx, sy, sd are the row strides (elements) of
// tx, ty and depth.
__global__ void __launch_bounds__(THREADS)
splat_kernel(const float* __restrict__ tx, const float* __restrict__ ty,
             const float* __restrict__ depth, int64_t sx, int64_t sy,
             int64_t sd, int h, int w, unsigned long long* __restrict__ keys) {
  const int row = blockIdx.y;
  const int c = blockIdx.x * THREADS + threadIdx.x;
  // All three loads before any test (a column past the row's end reads
  // NaN and drops out): written with an early return, or with the loads
  // inside splat_one's finiteness test, the splat took 20 % longer on an
  // H100 (PERF.md §6).
  const bool in_row = c < w;
  const float x = in_row ? __ldcs(tx + row * sx + c) : NAN;
  const float y = in_row ? __ldcs(ty + row * sy + c) : NAN;
  const float d = in_row ? __ldcs(depth + row * sd + c) : NAN;
  splat_one(x, y, d, h, w, (unsigned int)row * (unsigned int)w + c, keys);
}

// Block b resolves targets b * THREADS + threadIdx.x (of n): reads their
// keys, puts EMPTY back into those that were set, gathers the winners'
// colours into shared memory, then writes the block's colours and hit
// flags out as 16-byte and 4-byte words.  sc is the colours' row stride
// (elements), 3 * w when they are contiguous.
__global__ void __launch_bounds__(THREADS)
resolve_kernel(unsigned long long* __restrict__ keys,
               const float* __restrict__ colors, int64_t sc, int w, int64_t n,
               float* __restrict__ gs, uint8_t* __restrict__ scattered) {
  __shared__ __align__(16) float tile_rgb[3 * THREADS];
  __shared__ __align__(4) uint8_t tile_hit[THREADS];
  const int64_t base = (int64_t)blockIdx.x * THREADS;
  const int count = n - base < THREADS ? (int)(n - base) : THREADS;
  const int j = threadIdx.x;
  const unsigned long long key = j < count ? keys[base + j] : EMPTY;
  float r = 0.0f, g = 0.0f, b = 0.0f;
  if (key != EMPTY) {
    keys[base + j] = EMPTY;
    const unsigned int s = (unsigned int)(key & 0xFFFFFFFFull);
    const float* c;
    if (sc == 3 * (int64_t)w) {
      c = colors + 3 * (int64_t)s;
    } else {
      const unsigned int row = s / (unsigned int)w;
      c = colors + row * sc + 3 * (int64_t)(s - row * (unsigned int)w);
    }
    r = __ldcs(c);
    g = __ldcs(c + 1);
    b = __ldcs(c + 2);
  }
  tile_rgb[3 * j] = r;
  tile_rgb[3 * j + 1] = g;
  tile_rgb[3 * j + 2] = b;
  tile_hit[j] = key != EMPTY ? 1 : 0;
  __syncthreads();
  float* out = gs + 3 * base;
  if (count == THREADS) {
    // 3 * THREADS / 4 float4 and THREADS / 4 words, 16- and 4-byte
    // aligned (base is a multiple of THREADS, and gs and scattered are
    // aligned).
    if (j < 3 * THREADS / 4)
      __stcs(reinterpret_cast<float4*>(out) + j,
             reinterpret_cast<const float4*>(tile_rgb)[j]);
    if (j < THREADS / 4)
      reinterpret_cast<unsigned int*>(scattered + base)[j] =
          reinterpret_cast<const unsigned int*>(tile_hit)[j];
  } else {
    for (int q = j; q < 3 * count; q += THREADS) out[q] = tile_rgb[q];
    if (j < count) scattered[base + j] = tile_hit[j];
  }
}

}  // namespace

// tx, ty, depth: (h, w) float32 per source pixel, rows sx, sy, sd elements
// apart (columns contiguous); colors: (h, w, 3) float32, rows sc elements
// apart; keys: (h*w) uint64, EMPTY in every entry on entry and on return
// (stream order); gs: (h, w, 3) float32 out, contiguous and 16-byte
// aligned; scattered: (h, w) bool (one byte each) out, contiguous and
// 4-byte aligned.  h*w < 2^32, h < 65536.
extern "C" int zbuffer_splat_launch(const float* tx, const float* ty,
                                    const float* depth, const float* colors,
                                    int h, int w, long long sx, long long sy,
                                    long long sd, long long sc, void* keys,
                                    float* gs, void* scattered,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n = (int64_t)h * w;
  if (n <= 0) return 0;
  unsigned long long* k = (unsigned long long*)keys;
  const dim3 splat_grid((unsigned int)((w + THREADS - 1) / THREADS),
                        (unsigned int)h);
  splat_kernel<<<splat_grid, THREADS, 0, s>>>(tx, ty, depth, sx, sy, sd, h, w,
                                               k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  resolve_kernel<<<(unsigned int)((n + THREADS - 1) / THREADS), THREADS, 0,
                   s>>>(k, colors, sc, w, n, gs, (uint8_t*)scattered);
  return (int)cudaGetLastError();
}

// Bilinear warp of image planes by dense flow fields on Hopper (sm_90a).
//
// Replaces: rs_sfm_tpu/ops/pallas/warp.py::bilinear_warp (kernel _kernel),
//           the TPU kernel that samples an image plane at x + flow(x).
//           That kernel avoids the TPU's slow gather with a per-block
//           window around the block's mean displacement, and clamps
//           samples whose residual displacement leaves the window.  This
//           one gathers the four corners directly, so it is exact
//           everywhere: it computes rs_sfm_tpu/flow/dense.py::_warp.
//
// What it computes, per output pixel (b, y, x), with plane b of the image
// (or plane 0 when one plane serves all flows) and flow b (or flow 0):
//   xs = clip(x + flow_x, 0, W-1), ys = clip(y + flow_y, 0, H-1),
//   x0 = floor(xs), x1 = min(x0+1, W-1), fx = xs - x0 (same for y),
//   out = (1-fy)((1-fx) v00 + fx v01) + fy((1-fx) v10 + fx v11).
//
// What bounds it on this card: bytes.  Per output pixel it reads 8 bytes
// of flow and writes 4, and does about 20 float operations; the image is
// read once per plane and then served from L1/L2 (a smooth flow field
// makes neighbouring threads read neighbouring corners).
//
// What the design does about it: a block covers a tile of TILE_ROWS rows
// by COLS_THREADS * PPT columns of one plane (grid: column tiles x row
// tiles x planes), so no thread divides to find its pixel.  Each thread
// loads the flow of its PPT pixels (one 8-byte load each, a half-warp's
// loads on consecutive pixels) before it gathers any corner, so 4 * PPT
// independent gathers are in flight a thread.  A 2-D tile keeps the rows
// its corners come from in one SM's L1: with one row a block, every image
// row went to about three SMs through L2 (1080x1920 by the e2e flow on an
// H100: about 0.022 ms with a row a block, 0.016 ms with 16 x 64 tiles).
// No shared memory.
//
// Numerics: compiled with -fmad=false, in the operation order of the plain
// PyTorch version (ops/kernels/warp.py::warp_plain), so the result is
// bit-identical to it on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE_ROWS = 16;
constexpr int COLS_THREADS = 16;
constexpr int PPT = 4;  // pixels a thread, COLS_THREADS apart

__global__ void __launch_bounds__(TILE_ROWS * COLS_THREADS)
warp_kernel(const float* __restrict__ img, int64_t img_stride,
            const float* __restrict__ flow, int64_t flow_stride,
            float* __restrict__ out, int h, int w) {
  const int y = blockIdx.y * TILE_ROWS + threadIdx.y;
  if (y >= h) return;
  const int b = blockIdx.z;
  const float* im = img + b * img_stride;
  const float2* fl = reinterpret_cast<const float2*>(flow + b * flow_stride)
                     + (int64_t)y * w;
  float* o = out + ((int64_t)b * h + y) * w;
  const int x0 = blockIdx.x * COLS_THREADS * PPT + threadIdx.x;
  const float yf = (float)y;

  float2 f[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int x = x0 + j * COLS_THREADS;
    f[j] = x < w ? fl[x] : make_float2(0.0f, 0.0f);
  }
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int x = x0 + j * COLS_THREADS;
    if (x >= w) break;
    const float xs = fminf(fmaxf((float)x + f[j].x, 0.0f), (float)(w - 1));
    const float ys = fminf(fmaxf(yf + f[j].y, 0.0f), (float)(h - 1));
    const int xa = (int)floorf(xs);
    const int ya = (int)floorf(ys);
    const int xb = min(xa + 1, w - 1);
    const int yb = min(ya + 1, h - 1);
    const float fx = xs - (float)xa;
    const float fy = ys - (float)ya;
    const float v00 = im[(int64_t)ya * w + xa];
    const float v01 = im[(int64_t)ya * w + xb];
    const float v10 = im[(int64_t)yb * w + xa];
    const float v11 = im[(int64_t)yb * w + xb];
    o[x] = (1.0f - fy) * ((1.0f - fx) * v00 + fx * v01)
           + fy * ((1.0f - fx) * v10 + fx * v11);
  }
}

}  // namespace

// img: planes of (h, w) f32, plane b at img + b * img_stride (stride 0: one
// plane for every flow); flow: (h, w, 2) f32 fields, 8-byte aligned, field
// b at flow + b * flow_stride (stride 0: one field for every plane);
// out: (batch, h, w) f32.  batch at most 65535.
extern "C" int warp_launch(const float* img, long long img_stride,
                           const float* flow, long long flow_stride,
                           float* out, int batch, int h, int w,
                           void* stream) {
  if ((int64_t)batch * h * w == 0) return 0;
  const dim3 block(COLS_THREADS, TILE_ROWS);
  const dim3 grid((w + COLS_THREADS * PPT - 1) / (COLS_THREADS * PPT),
                  (h + TILE_ROWS - 1) / TILE_ROWS, batch);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  warp_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      img, (int64_t)img_stride, flow, (int64_t)flow_stride, out, h, w);
  return (int)cudaGetLastError();
}

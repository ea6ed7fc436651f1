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
// What the design does about it: one thread per output pixel, threads of
// a warp on consecutive pixels of a row, so the flow reads and the output
// writes are coalesced; no shared memory, nothing beyond the gather.  The
// discrete refine's candidate flows go through one launch as a batch of K
// flows over one image plane.
//
// Numerics: compiled with -fmad=false, in the operation order of the plain
// PyTorch version (ops/kernels/warp.py::warp_plain), so the result is
// bit-identical to it on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
warp_kernel(const float* __restrict__ img, int64_t img_stride,
            const float* __restrict__ flow, int64_t flow_stride,
            float* __restrict__ out, int h, int w, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int64_t hw = (int64_t)h * w;
  const int64_t b = i / hw;
  const int64_t p = i - b * hw;
  const int y = (int)(p / w);
  const int x = (int)(p - (int64_t)y * w);
  const float* fl = flow + b * flow_stride + 2 * p;
  const float* im = img + b * img_stride;

  const float xs = fminf(fmaxf((float)x + fl[0], 0.0f), (float)(w - 1));
  const float ys = fminf(fmaxf((float)y + fl[1], 0.0f), (float)(h - 1));
  const int x0 = (int)floorf(xs);
  const int y0 = (int)floorf(ys);
  const int x1 = min(x0 + 1, w - 1);
  const int y1 = min(y0 + 1, h - 1);
  const float fx = xs - (float)x0;
  const float fy = ys - (float)y0;
  const float v00 = im[(int64_t)y0 * w + x0];
  const float v01 = im[(int64_t)y0 * w + x1];
  const float v10 = im[(int64_t)y1 * w + x0];
  const float v11 = im[(int64_t)y1 * w + x1];
  out[i] = (1.0f - fy) * ((1.0f - fx) * v00 + fx * v01)
           + fy * ((1.0f - fx) * v10 + fx * v11);
}

}  // namespace

// img: planes of (h, w) f32, plane b at img + b * img_stride (stride 0: one
// plane for every flow); flow: (h, w, 2) f32 fields, field b at
// flow + b * flow_stride (stride 0: one field for every plane);
// out: (batch, h, w) f32.
extern "C" int warp_launch(const float* img, long long img_stride,
                           const float* flow, long long flow_stride,
                           float* out, int batch, int h, int w,
                           void* stream) {
  const int64_t total = (int64_t)batch * h * w;
  if (total == 0) return 0;
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  warp_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      img, (int64_t)img_stride, flow, (int64_t)flow_stride, out, h, w, total);
  return (int)cudaGetLastError();
}

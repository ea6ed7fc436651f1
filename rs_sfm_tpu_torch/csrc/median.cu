// 3x3 edge-clamped median of image planes on Hopper (sm_90a).
//
// Replaces: rs_sfm_tpu/ops/pallas/median.py::median3_planes (kernel
//           _median_kernel), the TPU kernel that median-filters the two
//           flow planes after every warp of the variational solver.
//
// What it computes: for every plane p and pixel (y, x), the median of the
// nine values x[p, clamp(y+dy), clamp(x+dx)], dy, dx in {-1, 0, 1}, through
// the 19-comparator median network of rs_sfm_tpu/flow/dense.py::_median3
// (same comparator list, same input order).  Only fminf and fmaxf are used,
// so the result is bit-identical to the plain PyTorch version and to JAX.
//
// What bounds it on this card: bytes.  Each plane is read once and written
// once (8 bytes per pixel and plane) for 38 min/max operations.
//
// What the design does about it:
// - A 2-D grid of 32x32 output tiles, both planes of a pair in one block
//   (planes beyond two in the grid's third dimension).  Tile coordinates
//   come from blockIdx, so no thread divides a 64-bit index.
// - Each block stages its tile with a one-pixel halo, edge-clamped, in
//   shared memory, a row per warp at a time (coalesced, and no index
//   divided): 8-byte loads of both planes where the input is an (H, W, 2)
//   flow, 4-byte loads of each plane where the planes lie apart.
// - Each thread computes a vertical strip of 4 outputs of a column and
//   reads the 6 x 3 values it needs from shared memory once, for the four
//   networks that reuse them.
// - Input and output are taken by strides: planes with unit column stride
//   anywhere in memory (the plane stride may be the distance between two
//   separate buffers, such as the SOR solver's u and v), or the two
//   interleaved planes of an (H, W, 2) flow; the output is (P, H, W) or a
//   contiguous (H, W, 2) flow written with 8-byte stores.  The flow's
//   median then reads the planes where they lie and writes the flow the
//   next warp reads, with no copy on either side.
// - A level of up to 32x32 pixels is one block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;          // threads along x: one output column each
constexpr int TY = 8;           // threads along y
constexpr int R = 4;            // outputs per thread, down a column
constexpr int TW = TX;          // output tile: TW x TH
constexpr int TH = TY * R;
constexpr int SW = TW + 2;      // staged tile with its halo
constexpr int SH = TH + 2;
constexpr int NP = 2;           // planes per block

__device__ __forceinline__ void cas(float& a, float& b) {
  const float lo = fminf(a, b);
  const float hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

// The median network of dense.py::_median3 on v[0..8].
__device__ __forceinline__ float median9(float* v) {
  cas(v[0], v[1]); cas(v[3], v[4]); cas(v[6], v[7]);
  cas(v[1], v[2]); cas(v[4], v[5]); cas(v[7], v[8]);
  cas(v[0], v[1]); cas(v[3], v[4]); cas(v[6], v[7]);
  cas(v[0], v[3]); cas(v[5], v[8]); cas(v[4], v[7]);
  cas(v[3], v[6]); cas(v[1], v[4]); cas(v[2], v[5]);
  cas(v[4], v[7]); cas(v[4], v[2]); cas(v[6], v[4]);
  cas(v[4], v[2]);
  return v[4];
}

// in: plane p at in + p*in_plane, pixel (y, x) at + y*in_row + x, or with
// IN_PAIR the two planes of pixel (y, x) at in + y*in_row + 2x (+1).  out
// likewise with OUT_PAIR (then planes == 2).
template <bool IN_PAIR, bool OUT_PAIR>
__global__ void __launch_bounds__(TX * TY)
median3_kernel(const float* __restrict__ in, int64_t in_plane, int64_t in_row,
               float* __restrict__ out, int64_t out_plane, int64_t out_row,
               int planes, int h, int w) {
  __shared__ float s[NP][SH][SW];

  const int lane = threadIdx.x;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int p0 = blockIdx.z * NP;
  const int np = min(NP, planes - p0);

  // Stage rows y0-1 .. y0+TH, a row per warp at a time: lane l loads
  // column x0-1+l, and lanes 0 and 1 also the halo columns x0+31, x0+32
  // (edge-clamped).
  const int64_t xa = min(max(x0 - 1 + lane, 0), w - 1);
  const int64_t xb = min(x0 + TW - 1 + lane, w - 1);
  const bool halo = lane < SW - TW;
  for (int r = threadIdx.y; r < SH; r += TY) {
    const int64_t yy = min(max(y0 - 1 + r, 0), h - 1);
    if (IN_PAIR) {
      const float2* row = reinterpret_cast<const float2*>(in + yy * in_row);
      const float2 a = row[xa];
      s[0][r][lane] = a.x;
      s[1][r][lane] = a.y;
      if (halo) {
        const float2 b = row[xb];
        s[0][r][TW + lane] = b.x;
        s[1][r][TW + lane] = b.y;
      }
    } else {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        if (p >= np) break;
        const float* row = in + (p0 + p) * in_plane + yy * in_row;
        s[p][r][lane] = row[xa];
        if (halo) s[p][r][TW + lane] = row[xb];
      }
    }
  }
  __syncthreads();

  const int lx = threadIdx.x;
  const int ly = threadIdx.y * R;
  const int x = x0 + lx;
  float res[NP][R];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    if (p >= np) break;
    // Rows ly .. ly + R + 1 of the staged tile, columns lx .. lx + 2.
    float win[R + 2][3];
#pragma unroll
    for (int k = 0; k < R + 2; ++k)
#pragma unroll
      for (int c = 0; c < 3; ++c) win[k][c] = s[p][ly + k][lx + c];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      // dense.py's input order: _shift2(x, dy, dx) for dy, dx in
      // (-1, 0, 1) reads x[y - dy, x - dx]: v[3a + b] = x[y+1-a, x+1-b].
      float v[9];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) v[3 * a + b] = win[i + 2 - a][2 - b];
      res[p][i] = median9(v);
    }
  }

  if (x >= w) return;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int64_t y = y0 + ly + i;
    if (y >= h) break;
    if (OUT_PAIR) {
      *reinterpret_cast<float2*>(out + y * out_row + 2 * x) =
          make_float2(res[0][i], res[1][i]);
    } else {
#pragma unroll
      for (int p = 0; p < NP; ++p)
        if (p < np) out[(p0 + p) * out_plane + y * out_row + x] = res[p][i];
    }
  }
}

}  // namespace

// Element strides (floats).  Unpaired, plane p's row y starts at
// in + p*in_plane + y*in_row, with unit column stride (out likewise).
// out_pair: the output is an (H, W, 2) flow with row stride out_row
// (planes == 2); in_pair (only with out_pair): so is the input, with row
// stride in_row.  in and out must not overlap; the pair layouts need
// 8-byte-aligned rows.
extern "C" int median3_launch(const float* in, long long in_plane,
                              long long in_row, int in_pair, float* out,
                              long long out_plane, long long out_row,
                              int out_pair, int planes, int h, int w,
                              void* stream) {
  if ((long long)planes * h * w == 0) return 0;
  if ((out_pair && planes != 2) || (in_pair && !out_pair))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH,
                  (planes + NP - 1) / NP);
  const dim3 block(TX, TY);
  cudaStream_t st = (cudaStream_t)stream;
  if (in_pair && out_pair)
    median3_kernel<true, true><<<grid, block, 0, st>>>(
        in, in_plane, in_row, out, out_plane, out_row, planes, h, w);
  else if (out_pair)
    median3_kernel<false, true><<<grid, block, 0, st>>>(
        in, in_plane, in_row, out, out_plane, out_row, planes, h, w);
  else
    median3_kernel<false, false><<<grid, block, 0, st>>>(
        in, in_plane, in_row, out, out_plane, out_row, planes, h, w);
  return (int)cudaGetLastError();
}

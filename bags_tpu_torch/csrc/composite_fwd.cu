// Forward tile compositing for Hopper (sm_90a).
//
// Replaces the TPU kernel bags_tpu/raster/pallas_raster.py::_fwd_kernel
// (per-chunk math _chunk_forward). Semantics, per pixel, front to back over
// the tile's depth-sorted instances:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy       skip if power > 0
//   alpha = min(0.99, o exp(power))                 skip if alpha < 1/255
//   test_T = T (1 - alpha); if test_T < 1e-4 the pixel is done and this
//   Gaussian is excluded; else accumulate rgb and depth with w = alpha T,
//   and T = test_T.
// Outputs color+depth (T, 4, 256) and t_final (T, 256), no background.
//
// What bounds it on this card: each instance's 10 features are read once
// per tile (40 B) and each pixel writes 20 B, while every pixel visits its
// tile's instances up to its termination at up to 28 FP32 operations a
// visit. Each instance is visited by 256 pixels, so the operations over the
// 67 TFLOP/s FP32 rate exceed the bytes over 3.35 TB/s (about threefold on
// chip_smoke.py's 1M-Gaussian 1600x1080 view): the bound is operations.
// The design reads each instance from device memory once per tile, into
// shared memory, and spends no work on a pixel once it is done; the real
// limiter of this simple design is latency: a per-pixel sequential loop
// with a data-dependent exit, with idle lanes once a pixel finishes.
//
// Design: one 256-thread block per 16x16 tile, one thread per pixel. The
// block walks its instance range [tile_start, tile_start + tile_count) in
// batches of 256: each thread loads one instance's 10 rows (coalesced along
// each row of the feature-major buffer) into shared memory (10 KB), then
// every pixel walks the batch in order. The TPU kernel's log-transmittance
// prefix scan on the matrix unit is not carried over: CUDA runs the
// sequential recurrence directly. Tile starts need no alignment. The block
// stops when __syncthreads_count(done) says all 256 pixels are done.
//
// Rounding: power is computed with the reference's operation order and no
// fused multiply-add, and exp is expf (no fast math), so alpha agrees with
// the plain PyTorch version to an ulp of exp; colour and depth are summed
// per batch before adding into the running total, as the plain version
// sums per chunk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 16;
constexpr int TILE_H = 16;
constexpr int NPIX = TILE_W * TILE_H;
constexpr int NFEAT = 10;  // mx my ca cb cc o r g b depth
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;

__global__ void __launch_bounds__(NPIX)
composite_fwd_kernel(const float* __restrict__ rows, int64_t row_stride,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, int tiles_x,
                     float* __restrict__ out_color,
                     float* __restrict__ out_t) {
  __shared__ float feat[NFEAT][NPIX];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const float px = (float)((tile % tiles_x) * TILE_W + tid % TILE_W);
  const float py = (float)((tile / tiles_x) * TILE_H + tid / TILE_W);
  const int64_t start = tile_start[tile];
  const int count = tile_count[tile];

  float T = 1.0f;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int done = 0;

  for (int base = 0; base < count; base += NPIX) {
    // Barrier before the batch overwrites shared memory, and block exit
    // once every pixel is done.
    if (__syncthreads_count(done) == NPIX) break;
    const int n = min(NPIX, count - base);
    if (tid < n) {
      const float* src = rows + start + base + tid;
#pragma unroll
      for (int f = 0; f < NFEAT; ++f) feat[f][tid] = src[f * row_stride];
    }
    __syncthreads();
    if (done) continue;

    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = 0; j < n; ++j) {
      const float dx = __fsub_rn(px, feat[0][j]);
      const float dy = __fsub_rn(py, feat[1][j]);
      const float q = __fadd_rn(__fmul_rn(__fmul_rn(feat[2][j], dx), dx),
                                __fmul_rn(__fmul_rn(feat[4][j], dy), dy));
      const float power = __fsub_rn(__fmul_rn(-0.5f, q),
                                    __fmul_rn(__fmul_rn(feat[3][j], dx), dy));
      if (power > 0.0f) continue;
      const float alpha = fminf(ALPHA_MAX, __fmul_rn(feat[5][j], expf(power)));
      if (alpha < ALPHA_MIN) continue;
      const float test_T = __fmul_rn(T, __fsub_rn(1.0f, alpha));
      if (test_T < T_EPS) {
        done = 1;
        break;
      }
      const float w = __fmul_rn(alpha, T);
#pragma unroll
      for (int c = 0; c < 4; ++c) part[c] = fmaf(feat[6 + c][j], w, part[c]);
      T = test_T;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] += part[c];
  }

  float* color = out_color + (int64_t)tile * 4 * NPIX;
#pragma unroll
  for (int c = 0; c < 4; ++c) color[c * NPIX + tid] = acc[c];
  out_t[(int64_t)tile * NPIX + tid] = T;
}

}  // namespace

// rows: (F >= 10, row_stride) float32, feature-major; tile_start and
// tile_count: (num_tiles,) int32; out_color: (num_tiles, 4, 256) float32;
// out_t: (num_tiles, 256) float32. Launches on `stream`; returns the
// cudaError_t of the launch.
extern "C" int composite_fwd_launch(const void* rows, int64_t row_stride,
                                    const void* tile_start,
                                    const void* tile_count, int tiles_x,
                                    int num_tiles, void* out_color,
                                    void* out_t, void* stream) {
  if (num_tiles > 0) {
    composite_fwd_kernel<<<num_tiles, NPIX, 0, (cudaStream_t)stream>>>(
        (const float*)rows, row_stride, (const int*)tile_start,
        (const int*)tile_count, tiles_x, (float*)out_color, (float*)out_t);
  }
  return (int)cudaGetLastError();
}

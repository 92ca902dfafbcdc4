// Ablation variants of the forward compositing loop, for timing only;
// Hopper (sm_90a).
//
// composite_ablate_launch replaces the TPU kernel
// tools/kernablate.py::main's make_kernel(mode) `kern`. Its four modes are
// deliberately NOT the compositing function: each removes one piece of the
// forward loop so that the differences between their times price that
// piece. Per tile, the block walks the tile's 128-slot chunks aligned to
// global slot multiples of 128 (as the TPU's DMA windows are), from
// floor(start / 128) to ceil((start + count) / 128) - 1, and each pixel walks
// the chunk's lanes inside [start, start + count) in order. With `power` as
// in composite_fwd.cu, ok = alpha >= 1/255 && power <= 0, and a = alpha
// where ok:
//   DMA_ONLY           w = power (no alpha, no test)
//   NO_TRANSCENDENTAL  alpha = min(0.99, o power), w = a (1 + S), S the
//                      exclusive running sum of a inside the chunk
//   NO_SCAN            alpha = min(0.99, o exp(power)), w = a exp(log1p(-a))
//   FULL               alpha as NO_SCAN, w = a exp(L), L the exclusive
//                      running sum of log1p(-a) inside the chunk
// L and S reset at every chunk; there is no termination and no kill. Every
// mode adds colour_c w (r, g, b, depth) into the pixel's sum, per chunk, and
// sets t_out = t_out - 0 * sum(w) once per chunk: without fast math nvcc
// keeps 0 * x, so a non-finite sum shows as NaN as it does in the TPU tool,
// and t_out is otherwise exactly 1. NO_TRANSCENDENTAL composites nothing:
// o >= 0 and power <= 0 make o power <= 0 < 1/255 for every pair, in the
// TPU tool as here, so its time is that of the loop with every pair
// rejected after the alpha test.
//
// What bounds them on this card: each instance's 10 features are read once
// per tile (40 B) and each pixel writes 20 B, while every pixel visits every
// instance of its tile at 12-29 FP32 operations a visit: operations, several
// times over the bytes. The design is the forward kernel's first one: one
// 256-thread block per 16x16 tile, one thread per pixel, features in shared
// memory (one float array per row), a sequential per-pixel loop over every
// instance; the modes keep that loop's operation order (__fmul_rn,
// __fadd_rn, expf, log1pf, no fast math) and its branch structure, apart
// from the piece each mode removes. They do not follow the redesigned
// forward (composite_fwd.cu: instances as three float4, the exp skip, the
// footprint cull, the per-warp walk), so they price the pieces of that
// first loop.

#include "composite_common.cuh"

namespace {

constexpr int CHUNK = 128;  // slots per ablation chunk (the TPU's lane width)

enum Mode { DMA_ONLY = 0, NO_TRANSCENDENTAL = 1, NO_SCAN = 2, FULL = 3 };

__device__ __forceinline__ float gauss_power(float px, float py, const float* mx,
                                             const float* my, const float* ca,
                                             const float* cb, const float* cc,
                                             int j) {
  const float dx = __fsub_rn(px, mx[j]);
  const float dy = __fsub_rn(py, my[j]);
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(ca[j], dx), dx),
                            __fmul_rn(__fmul_rn(cc[j], dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(cb[j], dx), dy));
}

template <int MODE>
__global__ void __launch_bounds__(NPIX)
composite_ablate_kernel(const float* __restrict__ rows, int64_t row_stride,
                        const int* __restrict__ tile_start,
                        const int* __restrict__ tile_count, int tiles_x,
                        float* __restrict__ out_color,
                        float* __restrict__ out_t) {
  __shared__ float feat[NFEAT][CHUNK];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const float px = (float)((tile % tiles_x) * TILE_W + tid % TILE_W);
  const float py = (float)((tile / tiles_x) * TILE_H + tid / TILE_W);
  const int64_t start = tile_start[tile];
  const int64_t end = start + tile_count[tile];
  const int64_t c_end = tile_count[tile] > 0 ? (end + CHUNK - 1) / CHUNK : 0;

  float t_out = 1.0f;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int64_t c = start / CHUNK; c < c_end; ++c) {
    const int64_t base = c * CHUNK;
    const int lo = start > base ? (int)(start - base) : 0;
    const int hi = end < base + CHUNK ? (int)(end - base) : CHUNK;
    __syncthreads();  // the previous chunk's reads are done
    if (tid >= lo && tid < hi) {
      const float* src = rows + base + tid;
#pragma unroll
      for (int f = 0; f < NFEAT; ++f) feat[f][tid] = src[f * row_stride];
    }
    __syncthreads();

    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float w_sum = 0.0f;
    float run = 0.0f;  // S (NO_TRANSCENDENTAL) or L (FULL), per chunk
    for (int j = lo; j < hi; ++j) {
      const float power = gauss_power(px, py, feat[0], feat[1], feat[2],
                                      feat[3], feat[4], j);
      float w;
      if constexpr (MODE == DMA_ONLY) {
        w = power;
      } else {
        if (!(power <= 0.0f)) continue;
        float alpha;
        if constexpr (MODE == NO_TRANSCENDENTAL) {
          alpha = fminf(ALPHA_MAX, __fmul_rn(feat[5][j], power));
        } else {
          alpha = fminf(ALPHA_MAX, __fmul_rn(feat[5][j], expf(power)));
        }
        if (!(alpha >= ALPHA_MIN)) continue;
        if constexpr (MODE == NO_TRANSCENDENTAL) {
          w = __fmul_rn(alpha, __fadd_rn(1.0f, run));
          run = __fadd_rn(run, alpha);
        } else if constexpr (MODE == NO_SCAN) {
          w = __fmul_rn(alpha, expf(log1pf(-alpha)));
        } else {
          w = __fmul_rn(alpha, expf(run));
          run = __fadd_rn(run, log1pf(-alpha));
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) part[k] = fmaf(feat[6 + k][j], w, part[k]);
      w_sum = __fadd_rn(w_sum, w);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] += part[k];
    t_out = __fsub_rn(t_out, __fmul_rn(0.0f, w_sum));
  }

  float* color = out_color + (int64_t)tile * 4 * NPIX;
#pragma unroll
  for (int k = 0; k < 4; ++k) color[k * NPIX + tid] = acc[k];
  out_t[(int64_t)tile * NPIX + tid] = t_out;
}

}  // namespace

// rows: (F >= 10, row_stride) float32, feature-major; tile_start and
// tile_count: (num_tiles,) int32; out_color: (num_tiles, 4, 256) float32;
// out_t: (num_tiles, 256) float32. mode: 0 dma_only, 1 no_transcendental,
// 2 no_scan, 3 full. Launches on `stream`; returns the cudaError_t of the
// launch (cudaErrorInvalidValue for an unknown mode).
extern "C" int composite_ablate_launch(int mode, const void* rows,
                                       int64_t row_stride,
                                       const void* tile_start,
                                       const void* tile_count, int tiles_x,
                                       int num_tiles, void* out_color,
                                       void* out_t, void* stream) {
  if (num_tiles <= 0) return (int)cudaGetLastError();
  const dim3 grid(num_tiles), block(NPIX);
  cudaStream_t s = (cudaStream_t)stream;
  const float* r = (const float*)rows;
  const int* ts = (const int*)tile_start;
  const int* tc = (const int*)tile_count;
  float* oc = (float*)out_color;
  float* ot = (float*)out_t;
  switch (mode) {
    case DMA_ONLY:
      composite_ablate_kernel<DMA_ONLY><<<grid, block, 0, s>>>(
          r, row_stride, ts, tc, tiles_x, oc, ot);
      break;
    case NO_TRANSCENDENTAL:
      composite_ablate_kernel<NO_TRANSCENDENTAL><<<grid, block, 0, s>>>(
          r, row_stride, ts, tc, tiles_x, oc, ot);
      break;
    case NO_SCAN:
      composite_ablate_kernel<NO_SCAN><<<grid, block, 0, s>>>(
          r, row_stride, ts, tc, tiles_x, oc, ot);
      break;
    case FULL:
      composite_ablate_kernel<FULL><<<grid, block, 0, s>>>(
          r, row_stride, ts, tc, tiles_x, oc, ot);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Backward of the tile compositing for Hopper (sm_90a).
//
// Replaces the TPU kernel bags_tpu/raster/pallas_raster.py::_bwd_kernel
// (launched by composite_bwd_padded, un-padded by _composite_core_bwd).
// Given the forward's inputs and outputs and the cotangents g (rgb+depth)
// and g_T of each pixel, it replays every pixel's front-to-back pass
// exactly as csrc/composite_fwd.cu runs it and, for each included instance
// i (weight w_i = alpha_i T_i), forms
//   suffix_i  = <g, C_total - inclusive-prefix_i(c w)>
//   dL/dalpha = <g, c_i> T_i - (suffix_i + g_T T_final) / max(1 - alpha_i, 1e-6)
// zeroed where o G >= 0.99 (the alpha clamp), and chains it to the ten
// instance rows mx my ca cb cc o r g b depth:
//   d_power = dL/dalpha o G;  d_mx = (a dx + b dy) d_power;
//   d_my = (c dy + b dx) d_power;  d_ca = -dx^2/2 d_power;
//   d_cb = -dx dy d_power;  d_cc = -dy^2/2 d_power;  d_o = dL/dalpha G;
//   d_rgb, d_depth = g w.
// Each instance's gradient is the sum over the 256 pixels of its tile.
// Output: d_rows (10, M) in slot order; slots the block never reaches (after
// every pixel of its tile is done) keep the zeros the wrapper allocated.
//
// What bounds it on this card: every pixel visits its tile's instances up
// to its termination and replays the forward's work on each (up to 19 FP32
// operations); each included pair then adds about 73 more (prefix, suffix,
// dL/dalpha, the ten gradients and their sum over the tile's pixels). The
// bytes are 40 B read and 40 B written per instance and 40 B per pixel. On
// chip_smoke.py's 1M-Gaussian 1600x1080 training view the operations over
// the 67 TFLOP/s FP32 rate take about 4.6 times as long as the bytes over
// 3.35 TB/s (H100 80GB HBM3): the bound is operations. The design keeps the
// sums over pixels inside the block (each instance slot belongs to exactly
// one tile), so nothing goes through global atomics and each gradient is
// written once, coalesced. What holds this simple design back is latency:
// the per-pixel loop is sequential, and for every instance that any lane of
// a warp includes, the warp spends five shuffle rounds on each of the ten
// values.
//
// Design: one 256-thread block per 16x16 tile, one thread per pixel, the
// forward's 256-instance batches in shared memory. For each instance of a
// batch a warp that has a contributing lane reduces its ten values with
// __shfl_down_sync and lane 0 stores them into its own slot of a
// (8 warps, 10, 256) shared buffer (zeros when no lane contributes); after
// the batch each thread sums the 8 slots of one instance in a fixed order
// and writes its ten rows. The sums are therefore deterministic. The TPU's
// padded per-tile output, its matrix-unit moment basis and its bf16 splits
// are not carried over.
//
// Rounding: the replay uses the forward's operation order (__fmul_rn /
// __fadd_rn, expf, the same per-batch partial sums), so the include
// decisions, T and w are bit-identical to the forward's, and the running
// per-channel prefix equals the forward's C_total at the last included
// instance: its suffix is exactly 0 rather than cancellation noise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 16;
constexpr int TILE_H = 16;
constexpr int NPIX = TILE_W * TILE_H;
constexpr int NWARP = NPIX / 32;
constexpr int NFEAT = 10;  // mx my ca cb cc o r g b depth
constexpr int NGRAD = 10;  // one gradient per instance row
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_BYTES = (NFEAT + NWARP * NGRAD) * NPIX * (int)sizeof(float);

__global__ void __launch_bounds__(NPIX)
composite_bwd_kernel(const float* __restrict__ rows, int64_t row_stride,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, int tiles_x,
                     const float* __restrict__ g_color,
                     const float* __restrict__ g_t,
                     const float* __restrict__ color,
                     const float* __restrict__ t_final,
                     float* __restrict__ d_rows) {
  extern __shared__ float smem[];
  float(*feat)[NPIX] = reinterpret_cast<float(*)[NPIX]>(smem);
  float(*red)[NGRAD][NPIX] =
      reinterpret_cast<float(*)[NGRAD][NPIX]>(smem + NFEAT * NPIX);

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float px = (float)((tile % tiles_x) * TILE_W + tid % TILE_W);
  const float py = (float)((tile / tiles_x) * TILE_H + tid / TILE_W);
  const int64_t start = tile_start[tile];
  const int count = tile_count[tile];

  float g[4], ctot[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    g[c] = g_color[((int64_t)tile * 4 + c) * NPIX + tid];
    ctot[c] = color[((int64_t)tile * 4 + c) * NPIX + tid];
  }
  const int64_t pix = (int64_t)tile * NPIX + tid;
  const float gt_tfinal = g_t[pix] * t_final[pix];

  float T = 1.0f;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int done = 0;

  for (int base = 0; base < count; base += NPIX) {
    // Barrier before the batch overwrites shared memory (and after the
    // previous batch's sums were read), and block exit once every pixel is
    // done: the slots not reached keep their zeros.
    if (__syncthreads_count(done) == NPIX) break;
    const int n = min(NPIX, count - base);
    if (tid < n) {
      const float* src = rows + start + base + tid;
#pragma unroll
      for (int f = 0; f < NFEAT; ++f) feat[f][tid] = src[f * row_stride];
    }
    __syncthreads();

    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = 0; j < n; ++j) {
      float v[NGRAD];
#pragma unroll
      for (int f = 0; f < NGRAD; ++f) v[f] = 0.0f;
      bool contrib = false;
      if (!done) {
        const float dx = __fsub_rn(px, feat[0][j]);
        const float dy = __fsub_rn(py, feat[1][j]);
        const float ca = feat[2][j], cb = feat[3][j], cc = feat[4][j];
        const float q = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                                  __fmul_rn(__fmul_rn(cc, dy), dy));
        const float power = __fsub_rn(__fmul_rn(-0.5f, q),
                                      __fmul_rn(__fmul_rn(cb, dx), dy));
        if (power <= 0.0f) {
          const float G = expf(power);
          const float oG = __fmul_rn(feat[5][j], G);
          const float alpha = fminf(ALPHA_MAX, oG);
          if (alpha >= ALPHA_MIN) {
            const float test_T = __fmul_rn(T, __fsub_rn(1.0f, alpha));
            if (test_T < T_EPS) {
              done = 1;
            } else {
              const float w = __fmul_rn(alpha, T);
              float suffix = 0.0f, gdotc = 0.0f;
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const float col = feat[6 + c][j];
                part[c] = fmaf(col, w, part[c]);
                suffix += g[c] * (ctot[c] - (acc[c] + part[c]));
                gdotc += g[c] * col;
                v[6 + c] = g[c] * w;
              }
              const float d_alpha = gdotc * T - (suffix + gt_tfinal) /
                                                    fmaxf(1.0f - alpha, 1e-6f);
              const float d_aG = oG < ALPHA_MAX ? d_alpha : 0.0f;
              const float d_power = d_aG * oG;
              v[0] = (ca * dx + cb * dy) * d_power;
              v[1] = (cc * dy + cb * dx) * d_power;
              v[2] = -0.5f * dx * dx * d_power;
              v[3] = -dx * dy * d_power;
              v[4] = -0.5f * dy * dy * d_power;
              v[5] = d_aG * G;
              contrib = true;
              T = test_T;
            }
          }
        }
      }
      if (__any_sync(FULL, contrib)) {
#pragma unroll
        for (int f = 0; f < NGRAD; ++f) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v[f] += __shfl_down_sync(FULL, v[f], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < NGRAD; ++f) red[warp][f][j] = v[f];
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] += part[c];
    __syncthreads();

    if (tid < n) {
      float* dst = d_rows + start + base + tid;
#pragma unroll
      for (int f = 0; f < NGRAD; ++f) {
        float s = red[0][f][tid];
#pragma unroll
        for (int w = 1; w < NWARP; ++w) s += red[w][f][tid];
        dst[f * row_stride] = s;
      }
    }
  }
}

}  // namespace

// rows: (F >= 10, row_stride) float32, feature-major; tile_start and
// tile_count: (num_tiles,) int32; g_color and color: (num_tiles, 4, 256)
// float32; g_t and t_final: (num_tiles, 256) float32; d_rows: (10,
// row_stride) float32, zero-filled by the caller. Launches on `stream`;
// returns the cudaError_t of the set-up and the launch.
extern "C" int composite_bwd_launch(const void* rows, int64_t row_stride,
                                    const void* tile_start,
                                    const void* tile_count, int tiles_x,
                                    int num_tiles, const void* g_color,
                                    const void* g_t, const void* color,
                                    const void* t_final, void* d_rows,
                                    void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (num_tiles > 0) {
    composite_bwd_kernel<<<num_tiles, NPIX, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const float*)rows, row_stride, (const int*)tile_start,
        (const int*)tile_count, tiles_x, (const float*)g_color,
        (const float*)g_t, (const float*)color, (const float*)t_final,
        (float*)d_rows);
  }
  return (int)cudaGetLastError();
}

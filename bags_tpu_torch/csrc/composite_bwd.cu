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
// What bounds it on this card: every pixel walks its tile's instances up
// to its termination; the pairs inside an instance's footprint (below) need
// the forward's power and test (12 FP32 operations), those at or above
// p_min the exp and the alpha test (4 and 3 more), and each included pair
// about 73 more (prefix, suffix, dL/dalpha, the ten gradients and their sum
// over the tile's pixels). The bytes are 40 B read and 40 B written per
// instance and 40 B per pixel. On chip_smoke.py's 1M-Gaussian 1600x1080
// training view those operations over the 67 TFLOP/s FP32 rate take longer
// than the bytes over 3.35 TB/s (H100 80GB HBM3): the bound is operations
// (utils/profiling.py counts them, PERF.md gives both). What the kernel
// waits on is instruction issue and latency in a sequential per-pixel
// loop: every instance a warp visits costs it about twenty instructions of
// replay, and every instance that any of its lanes includes about 150 more
// (the gradient, and a reduction of ten values across the warp). So the
// design visits less, reduces cheaply and keeps enough warps resident.
//
// Design: one 256-thread block per 16x16 tile, one thread per pixel; the
// forward's 256-instance batches are loaded into shared memory (so the
// per-channel prefix is summed per batch and then added into the running
// total exactly as the forward sums it). Inside a batch the warps walk
// sub-batches of SUB = 32 instances:
// - a warp whose 32 pixels are all done skips the sub-batch;
// - the footprint cull (below): a warp none of whose pixels can reach the
//   instance's p_min skips the instance on one bit, set at batch load;
// - the exp skip (below): a pair whose power lies below p_min fails the
//   alpha test for certain and skips the exp. Every other pair takes the
//   exact test, so no include decision changes;
// - for each instance that some lane of a warp includes, the warp sums its
//   ten values with a recursive-halving reduce-scatter (12 shuffles,
//   reduce_scatter below) and ten lanes store one sum each; an instance no
//   lane includes costs no stores and leaves its bit of the warp's mask 0.
//   The ten values stay zero between reductions, so a visit that includes
//   nothing writes no registers for them;
// - after the sub-batch (__syncthreads_count, which also tells the block
//   when every pixel is done) each thread sums one (row, instance) entry
//   over the warps whose mask bit is set, in warp order, and writes it,
//   coalesced. The sums are therefore deterministic and nothing is atomic.
// The loop reads shared memory through 32-bit addresses taken once (lds4),
// so it does not rebuild the shared window's base on every instance. The
// wrapper launches the tiles with the most instances first (tile_order), so
// the last wave of blocks holds short tiles; each tile's slots are its own,
// so the order changes no result.
// Shared memory per block: 12,288 B of instances (three float4 each, read
// as broadcasts), 21,120 B of per-warp sums (2 buffers x 8 warps x 10 rows
// x 33, the pad putting the ten holders of one instance on ten banks), 64 B
// of masks: 33,472 B, 6 blocks per SM by the 228 KB of shared memory (1 KB
// reserved per block). Registers decide the rest: at 256 threads a block,
// 4 blocks per SM leave 64 registers a thread, 3 blocks 80, 5 blocks 48;
// MIN_BLOCKS = 4 was the fastest on the card (PERF.md).
//
// The exp skip and the footprint cull (below p_min a pair fails the alpha
// test for certain; outside an instance's footprint every pair lies below
// p_min) are derived in composite_common.cuh, which both kernels include.
// The backward's warps are 16x2 pixel blocks (rows 2w and 2w + 1).
//
// Rounding: the replay uses the forward's operation order (__fmul_rn /
// __fadd_rn, expf, the same per-batch partial sums), so the include
// decisions, T and w are bit-identical to the forward's, and the running
// per-channel prefix equals the forward's C_total at the last included
// instance: its suffix is exactly 0 rather than cancellation noise.

#include "composite_common.cuh"

namespace {

constexpr int NGRAD = 10;  // one gradient per instance row
constexpr int SUB = 32;    // instances per cross-warp flush
constexpr int MIN_BLOCKS = 4;  // resident blocks per SM asked of ptxas
constexpr int WARP_ROWS = 2;   // a warp is 16 x 2 pixels

struct Shared {
  Inst inst[NPIX];
  float red[2][NWARP][NGRAD][SUB + 1];
  alignas(16) unsigned mask[2][NWARP];  // bit j: the warp stored instance j
};

// Sums v[0..9] over the warp by recursive halving: in each round a lane
// keeps half of its values, adds its partner's copy of them and sends the
// other half (partners lane ^ 16, 8, 4, 2, 1; 5 + 3 + 2 + 1 + 1 shuffles).
// Returns the full sum of value holder_slot(lane) where that is >= 0, a
// partial sum elsewhere. Every lane of the warp must call it.
__device__ __forceinline__ float reduce_scatter(const float (&v)[NGRAD],
                                                int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  // lanes with b4 clear keep values 0-4, the others 5-9: a[k]
  float a[5];
#pragma unroll
  for (int k = 0; k < 5; ++k)
    a[k] = (b4 ? v[5 + k] : v[k]) +
           __shfl_xor_sync(ALL_LANES, b4 ? v[k] : v[5 + k], 16);
  // b3 clear keeps a0 a1 a2 (as c0 c1 c2), b3 set keeps a3 a4 (as c0 c1)
  const float r0 = __shfl_xor_sync(ALL_LANES, b3 ? a[0] : a[3], 8);
  const float r1 = __shfl_xor_sync(ALL_LANES, b3 ? a[1] : a[4], 8);
  const float r2 = __shfl_xor_sync(ALL_LANES, a[2], 8);
  const float c0 = (b3 ? a[3] : a[0]) + r0;
  const float c1 = (b3 ? a[4] : a[1]) + r1;
  const float c2 = a[2] + r2;
  // (b3, b2) = (0, 0) keeps c0 c1 (as e0 e1); (0, 1) c2, (1, 0) c0 and
  // (1, 1) c1 (as e0)
  const float rA = __shfl_xor_sync(ALL_LANES, b2 ? c0 : (b3 ? c1 : c2), 4);
  const float rB = __shfl_xor_sync(ALL_LANES, c1, 4);
  const float e0 = (b2 ? (b3 ? c1 : c2) : c0) + rA;
  const float e1 = c1 + rB;
  // (0, 0) splits e0 e1 over b1; the other groups gather e0 where b1 is clear
  const bool two = !b3 && !b2;
  const float x = ((two && b1) ? e1 : e0) +
                  __shfl_xor_sync(ALL_LANES, (two && !b1) ? e1 : e0, 2);
  return x + __shfl_xor_sync(ALL_LANES, x, 1);
}

// Which of the ten sums reduce_scatter leaves in `lane` (lanes 0, 2, 4, 8,
// 12 hold values 0-4 and lanes 16, 18, 20, 24, 28 values 5-9), or -1.
__device__ __forceinline__ int holder_slot(int lane) {
  const int b3 = lane >> 3 & 1, b2 = lane >> 2 & 1, b1 = lane >> 1 & 1;
  if (lane & 1) return -1;
  if (!b3 && !b2) return 5 * (lane >> 4) + b1;
  if (b1) return -1;
  return 5 * (lane >> 4) + 1 + 2 * b3 + b2;
}

__global__ void __launch_bounds__(NPIX, MIN_BLOCKS)
composite_bwd_kernel(const float* __restrict__ rows, int64_t row_stride,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const int* __restrict__ tile_order, int tiles_x,
                     const float* __restrict__ g_color,
                     const float* __restrict__ g_t,
                     const float* __restrict__ color,
                     const float* __restrict__ t_final,
                     float* __restrict__ d_rows) {
  __shared__ Shared sm;

  const int tile = tile_order[blockIdx.x];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slot = holder_slot(lane);
  const unsigned inst_addr = smem_addr(sm.inst);
  // This lane's sum slot of instance 0 in buffer 0 (used by holders only).
  const unsigned red_addr =
      smem_addr(&sm.red[0][warp][slot < 0 ? 0 : slot][0]);
  constexpr unsigned RED_BUF = sizeof(sm.red[0]);
  const float x0 = (float)((tile % tiles_x) * TILE_W);
  const float y0 = (float)((tile / tiles_x) * TILE_H);
  const float px = x0 + (float)(tid % TILE_W);
  const float py = y0 + (float)(tid / TILE_W);
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
  int buf = 0;
  // Zero except between a contributing lane's gradient and the reduction.
  float v[NGRAD];
#pragma unroll
  for (int f = 0; f < NGRAD; ++f) v[f] = 0.0f;

  for (int base = 0; base < count; base += NPIX) {
    // Every warp finished the previous batch before the last flush's
    // barrier, and the flush reads only red and mask: the batch may load.
    const int n = min(NPIX, count - base);
    if (tid < n) {
      const float* src = rows + start + base + tid;
      float f[NFEAT];
#pragma unroll
      for (int k = 0; k < NFEAT; ++k) f[k] = src[k * row_stride];
      const float p_min = p_min_of(f[5]);
      const unsigned warps =
          footprint_warps<TILE_W, WARP_ROWS>(f[0], f[1], f[2], f[3], f[4],
                                              p_min, x0, y0);
      Inst& in = sm.inst[tid];
      in.geo = make_float4(f[0], f[1], f[2], f[3]);
      in.opa = make_float4(f[4], p_min, f[5], __uint_as_float(warps));
      in.col = make_float4(f[6], f[7], f[8], f[9]);
    }
    __syncthreads();

    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int sub = 0; sub < n; sub += SUB) {
      const int m = min(SUB, n - sub);
      unsigned stored = 0;  // warp-uniform
      if (__any_sync(ALL_LANES, !done)) {
        for (int j = 0; j < m; ++j) {
          const unsigned in = inst_addr + (unsigned)(sub + j) * sizeof(Inst);
          const float4 opa = lds4(in + 16);
          if (!(__float_as_uint(opa.w) >> warp & 1u)) continue;
          bool contrib = false;
          if (!done) {
            const float4 geo = lds4(in);
            const float ca = geo.z, cb = geo.w, cc = opa.x;
            const float dx = __fsub_rn(px, geo.x);
            const float dy = __fsub_rn(py, geo.y);
            const float q = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                                      __fmul_rn(__fmul_rn(cc, dy), dy));
            const float power = __fsub_rn(__fmul_rn(-0.5f, q),
                                          __fmul_rn(__fmul_rn(cb, dx), dy));
            if (power <= 0.0f && !(power < opa.y)) {
              const float G = expf(power);
              const float oG = __fmul_rn(opa.z, G);
              const float alpha = fminf(ALPHA_MAX, oG);
              if (alpha >= ALPHA_MIN) {
                const float test_T = __fmul_rn(T, __fsub_rn(1.0f, alpha));
                if (test_T < T_EPS) {
                  done = 1;
                } else {
                  const float4 col4 = lds4(in + 32);
                  const float col[4] = {col4.x, col4.y, col4.z, col4.w};
                  const float w = __fmul_rn(alpha, T);
                  float suffix = 0.0f, gdotc = 0.0f;
#pragma unroll
                  for (int c = 0; c < 4; ++c) {
                    part[c] = fmaf(col[c], w, part[c]);
                    suffix += g[c] * (ctot[c] - (acc[c] + part[c]));
                    gdotc += g[c] * col[c];
                    v[6 + c] = g[c] * w;
                  }
                  const float d_alpha =
                      gdotc * T -
                      (suffix + gt_tfinal) / fmaxf(1.0f - alpha, 1e-6f);
                  const float d_aG = oG < ALPHA_MAX ? d_alpha : 0.0f;
                  const float d_power = d_aG * oG;
                  const float tx = d_power * dx, ty = d_power * dy;
                  v[0] = ca * tx + cb * ty;
                  v[1] = cc * ty + cb * tx;
                  v[2] = -0.5f * dx * tx;
                  v[3] = -dx * ty;
                  v[4] = -0.5f * dy * ty;
                  v[5] = d_aG * G;
                  contrib = true;
                  T = test_T;
                }
              }
            }
          }
          if (__any_sync(ALL_LANES, contrib)) {
            const float s = reduce_scatter(v, lane);
            if (slot >= 0) sts(red_addr + buf * RED_BUF + 4u * j, s);
            stored |= 1u << j;
#pragma unroll
            for (int f = 0; f < NGRAD; ++f) v[f] = 0.0f;
          }
        }
      }
      if (lane == 0) sm.mask[buf][warp] = stored;
      const int n_done = __syncthreads_count(done);

      const uint4 m0 = *reinterpret_cast<const uint4*>(&sm.mask[buf][0]);
      const uint4 m1 = *reinterpret_cast<const uint4*>(&sm.mask[buf][4]);
      const unsigned wm[NWARP] = {m0.x, m0.y, m0.z, m0.w,
                                  m1.x, m1.y, m1.z, m1.w};
      for (int e = tid; e < NGRAD * SUB; e += NPIX) {
        const int f = e / SUB, j = e % SUB;
        if (j < m) {
          float s = 0.0f;
#pragma unroll
          for (int w = 0; w < NWARP; ++w)
            if (wm[w] >> j & 1u) s += sm.red[buf][w][f][j];
          d_rows[f * row_stride + start + base + sub + j] = s;
        }
      }
      // The other buffer is free: every thread passed this barrier after
      // its flush of the sub-batch before.
      buf ^= 1;
      // Block exit once every pixel is done: the slots not reached keep
      // their zeros.
      if (n_done == NPIX) return;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] += part[c];
  }
}

}  // namespace

// rows: (F >= 10, row_stride) float32, feature-major; tile_start,
// tile_count and tile_order (the tiles in launch order, a permutation):
// (num_tiles,) int32; g_color and color: (num_tiles, 4, 256)
// float32; g_t and t_final: (num_tiles, 256) float32; d_rows: (10,
// row_stride) float32, zero-filled by the caller. Launches on `stream`;
// returns the cudaError_t of the launch.
extern "C" int composite_bwd_launch(const void* rows, int64_t row_stride,
                                    const void* tile_start,
                                    const void* tile_count,
                                    const void* tile_order, int tiles_x,
                                    int num_tiles, const void* g_color,
                                    const void* g_t, const void* color,
                                    const void* t_final, void* d_rows,
                                    void* stream) {
  if (num_tiles > 0) {
    composite_bwd_kernel<<<num_tiles, NPIX, 0, (cudaStream_t)stream>>>(
        (const float*)rows, row_stride, (const int*)tile_start,
        (const int*)tile_count, (const int*)tile_order, tiles_x,
        (const float*)g_color, (const float*)g_t, (const float*)color,
        (const float*)t_final, (float*)d_rows);
  }
  return (int)cudaGetLastError();
}

// The backward kernel's resources (kernel_info in composite_common.cuh).
extern "C" int composite_bwd_info(int* out) {
  return kernel_info(composite_bwd_kernel, out);
}

// Forward tile compositing for Hopper (sm_90a), and its no-exit twin fori.
//
// Replaces the TPU kernel bags_tpu/raster/pallas_raster.py::_fwd_kernel
// (per-chunk math _chunk_forward), and, as composite_fwd_fori_launch,
// tools/kernablate.py::real_variants's `fori_kernel`. Semantics, per pixel,
// front to back over the tile's depth-sorted instances (composite_common.cuh
// gives power and alpha): skip the pair if power > 0 or alpha < 1/255;
// test_T = T (1 - alpha); if test_T < 1e-4 the pixel is done and this
// Gaussian is excluded; else accumulate rgb and depth with w = alpha T, and
// T = test_T. Outputs color+depth (T, 4, 256) and t_final (T, 256), no
// background.
//
// What bounds it on this card: each instance's 10 features are read once
// per tile (40 B) and each pixel writes 20 B; the compositing needs the
// power of a pair only inside its instance's footprint and the exp only at
// or above p_min (composite_common.cuh). On chip_smoke.py's 1M-Gaussian
// 1600x1080 rendered view those operations over 67 TFLOP/s take less time
// than the bytes over 3.35 TB/s, and on its denser training view more
// (utils/profiling.py counts both; PERF.md). What the kernel waits on is
// instruction issue in a sequential per-pixel loop: each instance a warp
// visits costs it its loads, the power and the tests whether or not any
// lane uses it. So the design visits as few as it can.
//
// Design: one 256-thread block per 16x16 tile, one thread per pixel, and
// each warp an 8x4 block of pixels (WARP_W x WARP_H). The block walks its
// instance range [tile_start, tile_start + tile_count) in batches of 256:
// - at batch load each thread loads one instance's 10 rows (coalesced along
//   each row of the feature-major buffer), stores it as three float4 (Inst)
//   with its p_min, and sets its footprint mask: one bit per warp that
//   meets the instance's footprint;
// - each warp walks only the batch instances whose mask holds its bit, in
//   ascending order: per 32 instances one ballot of the masks gives the
//   warp a word of kept instances, and the walk steps from set bit to set
//   bit (__ffs), so an instance none of its pixels can pass costs it no
//   step and no per-instance test (a list of one-byte indices built with a
//   popc prefix instead was slower and spilled more: PERF.md);
// - a pair below p_min skips the exp and the alpha test (it fails them);
// - a warp whose 32 pixels are all done stops walking at the next word of
//   32 instances (a vote per step instead was slower), and with EXIT the
//   block stops when __syncthreads_count(done) says all 256 are done
//   (fori, EXIT false, loads every batch instead: its time beside the
//   forward's prices the exit);
// - the wrapper launches the tiles with the most instances first
//   (tile_order), so the last wave of blocks holds short tiles.
// The loop reads shared memory through 32-bit addresses taken once.
// The profiling tool prices these pieces with variants of this kernel, each
// without one piece and with the others as here (DROP:
// composite_fwd_variant_launch): the exp skip, the footprint cull (every
// warp's bit set) and the walk over ballot words (a step and a bit test for
// every batch instance); and the launch order, by launching this kernel
// with the tiles in index order. Each computes the forward's function bit
// for bit; the default DROP = KEEP_ALL is the forward.
// Shared memory per block: 12,288 B of instances and 256 B of masks, so
// registers decide the blocks per SM: MIN_BLOCKS = 8 (32 registers, a few
// bytes spilled outside the instance loop) was faster than 6 or 4 on the
// card (PERF.md).
//
// Bit for bit: a pixel skips only pairs that it would have rejected (the
// exp skip and the cull, proved in composite_common.cuh), in ascending
// order within the batch, so its included pairs, T and w are those of the
// plain loop. Power is formed in the plain version's operation order with
// no fused multiply-add and exp is expf (no fast math), so alpha agrees with
// the plain PyTorch version to an ulp of exp; colour and depth are summed
// per batch before adding into the running total, as the plain version
// sums per chunk and csrc/composite_bwd.cu replays it.

#include "composite_common.cuh"

namespace {

constexpr int WARP_W = 8;  // pixels of a warp: 8 columns x 4 rows
constexpr int WARP_H = 32 / WARP_W;
constexpr int MIN_BLOCKS = 8;  // resident blocks per SM asked of ptxas

struct FwdShared {
  Inst inst[NPIX];
  uint8_t keep[NPIX];  // footprint_warps' mask of each instance
};

// The pieces of the loop that the profiling tool's variants remove, one
// each (composite_fwd_variant_launch); KEEP_ALL is the forward.
enum Drop { KEEP_ALL = 0, NO_EXP_SKIP = 1, NO_CULL = 2, NO_WALK = 3 };

// One pixel's visit of the instance at shared address `in`, in the plain
// loop's arithmetic; returns true where the instance ends the pixel.
template <bool EXP_SKIP>
__device__ __forceinline__ bool visit(unsigned in, float px, float py,
                                      float& T, float (&part)[4]) {
  const float4 geo = lds4(in);  // mx my ca cb
  const float4 opa = lds4(in + 16);  // cc p_min o
  const float dx = __fsub_rn(px, geo.x);
  const float dy = __fsub_rn(py, geo.y);
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(geo.z, dx), dx),
                            __fmul_rn(__fmul_rn(opa.x, dy), dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, q),
                                __fmul_rn(__fmul_rn(geo.w, dx), dy));
  if (power > 0.0f || (EXP_SKIP && power < opa.y)) return false;
  const float alpha = fminf(ALPHA_MAX, __fmul_rn(opa.z, expf(power)));
  if (alpha < ALPHA_MIN) return false;
  const float test_T = __fmul_rn(T, __fsub_rn(1.0f, alpha));
  if (test_T < T_EPS) return true;
  const float w = __fmul_rn(alpha, T);
  const float4 col = lds4(in + 32);
  part[0] = fmaf(col.x, w, part[0]);
  part[1] = fmaf(col.y, w, part[1]);
  part[2] = fmaf(col.z, w, part[2]);
  part[3] = fmaf(col.w, w, part[3]);
  T = test_T;
  return false;
}

template <bool EXIT, int DROP = KEEP_ALL>
__global__ void __launch_bounds__(NPIX, MIN_BLOCKS)
composite_fwd_kernel(const float* __restrict__ rows, int64_t row_stride,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const int* __restrict__ tile_order, int tiles_x,
                     float* __restrict__ out_color,
                     float* __restrict__ out_t) {
  __shared__ FwdShared sm;

  const int tile = tile_order[blockIdx.x];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int WX = TILE_W / WARP_W;
  const int lx = (warp % WX) * WARP_W + lane % WARP_W;
  const int ly = (warp / WX) * WARP_H + lane / WARP_W;
  const float x0 = (float)((tile % tiles_x) * TILE_W);
  const float y0 = (float)((tile / tiles_x) * TILE_H);
  const float px = x0 + (float)lx;
  const float py = y0 + (float)ly;
  const int64_t start = tile_start[tile];
  const int count = tile_count[tile];
  const unsigned inst_addr = smem_addr(sm.inst);

  float T = 1.0f;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int done = 0;

  for (int base = 0; base < count; base += NPIX) {
    // Barrier before the batch overwrites shared memory, and the block
    // exit once every pixel is done.
    if (EXIT) {
      if (__syncthreads_count(done) == NPIX) break;
    } else {
      __syncthreads();
    }
    const int n = min(NPIX, count - base);
    unsigned keep = 0;
    if (tid < n) {
      const float* src = rows + start + base + tid;
      float f[NFEAT];
#pragma unroll
      for (int k = 0; k < NFEAT; ++k) f[k] = src[k * row_stride];
      const float p_min = p_min_of(f[5]);
      keep = DROP == NO_CULL
                 ? (1u << NWARP) - 1u
                 : footprint_warps<WARP_W, WARP_H>(f[0], f[1], f[2], f[3],
                                                   f[4], p_min, x0, y0);
      Inst& in = sm.inst[tid];
      in.geo = make_float4(f[0], f[1], f[2], f[3]);
      in.opa = make_float4(f[4], p_min, f[5], 0.0f);
      in.col = make_float4(f[6], f[7], f[8], f[9]);
    }
    sm.keep[tid] = (uint8_t)keep;
    __syncthreads();

    // This warp's instances of the batch, 32 at a time, ascending; the
    // warp stops at the first word after its 32 pixels are done.
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int g = 0; g < n; g += 32) {
      if (__all_sync(ALL_LANES, done)) break;
      if constexpr (DROP == NO_WALK) {
        // a step for every instance, and the test of its bit in it
        for (int j = g; j < min(g + 32, n); ++j) {
          if (!(sm.keep[j] >> warp & 1u)) continue;
          if (!done)
            done = visit<true>(inst_addr + (unsigned)j * (unsigned)sizeof(Inst),
                               px, py, T, part);
        }
      } else {
        unsigned bits =
            __ballot_sync(ALL_LANES, sm.keep[g + lane] >> warp & 1u);
        while (bits) {
          const int j = g + __ffs(bits) - 1;
          bits &= bits - 1;
          if (!done)
            done = visit<DROP != NO_EXP_SKIP>(
                inst_addr + (unsigned)j * (unsigned)sizeof(Inst), px, py, T,
                part);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] += part[c];
  }

  const int pix = ly * TILE_W + lx;
  float* color = out_color + (int64_t)tile * 4 * NPIX;
#pragma unroll
  for (int c = 0; c < 4; ++c) color[c * NPIX + pix] = acc[c];
  out_t[(int64_t)tile * NPIX + pix] = T;
}

template <bool EXIT, int DROP = KEEP_ALL>
int launch(const void* rows, int64_t row_stride, const void* tile_start,
           const void* tile_count, const void* tile_order, int tiles_x,
           int num_tiles, void* out_color, void* out_t, void* stream) {
  if (num_tiles > 0) {
    composite_fwd_kernel<EXIT, DROP><<<num_tiles, NPIX, 0,
                                       (cudaStream_t)stream>>>(
        (const float*)rows, row_stride, (const int*)tile_start,
        (const int*)tile_count, (const int*)tile_order, tiles_x,
        (float*)out_color, (float*)out_t);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// rows: (F >= 10, row_stride) float32, feature-major; tile_start,
// tile_count and tile_order (the tiles in launch order, a permutation):
// (num_tiles,) int32; out_color: (num_tiles, 4, 256) float32; out_t:
// (num_tiles, 256) float32. Launches on `stream`; returns the cudaError_t
// of the launch.
extern "C" int composite_fwd_launch(const void* rows, int64_t row_stride,
                                    const void* tile_start,
                                    const void* tile_count,
                                    const void* tile_order, int tiles_x,
                                    int num_tiles, void* out_color,
                                    void* out_t, void* stream) {
  return launch<true>(rows, row_stride, tile_start, tile_count, tile_order,
                      tiles_x, num_tiles, out_color, out_t, stream);
}

// The same kernel without the block exit (fori); arguments as above.
extern "C" int composite_fwd_fori_launch(const void* rows, int64_t row_stride,
                                         const void* tile_start,
                                         const void* tile_count,
                                         const void* tile_order, int tiles_x,
                                         int num_tiles, void* out_color,
                                         void* out_t, void* stream) {
  return launch<false>(rows, row_stride, tile_start, tile_count, tile_order,
                       tiles_x, num_tiles, out_color, out_t, stream);
}

// The forward kernel's resources (kernel_info in composite_common.cuh).
extern "C" int composite_fwd_info(int* out) {
  return kernel_info(composite_fwd_kernel<true>, out);
}

// The forward kernel without one piece of its loop, for the profiling
// tool's timings: variant 1 without the exp skip, 2 without the footprint
// cull (every warp's bit set), 3 with a step and a bit test for every batch
// instance in place of the walk over ballot words; each computes the
// forward's function bit for bit. Other arguments as composite_fwd_launch;
// cudaErrorInvalidValue for an unknown variant.
extern "C" int composite_fwd_variant_launch(
    int variant, const void* rows, int64_t row_stride, const void* tile_start,
    const void* tile_count, const void* tile_order, int tiles_x,
    int num_tiles, void* out_color, void* out_t, void* stream) {
  switch (variant) {
    case NO_EXP_SKIP:
      return launch<true, NO_EXP_SKIP>(rows, row_stride, tile_start,
                                       tile_count, tile_order, tiles_x,
                                       num_tiles, out_color, out_t, stream);
    case NO_CULL:
      return launch<true, NO_CULL>(rows, row_stride, tile_start, tile_count,
                                   tile_order, tiles_x, num_tiles, out_color,
                                   out_t, stream);
    case NO_WALK:
      return launch<true, NO_WALK>(rows, row_stride, tile_start, tile_count,
                                   tile_order, tiles_x, num_tiles, out_color,
                                   out_t, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The resources of variant `variant`'s kernel, as composite_fwd_info.
extern "C" int composite_fwd_variant_info(int variant, int* out) {
  switch (variant) {
    case NO_EXP_SKIP:
      return kernel_info(composite_fwd_kernel<true, NO_EXP_SKIP>, out);
    case NO_CULL: return kernel_info(composite_fwd_kernel<true, NO_CULL>, out);
    case NO_WALK: return kernel_info(composite_fwd_kernel<true, NO_WALK>, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

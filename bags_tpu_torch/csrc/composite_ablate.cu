// Ablation variants of the forward compositing loop, for timing only;
// Hopper (sm_90a).
//
// composite_ablate_launch replaces the TPU kernel
// tools/kernablate.py::main's make_kernel(mode) `kern`. Its four modes are
// deliberately NOT the compositing function: each removes one piece of the
// per-chunk work so that the differences between their times price that
// piece. Per tile, the block walks the tile's 128-slot chunks aligned to
// global slot multiples of 128 (as the TPU's DMA windows are), from
// floor(start / 128) to floor((start + count - 1) / 128), and each pixel
// walks the chunk's lanes inside [start, start + count) in order. With
// `power` as in composite_fwd.cu, ok = alpha >= 1/255 && power <= 0, and
// a = alpha where ok:
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
// Which loop the modes price. The loop is the forward kernel's
// (composite_fwd.cu) with the forward's function taken out: the same
// instance layout (three float4, Inst, read by lds4 through shared addresses
// taken once), the same 8x4-pixel warps and the same per-pair arithmetic
// (__fmul_rn, __fadd_rn, expf, log1pf, fmaf for the colour, no fast math),
// but every pair of the tile visited: no exp skip, no footprint cull, no
// walk over kept instances, no exit, tiles in index order. Those four
// pieces of the forward are priced instead by composite_fwd.cu's variants
// (tools/kernablate.py: `real`), which compute the forward's function.
// So here DMA_ONLY prices the copy of the rows into shared memory and the
// walk over every pair with its power (what every later piece runs on),
// NO_TRANSCENDENTAL adds the alpha test, NO_SCAN the exp and log1p of the
// accepted pairs, FULL the running sum in place of NO_SCAN's per-pair
// product.
//
// What bounds them on this card: each instance's 10 features are read once
// per tile (40 B) and each pixel writes 20 B, while every pixel visits every
// instance of its tile at 12-29 FP32 operations a visit: operations, several
// times over the bytes. Counted operations are adds and multiplies (one
// each) and the fused colour sums (two each) over 67 TFLOP/s, which counts
// every lane's fused multiply-add as two: a loop of separate adds and
// multiplies, as this one is by design, can reach about half that rate.
//
// Design: one 256-thread block per 16x16 tile, one thread per pixel, each
// warp an 8x4 block of pixels (WARP_W x WARP_H: a compact warp covers fewer
// instance footprints partially, so in NO_SCAN and FULL fewer of its steps
// run the accepted branch for some lanes only). The chunks go through a
// ring of three 128-instance stages in shared memory: while the block
// composites chunk i, the copies of chunk i + 2 are in flight (cp.async,
// the counterpart of the TPU tool's double-buffered make_async_copy), and
// one __syncthreads per chunk both publishes chunk i and frees the stage of
// chunk i - 1. Each thread copies five of one slot's ten rows as 4-byte
// cp.async straight into that slot's Inst (threads 0-127 rows 0-4, threads
// 128-255 rows 5-9, coalesced along each row); a 4-byte copy needs only
// 4-byte alignment, which any row offset has, while a bulk or TMA copy of a
// row would need 16 (row_stride * 4 of a gathered table need not be a
// multiple of 16) and could not scatter a row into the Inst layout.
// Indices inside a tile are int32. MIN_BLOCKS = 5 resident blocks per SM
// asked of ptxas (44-47 registers; no_scan gets 6 blocks at 40) was the
// fastest of 8, 6, 5 and 4 over the four modes on the card (PERF.md).

#include "composite_common.cuh"

namespace {

constexpr int CHUNK = 128;  // slots per ablation chunk (the TPU's lane width)
constexpr int NSTAGE = 3;   // chunks in the shared-memory ring
constexpr int WARP_W = 8;   // pixels of a warp: 8 columns x 4 rows
constexpr int WARP_H = 32 / WARP_W;
constexpr int MIN_BLOCKS = 5;  // resident blocks per SM asked of ptxas

enum Mode { DMA_ONLY = 0, NO_TRANSCENDENTAL = 1, NO_SCAN = 2, FULL = 3 };

__device__ __forceinline__ void cp_async4(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Start the copies of this thread's share of the chunk at global slot
// `base` into the stage at shared address `stage`: slot base + (tid % 128),
// if it lies in [start, end), rows 5 (tid / 128) to 5 (tid / 128) + 4, at
// their places in Inst: (mx my ca cb) (cc - o -) (r g b depth).
__device__ __forceinline__ void load_chunk(const float* rows, int64_t row_stride,
                                           int base, int start, int end,
                                           unsigned stage, int tid) {
  const int lane = tid & (CHUNK - 1);
  const int slot = base + lane;
  if (slot < start || slot >= end) return;
  const int f0 = (tid >> 7) * 5;
  const float* src = rows + (int64_t)f0 * row_stride + slot;
  const unsigned dst = stage + (unsigned)lane * (unsigned)sizeof(Inst);
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int f = f0 + k;
    cp_async4(dst + 4u * (unsigned)(f + (f >= 5) + (f >= 6)),
              src + k * row_stride);
  }
}

// One pixel's visit of the instance at shared address `in` in mode MODE.
template <int MODE>
__device__ __forceinline__ void visit(unsigned in, float px, float py,
                                      float& run, float& w_sum,
                                      float (&part)[4]) {
  const float4 geo = lds4(in);       // mx my ca cb
  const float4 opa = lds4(in + 16);  // cc - o -
  const float dx = __fsub_rn(px, geo.x);
  const float dy = __fsub_rn(py, geo.y);
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(geo.z, dx), dx),
                            __fmul_rn(__fmul_rn(opa.x, dy), dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, q),
                                __fmul_rn(__fmul_rn(geo.w, dx), dy));
  float w;
  if constexpr (MODE == DMA_ONLY) {
    w = power;
  } else {
    if (!(power <= 0.0f)) return;
    float alpha;
    if constexpr (MODE == NO_TRANSCENDENTAL) {
      alpha = fminf(ALPHA_MAX, __fmul_rn(opa.z, power));
    } else {
      alpha = fminf(ALPHA_MAX, __fmul_rn(opa.z, expf(power)));
    }
    if (!(alpha >= ALPHA_MIN)) return;
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
  const float4 col = lds4(in + 32);  // r g b depth
  part[0] = fmaf(col.x, w, part[0]);
  part[1] = fmaf(col.y, w, part[1]);
  part[2] = fmaf(col.z, w, part[2]);
  part[3] = fmaf(col.w, w, part[3]);
  w_sum = __fadd_rn(w_sum, w);
}

template <int MODE>
__global__ void __launch_bounds__(NPIX, MIN_BLOCKS)
composite_ablate_kernel(const float* __restrict__ rows, int64_t row_stride,
                        const int* __restrict__ tile_start,
                        const int* __restrict__ tile_count, int tiles_x,
                        float* __restrict__ out_color,
                        float* __restrict__ out_t) {
  __shared__ Inst ring[NSTAGE][CHUNK];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int WX = TILE_W / WARP_W;
  const int lx = (warp % WX) * WARP_W + lane % WARP_W;
  const int ly = (warp / WX) * WARP_H + lane / WARP_W;
  const float px = (float)((tile % tiles_x) * TILE_W + lx);
  const float py = (float)((tile / tiles_x) * TILE_H + ly);
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  const int end = start + count;
  const int first = start / CHUNK;
  const int n_chunks = count > 0 ? (end - 1) / CHUNK - first + 1 : 0;
  const unsigned stage0 = smem_addr(ring);
  constexpr unsigned STAGE_BYTES = CHUNK * sizeof(Inst);

  // The first two chunks in flight; one copy group per chunk, empty past
  // the last, so that wait_group<1> always leaves just the next one open.
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {
    if (i < n_chunks)
      load_chunk(rows, row_stride, (first + i) * CHUNK, start, end,
                 stage0 + i * STAGE_BYTES, tid);
    cp_async_commit();
  }

  float t_out = 1.0f;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int s = 0;  // stage of chunk i
  for (int i = 0; i < n_chunks; ++i) {
    cp_async_wait<NSTAGE - 2>();
    // Chunk i is in shared memory for every thread, and every thread is
    // done with chunk i - 1, whose stage the copies of chunk i + 2 take.
    __syncthreads();
    const int s_next = s == 0 ? NSTAGE - 1 : s - 1;
    if (i + NSTAGE - 1 < n_chunks)
      load_chunk(rows, row_stride, (first + i + NSTAGE - 1) * CHUNK, start,
                 end, stage0 + s_next * STAGE_BYTES, tid);
    cp_async_commit();

    const int base = (first + i) * CHUNK;
    const int lo = max(start - base, 0);
    const int hi = min(end - base, CHUNK);
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float w_sum = 0.0f;
    float run = 0.0f;  // S (NO_TRANSCENDENTAL) or L (FULL), per chunk
    const unsigned first_in = stage0 + s * STAGE_BYTES;
    for (int j = lo; j < hi; ++j)
      visit<MODE>(first_in + (unsigned)j * (unsigned)sizeof(Inst), px, py, run,
                  w_sum, part);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] += part[k];
    t_out = __fsub_rn(t_out, __fmul_rn(0.0f, w_sum));
    s = s == NSTAGE - 1 ? 0 : s + 1;
  }

  const int pix = ly * TILE_W + lx;
  float* color = out_color + (int64_t)tile * 4 * NPIX;
#pragma unroll
  for (int k = 0; k < 4; ++k) color[k * NPIX + pix] = acc[k];
  out_t[(int64_t)tile * NPIX + pix] = t_out;
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

// The resources of mode `mode`'s kernel (kernel_info in
// composite_common.cuh); cudaErrorInvalidValue for an unknown mode.
extern "C" int composite_ablate_info(int mode, int* out) {
  switch (mode) {
    case DMA_ONLY: return kernel_info(composite_ablate_kernel<DMA_ONLY>, out);
    case NO_TRANSCENDENTAL:
      return kernel_info(composite_ablate_kernel<NO_TRANSCENDENTAL>, out);
    case NO_SCAN: return kernel_info(composite_ablate_kernel<NO_SCAN>, out);
    case FULL: return kernel_info(composite_ablate_kernel<FULL>, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// What the compositing kernels share (sm_90a): the tile and the test
// constants, the instance layout in shared memory, shared-memory access at
// 32-bit addresses, the exp skip's p_min and the footprint cull, with the
// proofs that the two skips change no decision of the compositing.
// Included by composite_fwd.cu, composite_bwd.cu and composite_ablate.cu;
// raster/composite.py hashes this header into each kernel's build tag.
//
// Per pixel, front to back over the tile's depth-sorted instances:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy       rejected if power > 0
//   alpha = min(0.99, o exp(power))                 rejected if alpha < 1/255
// formed with __fsub_rn / __fmul_rn / __fadd_rn in this order and expf (no
// fast math), as the plain version forms them.
//
// The exp skip. The exact test passes a pair when RN(o expf(power)) >=
// A = 1/255 (float). Per instance p_min = RN(logf(RN(A / o)) - delta) with
// delta = 1e-3. If power < p_min: e^power < e^p_min <= (A / o)
// e^(2^-24 + 2^-17 + 2^-18 - delta), the three terms bounding the rounding
// of A / o, logf's 1 ulp and the subtraction's half ulp (|logf| < 128 over
// the float range, where an ulp is at most 2^-17); expf's 2 ulp add a factor
// (1 + 2^-22); so o expf(power) < A (1 - delta + 2e-5) < A (1 - 9e-4), and
// its product rounds below A: the pair fails, as the exact test would have
// decided. delta is about 60 times the rounding. o = 0 (or a subnormal o
// whose A / o overflows) gives p_min = +inf and a skip, which agrees: o G <=
// o < A. A NaN p_min (o < 0 or NaN) skips nothing, since !(power < NaN),
// and neither does a NaN power.
//
// The footprint cull. power = -Q / 2 with Q = a dx^2 + 2 b dx dy + c dy^2.
// Where the conic is positive definite with det = ac - b^2 > 1e-3 ac,
// rho = |b| / sqrt(ac) has 1 - rho > 5e-4, and with S = a dx^2 + c dy^2,
// |b dx dy| <= rho S / 2 and Q >= (1 - rho) S. The float power (two
// products and a sum of non-negative terms, two products, one difference)
// errs by at most 2.5 u S + u |power| (u = 2^-24), so power <= -Q / 2 +
// 2.5 u Q / (1 - rho) + u Q / 2 < -0.4997 Q. Every pixel outside the
// ellipse Q <= K = 2.04 (-p_min) therefore has power < -1.019 (-p_min) <
// p_min: the exp skip would drop it. The ellipse lies inside |dx| <=
// sqrt(K c / det), |dy| <= sqrt(K a / det); the computed extents err by
// about 1e-4 relative (det's rounding over 1e-3 ac) and the comparisons by
// half an ulp of a pixel coordinate, both inside the 1e-3 relative and 1e-3
// pixel widening. The bound on power needs it finite: with a, c < 1e18 and
// |mx|, |my| < 1e9 (and pixel coordinates below 2^24) no product of the
// power overflows; any other instance, and any NaN, keeps every warp. So
// the cull drops only pairs the exp skip drops, and those fail the exact
// test.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 16;
constexpr int TILE_H = 16;
constexpr int NPIX = TILE_W * TILE_H;  // one thread per pixel
constexpr int NWARP = NPIX / 32;
constexpr int NFEAT = 10;  // mx my ca cb cc o r g b depth
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;
constexpr float P_MIN_MARGIN = 1e-3f;  // delta of the exp skip
constexpr unsigned ALL_LANES = 0xffffffffu;

// One instance in shared memory: (mx, my, ca, cb), (cc, p_min, o, spare),
// (r, g, b, depth), read as three 16-byte broadcasts (the backward keeps
// its footprint mask in the spare word).
struct __align__(16) Inst {
  float4 geo;
  float4 opa;
  float4 col;
};

// Below p_min an instance's pair fails the alpha test for certain (the exp
// skip, above).
__device__ __forceinline__ float p_min_of(float o) {
  return logf(ALPHA_MIN / o) - P_MIN_MARGIN;
}

// The warps of the tile at (x0, y0) that can hold a pixel whose power
// reaches p_min, warps being WW x WH pixel blocks in row-major order over
// the tile (bit w: columns x0 + (w % (16 / WW)) WW onward, rows y0 +
// (w / (16 / WW)) WH onward): those that meet the bounding box of the
// ellipse Q <= K, with Q = -2 power and K = 2.04 (-p_min), widened by 1e-3
// relative and 1e-3 pixels (see the head of the file). A conic that is not
// clearly positive definite, an instance whose power might overflow, or a
// NaN keeps every warp.
template <int WW, int WH>
__device__ __forceinline__ unsigned footprint_warps(float mx, float my,
                                                    float a, float b, float c,
                                                    float p_min, float x0,
                                                    float y0) {
  static_assert(WW * WH == 32 && TILE_W % WW == 0 && TILE_H % WH == 0,
                "a warp is a WW x WH block of the tile");
  constexpr int WX = TILE_W / WW;
  if (p_min > 0.0f) return 0u;  // every pair is below p_min
  const float det = a * c - b * b;
  if (!(a > 0.0f && c > 0.0f && det > 1e-3f * a * c && a < 1e18f &&
        c < 1e18f && fabsf(mx) < 1e9f && fabsf(my) < 1e9f))
    return (1u << NWARP) - 1u;
  const float k = -2.04f * p_min;
  const float ex = sqrtf(k * c / det) * 1.001f + 1e-3f;
  const float ey = sqrtf(k * a / det) * 1.001f + 1e-3f;
  unsigned warps = 0;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) {
    const float wx = x0 + (float)((w % WX) * WW);
    const float wy = y0 + (float)((w / WX) * WH);
    if (!(mx + ex < wx || mx - ex > wx + (float)(WW - 1) || my + ey < wy ||
          my - ey > wy + (float)(WH - 1)))
      warps |= 1u << w;
  }
  return warps;
}

// Shared-memory loads and stores at a 32-bit address (as
// __cvta_generic_to_shared gives it). Taking the addresses once keeps the
// shared window's base out of the instance loops.
__device__ __forceinline__ float4 lds4(unsigned addr) {
  float4 x;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(addr));
  return x;
}

__device__ __forceinline__ void sts(unsigned addr, float x) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(addr), "f"(x) : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// A kernel's resources on the current device: out[0] resident blocks per
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor at 256 threads), out[1]
// registers per thread, out[2] static shared memory per block (bytes),
// out[3] local memory per thread (bytes; spills). Returns the cudaError_t.
template <typename Kernel>
int kernel_info(Kernel kernel, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, NPIX, 0);
  out[1] = attr.numRegs;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = (int)attr.localSizeBytes;
  return (int)err;
}

}  // namespace

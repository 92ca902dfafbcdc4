// Projection + SH for Hopper (sm_90a): the EWA projection of every Gaussian
// slot to screen space and its SH colour, one pass a slot forward, and its
// backward, one pass a slot with the camera's gradient reduced in the kernel.
//
// Replaces no TPU kernel: the JAX package writes this layer as jnp
// operations (bags_tpu/core/projection.py::_project_gaussians_impl and
// core/sh.py) and leaves them to XLA, which fuses them. Eager PyTorch fuses
// nothing, so the port's plain version (core/projection.py::project_plain)
// makes 465 launches a view and 1,400 a training step's forward and
// backward, each over all slots (counted on an H100); this file is that
// fusion written by hand, as the 3DGS reference's rasterizer does
// (preprocessCUDA, computeColorFromSH and their backward).
//
// What bounds it on this card: bytes. The forward reads 236 B a slot at SH
// 3 (xyz 12, scales 12, quats 16, opacity 4, SH 192) and writes 52 B (10
// floats and 3 int32): 288 B x 4,194,304 slots = 1.21 GB, 0.36 ms at 3.35
// TB/s. The backward reads the inputs and the 10 output gradients and
// writes 236 B of input gradients: 512 B a slot, 2.15 GB, 0.64 ms. Its
// arithmetic (a few hundred FP32 operations a slot) is far under the
// card's 67 TFLOP/s for that time.
//
// Design:
// - one thread a slot, 128 threads a block, templated on the active SH
//   degree (0-4); everything between the loads and the stores stays in
//   registers;
// - the camera is one vector of 24 floats (core/projection.py::
//   camera_vector, built by PyTorch so that autograd carries its gradient
//   on), read into shared memory once a block;
// - a slot's SH row is K x 3 floats (192 B at K = 16) at a stride of K x 3:
//   one thread's row read by that thread alone would coalesce poorly, so
//   each block copies its rows' active coefficients into shared memory with
//   16-byte loads over the block's contiguous range, each row at an odd
//   stride (no bank conflict when each thread reads its own), and the
//   backward stages its SH gradients the same way before 16-byte stores;
// - the forward follows core/projection.py's operation order, and this
//   file is compiled with -fmad=false (raster/composite.py SOURCE_FLAGS), so
//   every product and sum rounds on its own as PyTorch's separate kernels
//   round them: radius, rect_rx and rect_ry then equal the plain version's
//   on the card;
// - the backward saves nothing: it recomputes the forward from the inputs
//   and the camera vector, takes the gradients of the 10 float outputs (a
//   null pointer where autograd has none), writes the input gradients (a
//   null output pointer skips one; coefficients above the active degree
//   get zero) and follows autograd's subgradients of the plain version
//   (clamp passes at its bound, minimum and maximum halve a tie, where
//   picks a side, the opacity only where the slot is valid);
// - the camera's gradient: each thread's 24 terms are summed over its warp
//   by shuffles and over the block's 4 warps in a fixed order into one row
//   of a (blocks, 24) buffer; a second kernel sums each column in double in
//   a fixed order. No atomics: the camera gradient repeats bit for bit.
//
// core/projection.py::project_backward_plain is this backward's arithmetic
// in PyTorch, which the CPU tests hold against autograd.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;
constexpr int WARPS = BLOCK / 32;
constexpr int CAM_SIZE = 24;
constexpr int NFLOAT = 10;
constexpr int MAX_K = 25;
constexpr int REDUCE_THREADS = 256;

// The camera vector's layout (core/projection.py CAM_*).
constexpr int CAM_R = 0, CAM_T = 9, CAM_P00 = 12, CAM_P11 = 13, CAM_FX = 14,
              CAM_FY = 15, CAM_LIMX = 16, CAM_LIMY = 17, CAM_CENTER = 18,
              CAM_SHIFT = 21;
// The output rows (core/projection.py FLOAT_FIELDS).
enum { X2D, Y2D, DEPTH, CONIC_A, CONIC_B, CONIC_C, COL_R, COL_G, COL_B,
       OPACITY };

// core/sh.py's constants as PyTorch rounds a Python float to float32.
constexpr float C0 = (float)0.28209479177387814;
constexpr float C1 = (float)0.4886025119029199;
constexpr float NC1 = (float)-0.4886025119029199;
__device__ constexpr float C2[5] = {(float)1.0925484305920792, (float)-1.0925484305920792,
                         (float)0.31539156525252005, (float)-1.0925484305920792,
                         (float)0.5462742152960396};
__device__ constexpr float C3[7] = {(float)-0.5900435899266435, (float)2.890611442640554,
                         (float)-0.4570457994644658, (float)0.3731763325901154,
                         (float)-0.4570457994644658, (float)1.445305721320277,
                         (float)-0.5900435899266435};
__device__ constexpr float C4[9] = {(float)2.5033429417967046, (float)-1.7701307697799304,
                         (float)0.9461746957575601, (float)-0.6690465435572892,
                         (float)0.10578554691520431, (float)-0.6690465435572892,
                         (float)0.47308734787878004, (float)-1.7701307697799304,
                         (float)0.6258357354491761};

// PyTorch's clamp(min=), maximum and minimum: a NaN operand propagates.
__device__ __forceinline__ float clamp_min(float x, float m) {
  return x < m ? m : x;
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// The share of a gradient that minimum(a, b) / maximum(a, b) pass to a.
__device__ __forceinline__ float min_share(float a, float b) {
  return a < b ? 1.0f : (a == b ? 0.5f : 0.0f);
}
__device__ __forceinline__ float max_share(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

struct Inputs {
  const float* xyz;
  const float* scales;
  const float* quats;
  const float* opacity;
  const float* sh;
  const float* cam;
  int K;          // SH coefficients a row
  int has_shift;
  int width, height;
  int64_t n;
};

struct Grads {
  const float* g[NFLOAT];  // null: no gradient
};

struct Outs {
  float* d_xyz;
  float* d_scales;
  float* d_quats;
  float* d_opacity;
  float* d_sh;
};

// Everything the forward computes for one slot, in core/projection.py's
// names (the backward reads the intermediates).
template <int DEG>
struct Slot {
  static constexpr int NK = (DEG + 1) * (DEG + 1);
  float p[3], sc[3], q[4], o;
  float depth, inv_d, tx, ty, tz, clip_x, clip_y, w_clip;
  float qn[4], norm, nc, qr[3][3], m[3][3], s[6];
  float tzc, vx, vy, mx, my, txz, tyz, inv_z, j00, j02, j11, j12;
  float a[3], b[3], sa[3], sb[3], c00, c01, c11, det, inv_det;
  bool valid;
  float d[3], sq, inv_n, u[3], basis[NK], pre[3];
  float out[NFLOAT];
  int radius, rect_rx, rect_ry;
};

template <int DEG>
__device__ __forceinline__ void sh_basis(float x, float y, float z,
                                         float* out) {
  out[0] = C0 * 1.0f;
  if constexpr (DEG >= 1) {
    out[1] = NC1 * y;
    out[2] = C1 * z;
    out[3] = NC1 * x;
  }
  if constexpr (DEG >= 2) {
    float xx = x * x, yy = y * y, zz = z * z;
    float xy = x * y, yz = y * z, xz = x * z;
    out[4] = C2[0] * xy;
    out[5] = C2[1] * yz;
    out[6] = C2[2] * (2.0f * zz - xx - yy);
    out[7] = C2[3] * xz;
    out[8] = C2[4] * (xx - yy);
    if constexpr (DEG >= 3) {
      out[9] = C3[0] * y * (3.0f * xx - yy);
      out[10] = C3[1] * xy * z;
      out[11] = C3[2] * y * (4.0f * zz - xx - yy);
      out[12] = C3[3] * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      out[13] = C3[4] * x * (4.0f * zz - xx - yy);
      out[14] = C3[5] * z * (xx - yy);
      out[15] = C3[6] * x * (xx - 3.0f * yy);
    }
    if constexpr (DEG >= 4) {
      out[16] = C4[0] * xy * (xx - yy);
      out[17] = C4[1] * yz * (3.0f * xx - yy);
      out[18] = C4[2] * xy * (7.0f * zz - 1.0f);
      out[19] = C4[3] * yz * (7.0f * zz - 3.0f);
      out[20] = C4[4] * (zz * (35.0f * zz - 30.0f) + 3.0f);
      out[21] = C4[5] * xz * (7.0f * zz - 3.0f);
      out[22] = C4[6] * (xx - yy) * (7.0f * zz - 1.0f);
      out[23] = C4[7] * xz * (xx - 3.0f * yy);
      out[24] = C4[8] * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
    }
  }
}

// d(sum g * basis) / d(x, y, z): core/sh.py::sh_basis_vjp.
template <int DEG>
__device__ __forceinline__ void sh_basis_vjp(float x, float y, float z,
                                             const float* g, float* d) {
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if constexpr (DEG >= 1) {
    dy -= C1 * g[1];
    dz += C1 * g[2];
    dx -= C1 * g[3];
  }
  if constexpr (DEG >= 2) {
    float xx = x * x, yy = y * y, zz = z * z;
    dx += C2[0] * y * g[4];
    dy += C2[0] * x * g[4];
    dy += C2[1] * z * g[5];
    dz += C2[1] * y * g[5];
    dx -= 2.0f * C2[2] * x * g[6];
    dy -= 2.0f * C2[2] * y * g[6];
    dz += 4.0f * C2[2] * z * g[6];
    dx += C2[3] * z * g[7];
    dz += C2[3] * x * g[7];
    dx += 2.0f * C2[4] * x * g[8];
    dy -= 2.0f * C2[4] * y * g[8];
    if constexpr (DEG >= 3) {
      dx += C3[0] * 6.0f * x * y * g[9];
      dy += C3[0] * 3.0f * (xx - yy) * g[9];
      dx += C3[1] * y * z * g[10];
      dy += C3[1] * x * z * g[10];
      dz += C3[1] * x * y * g[10];
      dx -= C3[2] * 2.0f * x * y * g[11];
      dy += C3[2] * (4.0f * zz - xx - 3.0f * yy) * g[11];
      dz += C3[2] * 8.0f * y * z * g[11];
      dx -= C3[3] * 6.0f * x * z * g[12];
      dy -= C3[3] * 6.0f * y * z * g[12];
      dz += C3[3] * (6.0f * zz - 3.0f * xx - 3.0f * yy) * g[12];
      dx += C3[4] * (4.0f * zz - 3.0f * xx - yy) * g[13];
      dy -= C3[4] * 2.0f * x * y * g[13];
      dz += C3[4] * 8.0f * x * z * g[13];
      dx += C3[5] * 2.0f * x * z * g[14];
      dy -= C3[5] * 2.0f * y * z * g[14];
      dz += C3[5] * (xx - yy) * g[14];
      dx += C3[6] * 3.0f * (xx - yy) * g[15];
      dy -= C3[6] * 6.0f * x * y * g[15];
    }
    if constexpr (DEG >= 4) {
      dx += C4[0] * y * (3.0f * xx - yy) * g[16];
      dy += C4[0] * x * (xx - 3.0f * yy) * g[16];
      dx += C4[1] * 6.0f * x * y * z * g[17];
      dy += C4[1] * 3.0f * z * (xx - yy) * g[17];
      dz += C4[1] * y * (3.0f * xx - yy) * g[17];
      dx += C4[2] * y * (7.0f * zz - 1.0f) * g[18];
      dy += C4[2] * x * (7.0f * zz - 1.0f) * g[18];
      dz += C4[2] * 14.0f * x * y * z * g[18];
      dy += C4[3] * z * (7.0f * zz - 3.0f) * g[19];
      dz += C4[3] * y * (21.0f * zz - 3.0f) * g[19];
      dz += C4[4] * z * (140.0f * zz - 60.0f) * g[20];
      dx += C4[5] * z * (7.0f * zz - 3.0f) * g[21];
      dz += C4[5] * x * (21.0f * zz - 3.0f) * g[21];
      dx += C4[6] * 2.0f * x * (7.0f * zz - 1.0f) * g[22];
      dy -= C4[6] * 2.0f * y * (7.0f * zz - 1.0f) * g[22];
      dz += C4[6] * 14.0f * z * (xx - yy) * g[22];
      dx += C4[7] * 3.0f * z * (xx - yy) * g[23];
      dy -= C4[7] * 6.0f * x * y * z * g[23];
      dz += C4[7] * x * (xx - 3.0f * yy) * g[23];
      dx += C4[8] * 4.0f * x * (xx - 3.0f * yy) * g[24];
      dy += C4[8] * 4.0f * y * (yy - 3.0f * xx) * g[24];
    }
  }
  d[0] = dx;
  d[1] = dy;
  d[2] = dz;
}

// The forward of slot i, in core/projection.py::_forward_terms's order.
// `row`: the slot's active SH coefficients in shared memory, (k, 3).
template <int DEG>
__device__ __forceinline__ void project_slot(const Inputs& in, const float* c,
                                             int64_t i, const float* row,
                                             Slot<DEG>& f) {
  #pragma unroll
  for (int j = 0; j < 3; ++j) {
    f.p[j] = in.xyz[3 * i + j];
    f.sc[j] = in.scales[3 * i + j];
  }
  const float4 q4 = reinterpret_cast<const float4*>(in.quats)[i];
  f.q[0] = q4.x; f.q[1] = q4.y; f.q[2] = q4.z; f.q[3] = q4.w;
  f.o = in.opacity[i];
  const float* r = c + CAM_R;
  const float wx = f.p[0], wy = f.p[1], wz = f.p[2];

  // view space
  float tx = r[0] * wx + r[1] * wy + r[2] * wz + c[CAM_T];
  float ty = r[3] * wx + r[4] * wy + r[5] * wz + c[CAM_T + 1];
  f.depth = r[6] * wx + r[7] * wy + r[8] * wz + c[CAM_T + 2];
  const bool in_front = f.depth > (float)0.2;
  float tz = f.depth;
  f.inv_d = 0.0f;
  if (in.has_shift) {
    f.inv_d = 1.0f / clamp_min(f.depth, (float)1e-6);
    tx = tx + c[CAM_SHIFT] * f.inv_d;
    ty = ty + c[CAM_SHIFT + 1] * f.inv_d;
    tz = tz + c[CAM_SHIFT + 2] * f.inv_d;
  }
  f.tx = tx; f.ty = ty; f.tz = tz;

  // pixel projection
  f.clip_x = c[CAM_P00] * tx;
  f.clip_y = c[CAM_P11] * ty;
  f.w_clip = tz + (float)1e-7;
  f.out[X2D] = ((f.clip_x / f.w_clip + 1.0f) * (float)in.width - 1.0f) * 0.5f;
  f.out[Y2D] = ((f.clip_y / f.w_clip + 1.0f) * (float)in.height - 1.0f) * 0.5f;
  f.out[DEPTH] = f.depth;

  // 3D covariance: rotation of the normalised quaternion, M = R S, Σ = M M^T
  // |q| sums the squares in the order torch.linalg.norm's reduction over
  // 4 lanes does on the card (offsets 2, then 1; checked on an H100)
  f.norm = sqrtf((f.q[0] * f.q[0] + f.q[2] * f.q[2]) +
                 (f.q[1] * f.q[1] + f.q[3] * f.q[3]));
  f.nc = clamp_min(f.norm, (float)1e-8);
  #pragma unroll
  for (int j = 0; j < 4; ++j) f.qn[j] = f.q[j] / f.nc;
  {
    const float w = f.qn[0], x = f.qn[1], y = f.qn[2], z = f.qn[3];
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, xz = x * z, yz = y * z;
    const float wx_ = w * x, wy_ = w * y, wz_ = w * z;
    f.qr[0][0] = 1.0f - 2.0f * (yy + zz);
    f.qr[0][1] = 2.0f * (xy - wz_);
    f.qr[0][2] = 2.0f * (xz + wy_);
    f.qr[1][0] = 2.0f * (xy + wz_);
    f.qr[1][1] = 1.0f - 2.0f * (xx + zz);
    f.qr[1][2] = 2.0f * (yz - wx_);
    f.qr[2][0] = 2.0f * (xz - wy_);
    f.qr[2][1] = 2.0f * (yz + wx_);
    f.qr[2][2] = 1.0f - 2.0f * (xx + yy);
  }
  #pragma unroll
  for (int a = 0; a < 3; ++a)
    #pragma unroll
    for (int k = 0; k < 3; ++k) f.m[a][k] = f.qr[a][k] * f.sc[k];
#define DOT3(u, v) (u[0] * v[0] + u[1] * v[1] + u[2] * v[2])
  f.s[0] = DOT3(f.m[0], f.m[0]);
  f.s[1] = DOT3(f.m[0], f.m[1]);
  f.s[2] = DOT3(f.m[0], f.m[2]);
  f.s[3] = DOT3(f.m[1], f.m[1]);
  f.s[4] = DOT3(f.m[1], f.m[2]);
  f.s[5] = DOT3(f.m[2], f.m[2]);

  // 2D covariance (EWA)
  const float fx = c[CAM_FX], fy = c[CAM_FY];
  const float limx = c[CAM_LIMX], limy = c[CAM_LIMY];
  f.tzc = clamp_min(f.depth, (float)1e-6);
  f.vx = tx / f.tzc;
  f.vy = ty / f.tzc;
  f.mx = tmax(f.vx, -limx);
  f.my = tmax(f.vy, -limy);
  f.txz = tmin(f.mx, limx);
  f.tyz = tmin(f.my, limy);
  f.inv_z = 1.0f / f.tzc;
  f.j00 = fx * f.inv_z;
  f.j02 = -fx * f.txz * f.inv_z;
  f.j11 = fy * f.inv_z;
  f.j12 = -fy * f.tyz * f.inv_z;
  #pragma unroll
  for (int k = 0; k < 3; ++k) {
    f.a[k] = f.j00 * r[k] + f.j02 * r[6 + k];
    f.b[k] = f.j11 * r[3 + k] + f.j12 * r[6 + k];
  }
  const float* s = f.s;
  f.sa[0] = s[0] * f.a[0] + s[1] * f.a[1] + s[2] * f.a[2];
  f.sa[1] = s[1] * f.a[0] + s[3] * f.a[1] + s[4] * f.a[2];
  f.sa[2] = s[2] * f.a[0] + s[4] * f.a[1] + s[5] * f.a[2];
  f.sb[0] = s[0] * f.b[0] + s[1] * f.b[1] + s[2] * f.b[2];
  f.sb[1] = s[1] * f.b[0] + s[3] * f.b[1] + s[4] * f.b[2];
  f.sb[2] = s[2] * f.b[0] + s[4] * f.b[1] + s[5] * f.b[2];
  f.c00 = DOT3(f.a, f.sa) + (float)0.3;
  f.c01 = DOT3(f.b, f.sa);
  f.c11 = DOT3(f.b, f.sb) + (float)0.3;
#undef DOT3
  f.det = f.c00 * f.c11 - f.c01 * f.c01;
  f.inv_det = 1.0f / (f.det > 0.0f ? f.det : 1.0f);
  f.out[CONIC_A] = f.c11 * f.inv_det;
  f.out[CONIC_B] = -f.c01 * f.inv_det;
  f.out[CONIC_C] = f.c00 * f.inv_det;

  // radius & validity
  const float mid = 0.5f * (f.c00 + f.c11);
  const float lam1 = mid + sqrtf(clamp_min(mid * mid - f.det, (float)0.1));
  const float radius_f = ceilf(3.0f * sqrtf(clamp_min(lam1, 0.0f)));
  f.valid = in_front && f.det > 0.0f && f.o > 0.0f;
  const float cut = sqrtf(clamp_min(2.0f * logf(255.0f * f.o), 0.0f));
  const float rect_fx =
      tmin(radius_f, ceilf(cut * sqrtf(clamp_min(f.c00, 0.0f))));
  const float rect_fy =
      tmin(radius_f, ceilf(cut * sqrtf(clamp_min(f.c11, 0.0f))));
  f.radius = f.valid ? (int)radius_f : 0;
  f.rect_rx = f.valid ? (int)rect_fx : 0;
  f.rect_ry = f.valid ? (int)rect_fy : 0;
  f.out[OPACITY] = f.valid ? f.o : 0.0f;

  // colour from SH
  #pragma unroll
  for (int j = 0; j < 3; ++j) f.d[j] = f.p[j] - c[CAM_CENTER + j];
  f.sq = f.d[0] * f.d[0] + f.d[1] * f.d[1] + f.d[2] * f.d[2];
  f.inv_n = 1.0f / sqrtf(clamp_min(f.sq, (float)1e-16));
  #pragma unroll
  for (int j = 0; j < 3; ++j) f.u[j] = f.d[j] * f.inv_n;
  sh_basis<DEG>(f.u[0], f.u[1], f.u[2], f.basis);
  #pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float acc = row[ch] * f.basis[0];
#pragma unroll
    for (int k = 1; k < Slot<DEG>::NK; ++k) acc = acc + row[3 * k + ch] * f.basis[k];
    f.pre[ch] = acc + 0.5f;
    f.out[COL_R + ch] = clamp_min(f.pre[ch], 0.0f);
  }
}

// Copy the active coefficients (k3 floats of each K3) of the block's `rows`
// SH rows from row0 on into shared memory at a row stride of `stride`.
__device__ __forceinline__ void stage_sh(float* dst, const float* sh,
                                         int64_t row0, int rows, int K3, int k3,
                                         int stride) {
  if (k3 == K3) {
    const float* src = sh + row0 * K3;
    const int total = rows * K3;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const int n4 = total >> 2;
      const float4* src4 = reinterpret_cast<const float4*>(src);
      for (int v = threadIdx.x; v < n4; v += BLOCK) {
        const float4 x = __ldg(src4 + v);
        int r = (4 * v) / K3, col = 4 * v - r * K3;
        const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dst[r * stride + col] = e[j];
          if (++col == K3) { col = 0; ++r; }
        }
      }
      done = 4 * n4;
    }
    for (int f = done + threadIdx.x; f < total; f += BLOCK) {
      const int r = f / K3;
      dst[r * stride + f - r * K3] = __ldg(src + f);
    }
  } else {
    for (int f = threadIdx.x; f < rows * k3; f += BLOCK) {
      const int r = f / k3, col = f - r * k3;
      dst[r * stride + col] = __ldg(sh + (row0 + r) * K3 + col);
    }
  }
}

// Store the block's staged SH gradient rows (K3 floats each, at `stride`).
__device__ __forceinline__ void store_sh(float* d_sh, const float* src,
                                         int64_t row0, int rows, int K3,
                                         int stride) {
  float* dst = d_sh + row0 * K3;
  const int total = rows * K3;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n4 = total >> 2;
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int v = threadIdx.x; v < n4; v += BLOCK) {
      int r = (4 * v) / K3, col = 4 * v - r * K3;
      float e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        e[j] = src[r * stride + col];
        if (++col == K3) { col = 0; ++r; }
      }
      dst4[v] = make_float4(e[0], e[1], e[2], e[3]);
    }
    done = 4 * n4;
  }
  for (int f = done + threadIdx.x; f < total; f += BLOCK) {
    const int r = f / K3;
    dst[f] = src[r * stride + f - r * K3];
  }
}

__device__ __forceinline__ void load_camera(const float* cam, float* c) {
  if (threadIdx.x < CAM_SIZE) c[threadIdx.x] = cam[threadIdx.x];
}

template <int DEG>
__global__ void __launch_bounds__(BLOCK)
    project_fwd_kernel(Inputs in, float* out, int* iout) {
  extern __shared__ float sh_rows[];
  __shared__ float c[CAM_SIZE];
  constexpr int k3 = 3 * (DEG + 1) * (DEG + 1);
  const int64_t row0 = (int64_t)blockIdx.x * BLOCK;
  const int rows = in.n - row0 < BLOCK ? (int)(in.n - row0) : BLOCK;
  load_camera(in.cam, c);
  stage_sh(sh_rows, in.sh, row0, rows, 3 * in.K, k3, k3 | 1);
  __syncthreads();
  if ((int)threadIdx.x >= rows) return;
  const int64_t i = row0 + threadIdx.x;
  Slot<DEG> f;
  project_slot<DEG>(in, c, i, sh_rows + threadIdx.x * (k3 | 1), f);
#pragma unroll
  for (int j = 0; j < NFLOAT; ++j) out[j * in.n + i] = f.out[j];
  iout[i] = f.radius;
  iout[in.n + i] = f.rect_rx;
  iout[2 * in.n + i] = f.rect_ry;
}

template <int DEG>
__global__ void __launch_bounds__(BLOCK)
    project_bwd_kernel(Inputs in, Grads gr, Outs o, float* partials) {
  extern __shared__ float sh_rows[];
  __shared__ float c[CAM_SIZE];
  __shared__ float red[WARPS][CAM_SIZE];
  constexpr int NK = (DEG + 1) * (DEG + 1);
  constexpr int k3 = 3 * NK;
  const int K3 = 3 * in.K;
  const int64_t row0 = (int64_t)blockIdx.x * BLOCK;
  const int rows = in.n - row0 < BLOCK ? (int)(in.n - row0) : BLOCK;
  load_camera(in.cam, c);
  stage_sh(sh_rows, in.sh, row0, rows, K3, k3, k3 | 1);
  __syncthreads();

  const bool live = (int)threadIdx.x < rows;
  const int64_t i = row0 + threadIdx.x;
  float dc[CAM_SIZE];
#pragma unroll
  for (int j = 0; j < CAM_SIZE; ++j) dc[j] = 0.0f;
  float g_pre[3] = {0.0f, 0.0f, 0.0f};
  float basis[NK];
  if (live) {
    Slot<DEG> f;
    const float* row = sh_rows + threadIdx.x * (k3 | 1);
    project_slot<DEG>(in, c, i, row, f);
    float g[NFLOAT];
#pragma unroll
    for (int j = 0; j < NFLOAT; ++j) g[j] = gr.g[j] ? gr.g[j][i] : 0.0f;
    const float* r = c + CAM_R;

    // opacity and colour
    const float d_opacity = f.valid ? g[OPACITY] : 0.0f;
    float d_basis[NK];
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      basis[k] = f.basis[k];
      d_basis[k] = 0.0f;
    }
    #pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      g_pre[ch] = f.pre[ch] >= 0.0f ? g[COL_R + ch] : 0.0f;
#pragma unroll
      for (int k = 0; k < NK; ++k) d_basis[k] += row[3 * k + ch] * g_pre[ch];
    }
    float d_dir[3];
    sh_basis_vjp<DEG>(f.u[0], f.u[1], f.u[2], d_basis, d_dir);
    const float g_inv_n = d_dir[0] * f.d[0] + d_dir[1] * f.d[1] + d_dir[2] * f.d[2];
    const float g_sq = f.sq >= (float)1e-16
        ? -0.5f * g_inv_n * f.inv_n * f.inv_n * f.inv_n : 0.0f;
    float d_p[3];
    #pragma unroll
    for (int j = 0; j < 3; ++j) {
      d_p[j] = d_dir[j] * f.inv_n + 2.0f * f.d[j] * g_sq;
      dc[CAM_CENTER + j] = -d_p[j];
    }

    // conic
    float d_c00 = g[CONIC_C] * f.inv_det;
    float d_c01 = -g[CONIC_B] * f.inv_det;
    float d_c11 = g[CONIC_A] * f.inv_det;
    const float g_inv_det =
        g[CONIC_A] * f.c11 - g[CONIC_B] * f.c01 + g[CONIC_C] * f.c00;
    const float d_det = f.det > 0.0f ? -g_inv_det * f.inv_det * f.inv_det : 0.0f;
    d_c00 += d_det * f.c11;
    d_c11 += d_det * f.c00;
    d_c01 -= 2.0f * d_det * f.c01;

    // 2D covariance c = [a; b] Σ [a; b]^T
    float d_a[3], d_b[3];
    #pragma unroll
    for (int k = 0; k < 3; ++k) {
      d_a[k] = 2.0f * d_c00 * f.sa[k] + d_c01 * f.sb[k];
      d_b[k] = d_c01 * f.sa[k] + 2.0f * d_c11 * f.sb[k];
    }
    // Σ's unique entries s00 s01 s02 s11 s12 s22; an off-diagonal one sits
    // twice in Σ
    float d_s[3][3];
    #pragma unroll
    for (int a = 0; a < 3; ++a) {
      d_s[a][a] = d_c00 * f.a[a] * f.a[a] + d_c01 * f.b[a] * f.a[a] +
                  d_c11 * f.b[a] * f.b[a];
      #pragma unroll
      for (int b = a + 1; b < 3; ++b) {
        d_s[a][b] = 2.0f * d_c00 * f.a[a] * f.a[b] +
                    d_c01 * (f.b[a] * f.a[b] + f.b[b] * f.a[a]) +
                    2.0f * d_c11 * f.b[a] * f.b[b];
        d_s[b][a] = d_s[a][b];
      }
    }

    // Jacobian rows a = j00 R0 + j02 R2, b = j11 R1 + j12 R2
    float d_j00 = 0.0f, d_j02 = 0.0f, d_j11 = 0.0f, d_j12 = 0.0f;
    float d_r[9];
    #pragma unroll
    for (int k = 0; k < 3; ++k) {
      d_j00 += d_a[k] * r[k];
      d_j02 += d_a[k] * r[6 + k];
      d_j11 += d_b[k] * r[3 + k];
      d_j12 += d_b[k] * r[6 + k];
      d_r[k] = d_a[k] * f.j00;
      d_r[3 + k] = d_b[k] * f.j11;
      d_r[6 + k] = d_a[k] * f.j02 + d_b[k] * f.j12;
    }
    const float fx = c[CAM_FX], fy = c[CAM_FY];
    dc[CAM_FX] = d_j00 * f.inv_z - d_j02 * f.txz * f.inv_z;
    dc[CAM_FY] = d_j11 * f.inv_z - d_j12 * f.tyz * f.inv_z;
    const float d_txz = -d_j02 * fx * f.inv_z;
    const float d_tyz = -d_j12 * fy * f.inv_z;
    const float d_inv_z =
        d_j00 * fx - d_j02 * fx * f.txz + d_j11 * fy - d_j12 * fy * f.tyz;
    float d_tzc = -d_inv_z * f.inv_z * f.inv_z;

    // the clamps min(max(v, -lim), lim) of x/z and y/z
    const float limx = c[CAM_LIMX], limy = c[CAM_LIMY];
    const float d_mx = d_txz * min_share(f.mx, limx);
    const float d_vx = d_mx * max_share(f.vx, -limx);
    dc[CAM_LIMX] = (d_txz - d_mx) - (d_mx - d_vx);
    const float d_my = d_tyz * min_share(f.my, limy);
    const float d_vy = d_my * max_share(f.vy, -limy);
    dc[CAM_LIMY] = (d_tyz - d_my) - (d_my - d_vy);
    float d_tx = d_vx / f.tzc;
    float d_ty = d_vy / f.tzc;
    d_tzc -= d_vx * f.vx / f.tzc;
    d_tzc -= d_vy * f.vy / f.tzc;

    // pixel centre
    const float d_px = g[X2D] * 0.5f * (float)in.width;
    const float d_py = g[Y2D] * 0.5f * (float)in.height;
    const float d_clip_x = d_px / f.w_clip;
    const float d_clip_y = d_py / f.w_clip;
    const float d_w =
        -(d_px * f.clip_x + d_py * f.clip_y) / (f.w_clip * f.w_clip);
    dc[CAM_P00] = d_clip_x * f.tx;
    dc[CAM_P11] = d_clip_y * f.ty;
    d_tx += d_clip_x * c[CAM_P00];
    d_ty += d_clip_y * c[CAM_P11];
    const float d_tz = d_w;

    // pupil shift, depth clamp
    float d_depth = g[DEPTH] + d_tz;
    float d_clamp = d_tzc;
    if (in.has_shift) {
      dc[CAM_SHIFT] = d_tx * f.inv_d;
      dc[CAM_SHIFT + 1] = d_ty * f.inv_d;
      dc[CAM_SHIFT + 2] = d_tz * f.inv_d;
      const float d_inv_d = d_tx * c[CAM_SHIFT] + d_ty * c[CAM_SHIFT + 1] +
                            d_tz * c[CAM_SHIFT + 2];
      d_clamp -= d_inv_d * f.inv_d * f.inv_d;
    }
    if (f.depth >= (float)1e-6) d_depth += d_clamp;

    // view space t = R p + t_w2c
    const float d_view[3] = {d_tx, d_ty, d_depth};
    #pragma unroll
    for (int a = 0; a < 3; ++a) {
      dc[CAM_T + a] = d_view[a];
      #pragma unroll
      for (int k = 0; k < 3; ++k) {
        d_r[3 * a + k] += d_view[a] * f.p[k];
        d_p[k] += d_view[a] * r[3 * a + k];
      }
    }
    #pragma unroll
    for (int j = 0; j < 9; ++j) dc[CAM_R + j] = d_r[j];

    // 3D covariance Σ = M M^T, M = Q diag(s)
    float d_m[3][3], dq[3][3], d_sc[3] = {0.0f, 0.0f, 0.0f};
    #pragma unroll
    for (int a = 0; a < 3; ++a) {
      #pragma unroll
      for (int k = 0; k < 3; ++k) {
        float v = 2.0f * d_s[a][a] * f.m[a][k];
        #pragma unroll
        for (int b = 0; b < 3; ++b)
          if (b != a) v += d_s[a][b] * f.m[b][k];
        d_m[a][k] = v;
        dq[a][k] = v * f.sc[k];
        d_sc[k] += v * f.qr[a][k];
      }
    }
    const float w = f.qn[0], x = f.qn[1], y = f.qn[2], z = f.qn[3];
    float d_qn[4];
    d_qn[0] = 2.0f * (-dq[0][1] * z + dq[0][2] * y + dq[1][0] * z -
                      dq[1][2] * x - dq[2][0] * y + dq[2][1] * x);
    d_qn[1] = 2.0f * (dq[0][1] * y + dq[0][2] * z + dq[1][0] * y -
                      2.0f * dq[1][1] * x - dq[1][2] * w + dq[2][0] * z +
                      dq[2][1] * w - 2.0f * dq[2][2] * x);
    d_qn[2] = 2.0f * (-2.0f * dq[0][0] * y + dq[0][1] * x + dq[0][2] * w +
                      dq[1][0] * x + dq[1][2] * z - dq[2][0] * w +
                      dq[2][1] * z - 2.0f * dq[2][2] * y);
    d_qn[3] = 2.0f * (-2.0f * dq[0][0] * z - dq[0][1] * w + dq[0][2] * x +
                      dq[1][0] * w - 2.0f * dq[1][1] * z + dq[1][2] * y +
                      dq[2][0] * x + dq[2][1] * y);
    // q / clamp(|q|, 1e-8)
    float d_nc = 0.0f;
    #pragma unroll
    for (int j = 0; j < 4; ++j) d_nc += d_qn[j] * f.q[j];
    d_nc = -d_nc / (f.nc * f.nc);
    const float d_norm =
        (f.norm >= (float)1e-8 && f.norm != 0.0f) ? d_nc / f.norm : 0.0f;
    float d_q[4];
    #pragma unroll
    for (int j = 0; j < 4; ++j) d_q[j] = d_qn[j] / f.nc + d_norm * f.q[j];

    if (o.d_xyz)
      #pragma unroll
      for (int j = 0; j < 3; ++j) o.d_xyz[3 * i + j] = d_p[j];
    if (o.d_scales)
      #pragma unroll
      for (int j = 0; j < 3; ++j) o.d_scales[3 * i + j] = d_sc[j];
    if (o.d_quats)
      reinterpret_cast<float4*>(o.d_quats)[i] =
          make_float4(d_q[0], d_q[1], d_q[2], d_q[3]);
    if (o.d_opacity) o.d_opacity[i] = d_opacity;
  }

  // SH gradients: each live row (coefficients above the active degree 0)
  // through shared memory, then 16-byte stores
  if (o.d_sh) {
    const int stride = K3 | 1;
    __syncthreads();  // every thread has read its coefficients
    if (live) {
      float* dst = sh_rows + threadIdx.x * stride;
#pragma unroll
      for (int k = 0; k < NK; ++k)
        #pragma unroll
        for (int ch = 0; ch < 3; ++ch) dst[3 * k + ch] = basis[k] * g_pre[ch];
      for (int f = k3; f < K3; ++f) dst[f] = 0.0f;
    }
    __syncthreads();
    store_sh(o.d_sh, sh_rows, row0, rows, K3, stride);
  }

  // the camera terms: over the warp by shuffles, then over the warps in a
  // fixed order into this block's row of partials
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < CAM_SIZE; ++j) {
    float v = dc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][j] = v;
  }
  __syncthreads();
  if (threadIdx.x < CAM_SIZE) {
    float v = red[0][threadIdx.x];
    #pragma unroll
    for (int w = 1; w < WARPS; ++w) v += red[w][threadIdx.x];
    partials[(int64_t)blockIdx.x * CAM_SIZE + threadIdx.x] = v;
  }
}

// d_cam[j] = the sum of column j of the (blocks, 24) partials, in double,
// in a fixed order: one block a column.
__global__ void __launch_bounds__(REDUCE_THREADS)
    project_cam_reduce_kernel(const float* partials, int64_t blocks,
                              float* d_cam) {
  __shared__ double red[REDUCE_THREADS];
  const int j = blockIdx.x;
  double v = 0.0;
  for (int64_t b = threadIdx.x; b < blocks; b += REDUCE_THREADS)
    v += (double)partials[b * CAM_SIZE + j];
  red[threadIdx.x] = v;
  __syncthreads();
  for (int w = REDUCE_THREADS / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) d_cam[j] = (float)red[0];
}

size_t smem_bytes(int deg, int K) {
  const int k3 = 3 * (deg + 1) * (deg + 1), K3 = 3 * K;
  return sizeof(float) * BLOCK * (size_t)((K3 > k3 ? K3 : k3) | 1);
}

Inputs make_inputs(const void* xyz, const void* scales, const void* quats,
                   const void* opacity, const void* sh, int K, const void* cam,
                   int has_shift, int width, int height, int64_t n) {
  return Inputs{(const float*)xyz, (const float*)scales, (const float*)quats,
                (const float*)opacity, (const float*)sh, (const float*)cam,
                K, has_shift, width, height, n};
}

template <int DEG>
void fwd(const Inputs& in, float* out, int* iout, cudaStream_t stream) {
  const unsigned grid = (unsigned)((in.n + BLOCK - 1) / BLOCK);
  project_fwd_kernel<DEG><<<grid, BLOCK, smem_bytes(DEG, in.K), stream>>>(
      in, out, iout);
}

template <int DEG>
void bwd(const Inputs& in, const Grads& g, const Outs& o, float* partials,
         cudaStream_t stream) {
  const unsigned grid = (unsigned)((in.n + BLOCK - 1) / BLOCK);
  project_bwd_kernel<DEG><<<grid, BLOCK, smem_bytes(DEG, in.K), stream>>>(
      in, g, o, partials);
}

bool bad_args(int deg, int K, int64_t n) {
  return deg < 0 || deg > 4 || K < (deg + 1) * (deg + 1) || K > MAX_K || n < 0;
}

}  // namespace

extern "C" int project_fwd_launch(int deg, const void* xyz, const void* scales,
                                  const void* quats, const void* opacity,
                                  const void* sh, int K, const void* cam,
                                  int has_shift, int width, int height,
                                  int64_t n, void* out, void* iout,
                                  void* stream) {
  if (bad_args(deg, K, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const Inputs in = make_inputs(xyz, scales, quats, opacity, sh, K, cam,
                                has_shift, width, height, n);
  cudaStream_t s = (cudaStream_t)stream;
  float* o = (float*)out;
  int* io = (int*)iout;
  switch (deg) {
    case 0: fwd<0>(in, o, io, s); break;
    case 1: fwd<1>(in, o, io, s); break;
    case 2: fwd<2>(in, o, io, s); break;
    case 3: fwd<3>(in, o, io, s); break;
    default: fwd<4>(in, o, io, s); break;
  }
  return (int)cudaGetLastError();
}

// The backward kernel, then the reduction of its camera partials (a
// (partial_rows, 24) buffer; partial_rows >= the kernel's blocks) into
// d_cam (24,). Null gradient pointers are absent gradients; null output
// pointers are not written.
extern "C" int project_bwd_launch(
    int deg, const void* xyz, const void* scales, const void* quats,
    const void* opacity, const void* sh, int K, const void* cam, int has_shift,
    int width, int height, int64_t n, const void* g0, const void* g1,
    const void* g2, const void* g3, const void* g4, const void* g5,
    const void* g6, const void* g7, const void* g8, const void* g9,
    void* d_xyz, void* d_scales, void* d_quats, void* d_opacity, void* d_sh,
    void* partials, int64_t partial_rows, void* d_cam, void* stream) {
  if (bad_args(deg, K, n)) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + BLOCK - 1) / BLOCK;
  if (partial_rows < blocks) return (int)cudaErrorInvalidValue;
  const Inputs in = make_inputs(xyz, scales, quats, opacity, sh, K, cam,
                                has_shift, width, height, n);
  const Grads g{{(const float*)g0, (const float*)g1, (const float*)g2,
                 (const float*)g3, (const float*)g4, (const float*)g5,
                 (const float*)g6, (const float*)g7, (const float*)g8,
                 (const float*)g9}};
  const Outs o{(float*)d_xyz, (float*)d_scales, (float*)d_quats,
               (float*)d_opacity, (float*)d_sh};
  cudaStream_t s = (cudaStream_t)stream;
  float* p = (float*)partials;
  if (n > 0) {
    switch (deg) {
      case 0: bwd<0>(in, g, o, p, s); break;
      case 1: bwd<1>(in, g, o, p, s); break;
      case 2: bwd<2>(in, g, o, p, s); break;
      case 3: bwd<3>(in, g, o, p, s); break;
      default: bwd<4>(in, g, o, p, s); break;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  project_cam_reduce_kernel<<<CAM_SIZE, REDUCE_THREADS, 0, s>>>(p, blocks,
                                                               (float*)d_cam);
  return (int)cudaGetLastError();
}

// The resources of the forward (which 0) or backward (1) kernel at SH
// degree `deg` with K coefficients a row: out[0] resident blocks per SM,
// out[1] registers per thread, out[2] shared memory per block (static and
// dynamic, bytes), out[3] local memory per thread (bytes; spills).
extern "C" int project_info(int which, int deg, int K, int* out) {
  if (bad_args(deg, K, 0)) return (int)cudaErrorInvalidValue;
  const void* kernels[2][5] = {
      {(const void*)project_fwd_kernel<0>, (const void*)project_fwd_kernel<1>,
       (const void*)project_fwd_kernel<2>, (const void*)project_fwd_kernel<3>,
       (const void*)project_fwd_kernel<4>},
      {(const void*)project_bwd_kernel<0>, (const void*)project_bwd_kernel<1>,
       (const void*)project_bwd_kernel<2>, (const void*)project_bwd_kernel<3>,
       (const void*)project_bwd_kernel<4>}};
  const void* kernel = kernels[which ? 1 : 0][deg];
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t dyn = smem_bytes(deg, K);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, BLOCK,
                                                      dyn);
  out[1] = attr.numRegs;
  out[2] = (int)(attr.sharedSizeBytes + dyn);
  out[3] = (int)attr.localSizeBytes;
  return (int)err;
}

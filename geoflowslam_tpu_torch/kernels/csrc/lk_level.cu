// One pyramid level of Lucas-Kanade optical flow for N points, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel geoflowslam_tpu/ops/pallas_kernels.py::
// _lk_level_kernel (entry lk_level_pallas). It is held against the XLA
// formulation geoflowslam_tpu/ops/klt.py::_track_level, whose port is the
// plain version beside it: geoflowslam_tpu_torch/ops/klt.py::_track_level.
// The Pallas kernel's one-hot band matmuls and its residual-shift clamp at
// win >= 23 are TPU workarounds and are not carried over.
//
// Per point: a bilinear (win+2)^2 template around pts (from a (win+3)^2 block
// of the edge-padded previous level), central-difference gradients of its
// inner win^2, the structure tensor and its minimum-eigenvalue gate, then
// `iters` Gauss-Newton steps, each resampling a bilinear win^2 patch of the
// next level at the current estimate; finally (x, y, ok, mean |residual|).
//
// What bounds it on the card: 1256 points x 10 iterations x 441 samples at
// the main path's shapes, four texel reads and ~20 flops each: a few tens of
// millions of L1/L2 hits and no HBM pressure (a 480x640 float level is
// 1.2 MB and stays in L2). One warp owns one point: its (win+2)^2 template
// sits in shared memory (the template and both gradients are read from it at
// every step, so no gradient plane is stored), each lane takes every 32nd
// sample of the window, and the five per-point sums (structure tensor, the
// two GN right-hand sides, |residual|) are butterfly shuffle reductions. All
// iterations stay in the kernel, so a level is one launch. Next-level texels
// are read through the read-only cache.
//
// Semantics kept from the reference:
// * Block starts are placed as jax.lax.dynamic_slice places them, not
//   padded: a negative start counts from the end of the axis (once), then
//   the start is clamped into [0, padded_dim - side]. A point near or past
//   the border thus reads a shifted block of the edge-padded image, and one
//   left of or above it a block from the opposite side. Texel (y, x) of the
//   padded image is image (clamp(y - pad), clamp(x - pad)).
// * floor(g) is clamped to +-2^20 (NaN to 0) before the int cast; any value
//   beyond the padded image gives the same clamped block start, and the
//   cast is never out of range.
// * Elementwise arithmetic uses explicit round-to-nearest intrinsics in the
//   plain version's operation order (no FMA contraction), so each sample,
//   template value and gradient equals the plain version's bit for bit; only
//   the order of the per-point sums differs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsMax = 4;            // points per block
constexpr float kIndexBound = 1048576.f;  // 2^20
constexpr int kSmemMax = 232448;        // dynamic shared memory per block

// Shared memory a block of `warps` points needs at window `win`.
int smem_bytes(int win, int warps) {
  return warps * (win + 2) * (win + 2) * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ int floor_index(float v) {
  float f = floorf(v);
  if (f != f) f = 0.f;
  f = fminf(fmaxf(f, -kIndexBound), kIndexBound);
  return static_cast<int>(f);
}

__device__ __forceinline__ float texel(const float* __restrict__ img, int h,
                                       int w, int y, int x) {
  y = min(max(y, 0), h - 1);
  x = min(max(x, 0), w - 1);
  return __ldg(img + y * w + x);
}

// Bilinear sample with top-left texel (y, x) of the unpadded image and the
// four weights; the plain version's ((w00 p00 + w01 p01) + w10 p10) + w11 p11.
__device__ __forceinline__ float blend(const float* __restrict__ img, int h,
                                       int w, int y, int x, float w00,
                                       float w01, float w10, float w11) {
  const float a = __fmul_rn(w00, texel(img, h, w, y, x));
  const float b = __fmul_rn(w01, texel(img, h, w, y, x + 1));
  const float c = __fmul_rn(w10, texel(img, h, w, y + 1, x));
  const float d = __fmul_rn(w11, texel(img, h, w, y + 1, x + 1));
  return __fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Start (in unpadded image coordinates) of the block of `side` texels whose
// padded-image start is base + offset, placed as dynamic_slice places it.
__device__ __forceinline__ int block_start(int base, int offset, int pad,
                                           int padded_dim, int side) {
  int s = base + offset + pad;
  if (s < 0) s += padded_dim;
  s = min(max(s, 0), padded_dim - side);
  return s - pad;
}

struct Weights {
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Weights weights(float fx, float fy) {
  const float gx = __fsub_rn(1.f, fx);
  const float gy = __fsub_rn(1.f, fy);
  return {__fmul_rn(gx, gy), __fmul_rn(fx, gy), __fmul_rn(gx, fy),
          __fmul_rn(fx, fy)};
}

__global__ void lk_level_kernel(const float* __restrict__ prev,
                                const float* __restrict__ next, int h, int w,
                                const float* __restrict__ pts,
                                const float* __restrict__ guess, int n,
                                int win, int iters, float min_eig,
                                float* __restrict__ out_pts,
                                uint8_t* __restrict__ out_ok,
                                float* __restrict__ out_err) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (blockDim.x >> 5) + warp;
  if (i >= n) return;  // the whole warp leaves together; no block barrier

  const int r = win / 2;
  const int pad = r + 2;
  const int hp = h + 2 * pad;
  const int wp = w + 2 * pad;
  const int side = win + 2;  // template side: offsets -(r+1) .. -(r+1)+win+1
  const int nt = side * side;
  const int nw = win * win;
  float* tm = smem + warp * nt;

  // ---- template: bilinear (win+2)^2 samples around pts -------------------
  const float px = pts[2 * i];
  const float py = pts[2 * i + 1];
  const float pfx = __fsub_rn(px, floorf(px));
  const float pfy = __fsub_rn(py, floorf(py));
  const Weights wt = weights(pfx, pfy);
  const int ty = block_start(floor_index(py), -(r + 1), pad, hp, win + 3);
  const int tx = block_start(floor_index(px), -(r + 1), pad, wp, win + 3);
  for (int k = lane; k < nt; k += 32) {
    const int a = k / side, b = k - (k / side) * side;
    tm[k] = blend(prev, h, w, ty + a, tx + b, wt.w00, wt.w01, wt.w10, wt.w11);
  }
  __syncwarp();

  // ---- structure tensor over the inner win^2 ------------------------------
  float gxx = 0.f, gxy = 0.f, gyy = 0.f;
  for (int k = lane; k < nw; k += 32) {
    const int a = k / win, b = k - (k / win) * win;
    const float* row = tm + (a + 1) * side + (b + 1);
    const float ix = __fmul_rn(0.5f, __fsub_rn(row[1], row[-1]));
    const float iy = __fmul_rn(0.5f, __fsub_rn(row[side], row[-side]));
    gxx = __fadd_rn(gxx, __fmul_rn(ix, ix));
    gxy = __fadd_rn(gxy, __fmul_rn(ix, iy));
    gyy = __fadd_rn(gyy, __fmul_rn(iy, iy));
  }
  gxx = warp_sum(gxx);
  gxy = warp_sum(gxy);
  gyy = warp_sum(gyy);
  const float det = __fsub_rn(__fmul_rn(gxx, gyy), __fmul_rn(gxy, gxy));
  const float tr = __fadd_rn(gxx, gyy);
  const float disc = fmaxf(__fsub_rn(__fmul_rn(tr, tr), __fmul_rn(4.f, det)),
                           0.f);
  const float eig_min = __fmul_rn(0.5f, __fsub_rn(tr, __fsqrt_rn(disc)));
  const bool good = __fdiv_rn(eig_min, static_cast<float>(nw)) > min_eig;
  const float det_safe = fabsf(det) < 1e-9f ? 1e-9f : det;

  // ---- Gauss-Newton on the next level -------------------------------------
  float gx = guess[2 * i];
  float gy = guess[2 * i + 1];
  float abs_sum = 0.f;
  for (int it = 0; it <= iters; ++it) {
    const float fx = __fsub_rn(gx, floorf(gx));
    const float fy = __fsub_rn(gy, floorf(gy));
    const Weights wc = weights(fx, fy);
    const int cy = block_start(floor_index(gy), -r, pad, hp, win + 1);
    const int cx = block_start(floor_index(gx), -r, pad, wp, win + 1);
    float bx = 0.f, by = 0.f;
    abs_sum = 0.f;
    for (int k = lane; k < nw; k += 32) {
      const int a = k / win, b = k - (k / win) * win;
      const float* row = tm + (a + 1) * side + (b + 1);
      const float di = __fsub_rn(
          blend(next, h, w, cy + a, cx + b, wc.w00, wc.w01, wc.w10, wc.w11),
          row[0]);
      if (it == iters) {  // the last pass only measures the residual
        abs_sum = __fadd_rn(abs_sum, fabsf(di));
        continue;
      }
      const float ix = __fmul_rn(0.5f, __fsub_rn(row[1], row[-1]));
      const float iy = __fmul_rn(0.5f, __fsub_rn(row[side], row[-side]));
      bx = __fadd_rn(bx, __fmul_rn(di, ix));
      by = __fadd_rn(by, __fmul_rn(di, iy));
    }
    if (it == iters) break;
    bx = warp_sum(bx);
    by = warp_sum(by);
    const float sx = __fdiv_rn(
        -__fsub_rn(__fmul_rn(gyy, bx), __fmul_rn(gxy, by)), det_safe);
    const float sy = __fdiv_rn(
        -__fadd_rn(__fmul_rn(-gxy, bx), __fmul_rn(gxx, by)), det_safe);
    if (good) {
      gx = __fadd_rn(gx, sx);
      gy = __fadd_rn(gy, sy);
    }
  }
  abs_sum = warp_sum(abs_sum);

  if (lane == 0) {
    const bool inb = gx >= 0.f && gx <= static_cast<float>(w - 1) &&
                     gy >= 0.f && gy <= static_cast<float>(h - 1);
    out_pts[2 * i] = gx;
    out_pts[2 * i + 1] = gy;
    out_ok[i] = (good && inb) ? 1 : 0;
    out_err[i] = __fdiv_rn(abs_sum, static_cast<float>(nw));
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success),
// cudaErrorInvalidValue for a window whose template does not fit in shared
// memory or a non-positive window.
extern "C" int gfs_lk_level(const float* prev, const float* next, int h,
                            int w, const float* pts, const float* guess, int n,
                            int win, int iters, float min_eig, float* out_pts,
                            uint8_t* out_ok, float* out_err,
                            cudaStream_t stream) {
  if (win < 1 || iters < 0 || h < 1 || w < 1) return cudaErrorInvalidValue;
  if (n <= 0) return 0;
  int warps = kWarpsMax;
  while (warps > 1 && smem_bytes(win, warps) > 48 * 1024) --warps;
  const int smem = smem_bytes(win, warps);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lk_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 block(32 * warps);
  const dim3 grid((n + warps - 1) / warps);
  lk_level_kernel<<<grid, block, smem, stream>>>(prev, next, h, w, pts, guess,
                                                 n, win, iters, min_eig,
                                                 out_pts, out_ok, out_err);
  return static_cast<int>(cudaGetLastError());
}
